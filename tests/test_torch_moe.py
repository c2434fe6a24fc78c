"""The port's MoE layer against the JAX reference.

Weights come from the reference's ``moe_init`` and are copied into the
port's ``MoE`` module; activations are numpy draws from a seed.  The port
runs its only branch, the three grouped GEMMs (their plain versions on the
CPU), against both of the reference's branches, at the reference's own
tolerance between them (tests/test_moe.py: rtol 2e-4, atol 2e-5).  Routing
takes ``top_k`` of softmax probabilities on both sides: ``jax.lax.top_k``
and ``torch.topk`` both sort descending, and with random weights no two
probabilities of a token tie, so both pick the same experts in the same
slot order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import Init  # noqa: E402

ARCH = "qwen2-moe-a2.7b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def layer():
    """The reduced config on both sides, the reference's weights and the
    port's MoE module holding copies of them."""
    cfg, jcfg = reduced(get_config(ARCH)), jreduced(jget_config(ARCH))
    assert cfg.n_experts == jcfg.n_experts == 4 and cfg.top_k == 2
    jp = jmoe.moe_init(jax.random.PRNGKey(0), jcfg, jnp.float32)
    mod = moe.MoE(cfg, Init(None, torch.device("cpu")), torch.float32)
    with torch.no_grad():
        for name, p in mod.named_parameters():
            leaf = jp
            for key in name.split("."):
                leaf = leaf[key]
            p.copy_(torch.from_numpy(np.array(leaf)))
    n_leaves = len(jax.tree_util.tree_leaves(jp))
    assert n_leaves == len(list(mod.parameters()))
    return cfg, jcfg, jp, mod


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["reference_einsum", "reference_pallas"])
@pytest.mark.parametrize("capacity_factor,shape",
                         [(1.25, (2, 16)), (0.05, (4, 128))],
                         ids=["full", "drops"])
def test_moe_ffn_matches_jax(layer, use_pallas, capacity_factor, shape):
    cfg, jcfg, jp, mod = layer
    x = (0.3 * np.random.default_rng(1).standard_normal(
        shape + (cfg.d_model,))).astype(np.float32)
    got = moe.moe_ffn(mod, torch.from_numpy(x), cfg,
                      capacity_factor=capacity_factor)
    want = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg,
                        capacity_factor=capacity_factor,
                        use_pallas=use_pallas)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)


def test_dispatch_positions_match_jax_with_drops(layer):
    """The (expert, position) of every routed pair, and which pairs the
    capacity drops, equal the reference's: slot 0 of every token before
    slot 1, running counts across slots."""
    cfg = layer[0]
    t, k, e = 512, cfg.top_k, cfg.n_experts
    top_idx = np.random.default_rng(2).integers(0, e, (t, k)).astype(np.int32)
    for capacity in (moe.expert_capacity(t, cfg, 0.05), 5):
        pos, keep = moe._dispatch_indices(torch.from_numpy(top_idx), e,
                                          capacity)
        jpos, jkeep = jmoe._dispatch_indices(jnp.asarray(top_idx), e,
                                             capacity)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
        assert 0 < int(keep.sum()) < t * k          # some pairs dropped
    assert moe.expert_capacity(t, cfg, 0.05) == 128


def test_capacity_helpers_match_jax():
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    for tokens in (1, 8, 1024, 65_536, 1_048_576):
        c = moe.expert_capacity(tokens, cfg)
        assert c == jmoe.expert_capacity(tokens, jcfg)
        assert moe.capacity_chunks(c) == jmoe.capacity_chunks(c)
    assert moe.expert_capacity(8, cfg) == 128
