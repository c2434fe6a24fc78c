"""Training's forward, loss and gradients against the JAX reference:
``forward`` logits, ``loss_fn`` and every gradient
leaf of ``jax.value_and_grad(repro.models.model.loss_fn)`` on the same
weights and batch (vision and frames included); ``chunked_xent`` down both
of its branches; remat on and off bit-equal; ``decode_step``
teacher-forced against ``forward``; ``aux_load_balance_loss``;
``shape_applicable``.  This file holds the dense, moe and audio
architectures (``ARCHS_HERE``); ``test_torch_train_families.py`` runs the
same checks on the vlm, ssm and hybrid ones, with this file's helpers (the
reference's compiles are the slow part, so the ten are split in two).

Both sides build the same reduced configs in fp32 on the CPU.  The
reference's init leaves biases, gates, norms, ``D``, ``dt_bias`` and the
gate biases at 0 or 1, which would hide a dropped term, so the numpy
weights are perturbed (``test_torch_families.perturb``, then
``test_torch_ssm.perturb``) before both sides take them.  Batches are
numpy draws from a seed, at S 32: two chunks of the reduced ssm and
hybrid configs' 16.  One jitted reference ``value_and_grad`` per
architecture is shared through a module-level cache.

Tolerances: the loss within rtol 1e-5; logits and each gradient leaf
within atol 1e-5 x max|leaf| + rtol 1e-4.  xlstm-125m alone is held 10x
wider (atol 1e-4 x max, rtol 1e-3): its mLSTM divides by max(|q.n|,
e^-m), sums with cancellation, and with the input-gate biases drawn up
to 6 its hidden states already differ from the reference's by 1.5e-5 of
max|h| in the forward (fp32 on both sides), which the backward carries
into every leaf at a few times 1e-4 x max.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.configs import shape_applicable as jshape_applicable  # noqa: E402
from repro.configs.base import ALL_SHAPES as JSHAPES  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch.configs import ALL_SHAPES, ARCHS  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs import shape_applicable  # noqa: E402
from repro_torch.models import convert, model, moe  # noqa: E402

from test_torch_families import perturb as perturb_attention  # noqa: E402
from test_torch_ssm import perturb as perturb_mixers  # noqa: E402

B, S = 2, 32
WIDE = {"xlstm-125m": 10.0}     # see the module docstring
OTHER_FILE = ("llama-3.2-vision-90b", "xlstm-125m", "zamba2-2.7b")
ARCHS_HERE = sorted(set(JARCHS) - set(OTHER_FILE))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def perturb(tree, rng):
    return perturb_mixers(perturb_attention(tree, rng), rng)


def np_batch(cfg, s=S, seed=3, scale=1.0):
    """tokens and labels int32 (B, s), and the family's vision or frames
    (fp32, ``scale`` x N(0, 1)), as numpy."""
    rng = np.random.default_rng(seed)
    nb = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32),
          "labels": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)}
    if cfg.family == "vlm":
        nb["vision"] = scale * rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        nb["frames"] = scale * rng.standard_normal(
            (B, s * cfg.encoder_seq_ratio, cfg.d_model)).astype(np.float32)
    return nb


def torch_batch(nb):
    return {k: torch.from_numpy(v) for k, v in nb.items()}


_REF = {}


def reference(arch):
    """(port cfg, numpy params, numpy batch, the reference's loss, logits
    and gradient tree), computed once per architecture."""
    if arch not in _REF:
        cfg, jcfg = reduced(get_config(arch)), jreduced(jget_config(arch))
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        np_params = perturb(jax.tree_util.tree_map(np.asarray, jp),
                            np.random.default_rng(11))
        nb = np_batch(cfg)

        def loss_and_logits(p, b):
            # at S <= 512 loss_fn is the whole-logits branch of
            # chunked_xent: softmax_xent of forward's logits, op for op
            logits = jmodel.forward(jcfg, p, b)
            return jcommon.softmax_xent(logits, b["labels"]), logits
        f = jax.jit(jax.value_and_grad(loss_and_logits, has_aux=True))
        (loss, logits), grads = f(
            jax.tree_util.tree_map(jnp.asarray, np_params),
            {k: jnp.asarray(v) for k, v in nb.items()})
        _REF[arch] = (cfg, np_params, nb, float(loss), np.asarray(logits),
                      jax.tree_util.tree_map(np.asarray, grads))
    return _REF[arch]


def trainable(cfg, np_params):
    return convert.params_from_reference(np_params, cfg,
                                         device="cpu").requires_grad_(True)


def loss_and_grads(m, batch):
    """(loss, {parameter name: gradient}) of the port's ``loss_fn``."""
    names, leaves = zip(*m.named_parameters())
    loss = model.loss_fn(m, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss, dict(zip(names, grads))


def assert_leaf_close(got, want, widen, msg):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=1e-4 * widen,
        atol=1e-5 * widen * float(np.abs(want).max()), err_msg=msg)


def leaves(tree):
    return {jax.tree_util.keystr(path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# forward, loss and every gradient leaf
# ---------------------------------------------------------------------------

def check_loss_logits_and_grads(arch):
    cfg, np_params, nb, jloss, jlogits, jgrads = reference(arch)
    widen = WIDE.get(arch, 1.0)
    m = trainable(cfg, np_params)
    batch = torch_batch(nb)
    loss, grads = loss_and_grads(m, batch)
    np.testing.assert_allclose(float(loss.detach()), jloss, rtol=1e-5)
    with torch.no_grad():
        logits = model.forward(m, batch)
    assert logits.shape == (B, S, cfg.vocab_size)
    assert_leaf_close(logits.numpy(), jlogits, widen, f"{arch}: logits")
    got, want = leaves(convert.params_to_reference(m, grads)), leaves(jgrads)
    assert sorted(got) == sorted(want)
    for name in sorted(want):
        assert got[name].shape == want[name].shape, name
        assert np.isfinite(got[name]).all(), name
        assert_leaf_close(got[name], want[name], widen, f"{arch}: {name}")
    # every weight gets a gradient, none a zero one but the enc-dec
    # decoder's unused cross-attention gate (zero on both sides)
    zero = {n for n, g in grads.items() if not g.any()}
    assert zero <= {f"decoder.{i}.xattn.gate" for i in range(cfg.n_layers)}


def check_remat_bit_equal(arch):
    """``cfg.remat`` recomputes each layer (each group) in the backward:
    the loss and every gradient equal the run without it in every bit."""
    cfg, np_params, nb, *_ = reference(arch)
    batch = torch_batch(nb)
    runs = []
    for remat in (False, True):
        m = trainable(cfg.replace(remat=remat), np_params)
        runs.append(loss_and_grads(m, batch))
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    assert sorted(g0) == sorted(g1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name


def check_decode_matches_forward(arch):
    """``decode_step`` over the sequence, token by token, reproduces the
    forward's logits (the reference's own check and tolerance,
    ``tests/test_models.py:66``)."""
    cfg, np_params, *_ = reference(arch)
    m = convert.params_from_reference(np_params, cfg, device="cpu")
    nb = np_batch(cfg, s=8, scale=0.1)
    batch = torch_batch(nb)
    with torch.no_grad():
        full = model.forward(m, batch)
        cache = model.init_cache(m, B, 8, batch)
        for t in range(8):
            lg, cache = model.decode_step(m, cache,
                                          batch["tokens"][:, t:t + 1].long())
            np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                       atol=2e-4, rtol=2e-3)


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_loss_logits_and_every_gradient_match_the_reference(arch):
    check_loss_logits_and_grads(arch)


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_remat_on_and_off_bit_equal(arch):
    check_remat_bit_equal(arch)


@pytest.mark.parametrize("arch", ARCHS_HERE)
def test_decode_teacher_forced_matches_forward(arch):
    check_decode_matches_forward(arch)


# ---------------------------------------------------------------------------
# the loss's two branches, the aux loss, the shape cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1024, 96])
def test_chunked_xent_both_branches(s):
    """S 1024 runs two 512-position chunks (each rematerialised), S 96 the
    whole logits: the value and the gradients of the hidden states and
    the embedding against the reference's ``chunked_xent``, and the
    chunked value against the whole one."""
    cfg, np_params, *_ = reference("granite-8b")
    jcfg = jreduced(jget_config("granite-8b"))
    rng = np.random.default_rng(s)
    hidden = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    jembed = {k: jnp.asarray(v) for k, v in np_params["embed"].items()}
    jloss, (jg_h, jg_e) = jax.value_and_grad(
        lambda h, e: jmodel.chunked_xent(e, h, jnp.asarray(labels), jcfg),
        argnums=(0, 1))(jnp.asarray(hidden), jembed)
    m = trainable(cfg, np_params)
    h = torch.from_numpy(hidden).requires_grad_(True)
    loss = model.chunked_xent(m, h, torch.from_numpy(labels))
    g_h, g_e = torch.autograd.grad(loss, (h, m.emb))
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    assert_leaf_close(g_h.numpy(), jg_h, 1.0, "hidden")
    assert_leaf_close(g_e.numpy(), jg_e["emb"], 1.0, "emb")
    with torch.no_grad():
        whole = model.chunked_xent(m, h, torch.from_numpy(labels),
                                   chunk=2 * s)
    np.testing.assert_allclose(float(loss.detach()), float(whole), rtol=1e-6)


def test_aux_load_balance_loss_matches_the_reference():
    rng = np.random.default_rng(5)
    for t, e, k in ((64, 4, 2), (96, 60, 4)):
        logits = rng.standard_normal((t, e)).astype(np.float32)
        top = np.argsort(-logits, axis=1)[:, :k].astype(np.int32)
        want = jmoe.aux_load_balance_loss(jnp.asarray(logits),
                                          jnp.asarray(top), e)
        got = moe.aux_load_balance_loss(torch.from_numpy(logits),
                                        torch.from_numpy(top), e)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_shape_applicable_matches_the_reference():
    assert [dataclasses.asdict(s) for s in ALL_SHAPES] == \
        [dataclasses.asdict(s) for s in JSHAPES]
    for arch in sorted(ARCHS):
        for shape, jshape in zip(ALL_SHAPES, JSHAPES):
            assert shape_applicable(get_config(arch), shape) == \
                jshape_applicable(jget_config(arch), jshape), (arch, shape)
