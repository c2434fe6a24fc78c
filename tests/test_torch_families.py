"""The six attention-stack architectures the port serves beside granite-8b
and qwen2-moe-a2.7b, against the JAX reference: configs, weights carried
across and back, and ``decode_step`` over ragged steps; the new building
blocks (LayerNorm, the GELU MLP, the full-sequence attention); the rolling
window of h2o-danube; llama-vision's cross attention.

Both sides build the same reduced configs (``reduced()`` is copied
exactly).  The reference's ``init_params`` leaves every bias and
cross-attention gate at 0 and every norm weight at 1, which would hide a
missing bias, norm or gated cross attention, so ``pair`` replaces those
leaves of the numpy params with seeded random values before both sides
take them.  Caches, memories and tokens are numpy draws from a seed.  fp32
on the CPU, where the port runs its kernels' plain versions.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import model as jmodel  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import common, convert  # noqa: E402
from repro_torch.models import model  # noqa: E402

ARCHS = ["dbrx-132b", "qwen1.5-32b", "h2o-danube-1.8b", "starcoder2-15b",
         "llama-3.2-vision-90b", "seamless-m4t-large-v2"]
NORMS = ("ln1", "ln2", "ln_x", "ln_f", "enc_ln")
BIASES = ("bq", "bk", "bv", "b_up", "b_down")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def perturb(tree, rng, path=()):
    """Seeded random values for every norm weight and bias (RMSNorm and
    LayerNorm alike) and every cross-attention gate of a numpy param tree;
    the other leaves as they are."""
    if isinstance(tree, dict):
        return {k: perturb(v, rng, path + (k,)) for k, v in tree.items()}
    a = np.asarray(tree)
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    if name in NORMS or (parent in NORMS and name == "w"):
        return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
    if name in BIASES or (parent in NORMS and name == "b"):
        return (0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
    if name == "gate":
        return rng.uniform(0.3, 1.0, a.shape).astype(a.dtype)
    return a


_PAIRS = {}


def pair(arch):
    """(port cfg, port model, reference cfg, reference params): the
    reference's ``init_params(PRNGKey(0))`` with its norms, biases and
    gates perturbed, carried across into the port."""
    if arch not in _PAIRS:
        cfg, jcfg = reduced(get_config(arch)), jreduced(jget_config(arch))
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        np_params = perturb(jax.tree_util.tree_map(np.asarray, jp),
                            np.random.default_rng(11))
        _PAIRS[arch] = (cfg, convert.params_from_reference(
            np_params, cfg, device="cpu"), jcfg,
            jax.tree_util.tree_map(jnp.asarray, np_params))
    return _PAIRS[arch]


def memory(cfg, b, rng):
    """A random vision or frames batch (fp32), as numpy, or {}."""
    stub = model.stub_batch(cfg, b)
    return {name: rng.standard_normal(tuple(t.shape)).astype(np.float32)
            for name, t in stub.items()}


def jax_cache_view(cfg, jcache):
    """The reference cache's leaves in the port's layout: ``len``, ``k``
    and ``v`` with the self layers flattened to one axis (vlm stacks them
    ``(G, every-1, ...)``), ``cross_k`` and ``cross_v``."""
    k = np.asarray(jcache["kv"]["k"])
    out = {"len": np.asarray(jcache["len"]),
           "k": k.reshape((-1,) + k.shape[-4:]),
           "v": np.asarray(jcache["kv"]["v"]).reshape((-1,) + k.shape[-4:])}
    if "cross_kv" in jcache:
        out["cross_k"] = np.asarray(jcache["cross_kv"]["k"])
        out["cross_v"] = np.asarray(jcache["cross_kv"]["v"])
    return out


def assert_caches_match(cache, jcache, cfg):
    want = jax_cache_view(cfg, jcache)
    assert sorted(cache) == sorted(want)
    np.testing.assert_array_equal(cache["len"].numpy(), want["len"])
    for name in sorted(want):
        if name != "len":
            np.testing.assert_allclose(cache[name].numpy(), want[name],
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def both_caches(cfg, m, jcfg, jp, b, max_len, rng, lens):
    """The port's and the reference's caches for the same random memory,
    with random K and V in every position and the lengths ``lens``."""
    mem = memory(cfg, b, rng)
    jcache = jmodel.init_cache(jcfg, jp, {"tokens": jnp.zeros((b, 1),
                                                              jnp.int32),
                                          **{n: jnp.asarray(a)
                                             for n, a in mem.items()}},
                               b, max_len)
    cache = model.init_cache(m, b, max_len,
                             {n: torch.from_numpy(a) for n, a in mem.items()})
    shape = jcache["kv"]["k"].shape
    for name in ("k", "v"):
        kv = (0.5 * rng.standard_normal(shape)).astype(np.float32)
        jcache["kv"][name] = jnp.asarray(kv)
        cache[name].copy_(torch.from_numpy(kv.reshape(cache[name].shape)))
    jcache["len"] = jnp.asarray(lens)
    cache["len"] = torch.from_numpy(lens.copy())
    return cache, jcache


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    for full in (False, True):
        cfg, jcfg = get_config(arch), jget_config(arch)
        if not full:
            cfg, jcfg = reduced(cfg), jreduced(jcfg)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.param_count(True) == jcfg.param_count(True)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_every_leaf(arch):
    cfg, m, jcfg, jp = pair(arch)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    back = convert.params_to_reference(m)
    flat, tree = jax.tree_util.tree_flatten(np_params)
    flat_back, tree_back = jax.tree_util.tree_flatten(back)
    assert tree == tree_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    # the port's weights count what the config counts
    assert sum(p.numel() for p in m.parameters()) == sum(
        a.size for a in flat)
    # a stack of another depth is refused, not half copied
    key = {"vlm": "crosses", "audio": "decoder"}.get(cfg.family, "layers")
    short = dict(np_params)
    short[key] = jax.tree_util.tree_map(lambda a: a[:1], np_params[key])
    with pytest.raises(ValueError, match="stacks"):
        convert.params_from_reference(short, cfg, device="cpu")


# ---------------------------------------------------------------------------
# decode_step against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax_over_ragged_steps(arch):
    """Three requests at cache lengths 0, 3 and 7 (random K/V in every
    position, so masking matters; random vision or frames memory), six
    steps of random tokens: the logits agree at rtol 1e-4 and atol 1e-4 x
    max|logit|, and so does every cache leaf, the cross K and V from the
    memory included."""
    cfg, m, jcfg, jp = pair(arch)
    b, max_len = 3, 16
    rng = np.random.default_rng(7)
    cache, jcache = both_caches(cfg, m, jcfg, jp, b, max_len, rng,
                                np.array([0, 3, 7], np.int32))
    assert_caches_match(cache, jcache, cfg)
    step = jax.jit(lambda p, c, t: jmodel.decode_step(jcfg, p, c, t))
    for _ in range(6):
        toks = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        jlogits, jcache = step(jp, jcache, jnp.asarray(toks))
        logits, cache = model.decode_step(m, cache,
                                          torch.from_numpy(toks).long())
        want = np.asarray(jlogits)
        np.testing.assert_allclose(logits.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    assert_caches_match(cache, jcache, cfg)


def test_sliding_window_cache_wraps_like_the_reference():
    """h2o-danube reduced (window 8): two requests fed 20 tokens each from
    lengths 0 and 5, so the rolling cache wraps more than twice; the
    logits agree with the reference at every step, and so does the
    cache."""
    cfg, m, jcfg, jp = pair("h2o-danube-1.8b")
    assert cfg.sliding_window == 8
    b, max_len = 2, 32
    rng = np.random.default_rng(8)
    cache, jcache = both_caches(cfg, m, jcfg, jp, b, max_len, rng,
                                np.array([0, 5], np.int32))
    assert cache["k"].shape[2] == 8
    step = jax.jit(lambda p, c, t: jmodel.decode_step(jcfg, p, c, t))
    for _ in range(20):
        toks = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        jlogits, jcache = step(jp, jcache, jnp.asarray(toks))
        logits, cache = model.decode_step(m, cache,
                                          torch.from_numpy(toks).long())
        want = np.asarray(jlogits)
        np.testing.assert_allclose(logits.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    assert cache["len"].tolist() == [20, 25]
    assert_caches_match(cache, jcache, cfg)


def test_vision_memory_reaches_the_logits():
    """llama-vision's gated cross attention is not dropped: the same tokens
    against two different vision memories give different logits (and the
    same memory the same logits)."""
    cfg, m = pair("llama-3.2-vision-90b")[:2]
    b, rng = 2, np.random.default_rng(9)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 1))).long()
    logits = []
    for seed in (1, 2, 1):
        mem = memory(cfg, b, np.random.default_rng(seed))
        cache = model.init_cache(m, b, 8, {n: torch.from_numpy(a)
                                           for n, a in mem.items()})
        logits.append(model.decode_step(m, cache, toks)[0])
    assert torch.equal(logits[0], logits[2])
    assert float((logits[0] - logits[1]).abs().max()) > 1e-2 * float(
        logits[0].abs().max())


# ---------------------------------------------------------------------------
# the building blocks against the reference's functions
# ---------------------------------------------------------------------------

def test_layernorm_and_gelu_mlp_match_the_reference():
    rng = np.random.default_rng(3)
    x = (2.0 + rng.standard_normal((3, 5, 64))).astype(np.float32)
    w = (1.0 + 0.2 * rng.standard_normal(64)).astype(np.float32)
    b = (0.2 * rng.standard_normal(64)).astype(np.float32)
    got = common.layernorm(*(torch.from_numpy(a) for a in (x, w, b)))
    want = np.asarray(jcommon.layernorm(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    ws = [(0.2 * rng.standard_normal(s)).astype(np.float32)
          for s in ((64, 128), (128,), (128, 64), (64,))]
    got = common.gelu_mlp(torch.from_numpy(x),
                          *(torch.from_numpy(a) for a in ws))
    want = np.asarray(jcommon.gelu_mlp(jnp.asarray(x),
                                       *(jnp.asarray(a) for a in ws)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("causal,window,q_chunk", [
    (True, 0, 512), (False, 0, 512), (True, 5, 512), (True, 0, 8),
    (False, 3, 8)], ids=["causal", "non_causal", "window", "chunked",
                         "chunked_window"])
def test_full_sequence_attention_matches_the_reference(causal, window,
                                                       q_chunk):
    """GQA 4/2 over 16 positions; ``q_chunk`` 8 takes the chunked-query
    branch (Sq = 2 q_chunk)."""
    rng = np.random.default_rng(4)
    b, s, hq, hkv, hd = 2, 16, 4, 2, 16
    q, k, v = (rng.standard_normal((b, s, h, hd)).astype(np.float32)
               for h in (hq, hkv, hkv))
    pos = np.arange(s)
    got = common.attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
        q_positions=torch.from_numpy(pos), kv_positions=torch.from_numpy(pos),
        sliding_window=window, q_chunk=q_chunk)
    want = np.asarray(jcommon.attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal,
        q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos),
        sliding_window=window, q_chunk=q_chunk))
    assert got.shape == (b, s, hq, hd)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
