"""The ssm and hybrid families (xlstm-125m, zamba2-2.7b) against the JAX
reference: configs, weights carried across and back, each mixer (Mamba2,
mLSTM, sLSTM) step by step and in its chunked full-sequence form, and
``decode_step`` over ragged steps.

Both sides build the same reduced configs (``reduced()`` is copied
exactly).  The reference's init leaves ``conv_b``, ``dt_bias``, ``b_if``
and ``b`` at 0 and ``D``, every norm weight and ``norms`` at 1, which
would hide a dropped term, so ``perturb`` replaces them with seeded random
values before both sides take them; mLSTM's input-gate biases reach 6, so
its stabiliser ``m`` leaves its -1e30 start and the chunked form's clamp
at 0.  Inputs and states are numpy draws from a seed.  fp32 on the CPU
unless a test says bf16; each tolerance is stated where it is used.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402

from repro_torch.configs import ARCHS as PARCHS  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import convert, ssm  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.models.common import Init  # noqa: E402

ARCHS = ["xlstm-125m", "zamba2-2.7b"]
NORMS = ("ln1", "ln2", "ln_f", "norm_w", "norms", "D")
BIASES = ("conv_b", "dt_bias", "b")
# the mixers: (reference init, reference apply, port module, port apply,
# reference state init, the reduced arch whose config they take)
MIXERS = {
    "mamba2": (jssm.mamba2_init, jssm.mamba2_apply, ssm.Mamba2,
               ssm.mamba2_apply, "zamba2-2.7b"),
    "mlstm": (jssm.mlstm_init, jssm.mlstm_apply, ssm.MLSTM,
              ssm.mlstm_apply, "xlstm-125m"),
    "slstm": (jssm.slstm_init, jssm.slstm_apply, ssm.SLSTM,
              ssm.slstm_apply, "xlstm-125m"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def perturb(tree, rng, path=()):
    """Seeded random values for every norm weight, ``D``, bias and gate
    bias of a numpy param tree; the other leaves as they are.  ``b_if``'s
    input-gate half is drawn in [0, 6], its forget-gate half around 2."""
    if isinstance(tree, dict):
        return {k: perturb(v, rng, path + (k,)) for k, v in tree.items()}
    a = np.asarray(tree)
    name = path[-1]
    if name in NORMS:
        return (1.0 + 0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
    if name in BIASES:
        return (0.2 * rng.standard_normal(a.shape)).astype(a.dtype)
    if name == "b_if":
        h = a.shape[-1] // 2
        i_b = rng.uniform(0.0, 6.0, a.shape[:-1] + (h,))
        f_b = 2.0 + rng.standard_normal(a.shape[:-1] + (h,))
        return np.concatenate([i_b, f_b], axis=-1).astype(a.dtype)
    return a


_PAIRS = {}


def pair(arch, dtype="float32"):
    """(port cfg, port model, reference cfg, reference params): the
    reference's ``init_params(PRNGKey(0))`` at the reduced config in
    ``dtype``, perturbed, carried across into the port."""
    key = (arch, dtype)
    if key not in _PAIRS:
        cfg = reduced(get_config(arch)).replace(dtype=dtype)
        jcfg = jreduced(jget_config(arch)).replace(dtype=dtype)
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        np_params = perturb(jax.tree_util.tree_map(np.asarray, jp),
                            np.random.default_rng(11))
        _PAIRS[key] = (cfg, convert.params_from_reference(
            np_params, cfg, device="cpu"), jcfg,
            jax.tree_util.tree_map(jnp.asarray, np_params))
    return _PAIRS[key]


def mixer_pair(kind, seed=5):
    """(port cfg, port mixer, reference cfg, reference params) of one
    fp32 mixer at its reduced arch's config, perturbed."""
    jinit, _, cls, _, arch = MIXERS[kind]
    cfg, jcfg = reduced(get_config(arch)), jreduced(jget_config(arch))
    jp = jinit(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    np_p = perturb(jax.tree_util.tree_map(np.asarray, jp),
                   np.random.default_rng(seed))
    m = cls(cfg, Init(None, torch.device("cpu")), torch.float32)
    assert sorted(n for n, _ in m.named_parameters()) == sorted(np_p)
    with torch.no_grad():
        for name, p in m.named_parameters():
            assert tuple(p.shape) == np_p[name].shape, name
            p.copy_(torch.from_numpy(np.array(np_p[name])))
    return cfg, m, jcfg, {k: jnp.asarray(a) for k, a in np_p.items()}


def random_state(kind, cfg, b, rng):
    """A random decode state of one mixer as numpy (finite ``m``, sLSTM's
    ``n`` positive)."""
    init = {"mamba2": lambda: ssm.mamba2_state_init(cfg, b),
            "mlstm": lambda: ssm.mlstm_state_init(cfg, b),
            "slstm": lambda: ssm.slstm_state_init(cfg, b)}[kind]()
    out = {}
    for name, t in init.items():
        a = 0.5 * rng.standard_normal(tuple(t.shape))
        if kind == "slstm" and name == "n":
            a = rng.uniform(0.5, 2.0, tuple(t.shape))
        out[name] = a.astype(np.float32)
    return out


def assert_close(got, want, rtol, atol_scale, msg=""):
    """|got - want| <= atol_scale max|want| + rtol |want|."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_scale * np.abs(want).max(),
                               err_msg=msg)


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
    assert sorted(PARCHS) == sorted(JARCHS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_every_leaf(arch, dtype):
    """Every leaf across and back bit for bit with its dtype (the fp32
    ``A_log``, ``dt_bias``, ``D``, ``w_if``, ``b_if`` and ``b`` stay fp32
    in a bf16 model); the port counts what the reference holds; a stack
    of another depth is refused."""
    cfg, m, jcfg, jp = pair(arch, dtype)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    back = convert.params_to_reference(m)
    flat, tree = jax.tree_util.tree_flatten(np_params)
    flat_back, tree_back = jax.tree_util.tree_flatten(back)
    assert tree == tree_back
    for a, b in zip(flat, flat_back):
        want = np.float32 if a.dtype.name == "bfloat16" else a.dtype
        assert b.dtype == want and a.shape == b.shape
        assert np.array_equal(a.astype(np.float32), b)
    f32 = {"A_log", "dt_bias", "D", "w_if", "b_if", "b"}
    for name, p in m.named_parameters():
        leaf = name.split(".")[-1]
        assert p.dtype == (torch.float32 if leaf in f32
                           else getattr(torch, dtype)), name
    assert sum(p.numel() for p in m.parameters()) == sum(
        a.size for a in flat)
    key = "mlstm" if cfg.family == "ssm" else "mamba"
    short = dict(np_params)
    short[key] = jax.tree_util.tree_map(lambda a: a[:1], np_params[key])
    with pytest.raises(ValueError, match="stacks"):
        convert.params_from_reference(short, cfg, device="cpu")


# ---------------------------------------------------------------------------
# the mixers against the reference's functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_mixer_decode_matches_jax_over_steps(kind):
    """Three requests from a random state, 24 decode steps of random
    inputs: each output within rtol 1e-4 and 1e-5 x max|y|, and the final
    state leaf by leaf within rtol 1e-4 and 1e-5 x its max."""
    cfg, m, jcfg, jp = mixer_pair(kind)
    japply, apply = MIXERS[kind][1], MIXERS[kind][3]
    rng = np.random.default_rng(2)
    b = 3
    st = random_state(kind, cfg, b, rng)
    jst = {k: jnp.asarray(a) for k, a in st.items()}
    pst = {k: torch.from_numpy(a.copy()) for k, a in st.items()}
    step = jax.jit(lambda p, x, s: japply(p, x, jcfg, state=s))
    for _ in range(24):
        x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
        jy, jst = step(jp, jnp.asarray(x), jst)
        y, pst = apply(m, torch.from_numpy(x), cfg, state=pst)
        assert_close(y.numpy(), jy, 1e-4, 1e-5)
    for name in sorted(st):
        assert pst[name].dtype == torch.float32
        assert_close(pst[name].numpy(), jst[name], 1e-4, 1e-5, msg=name)


@pytest.mark.parametrize("kind,t,chunk", [
    ("mlstm", 16, 16), ("mlstm", 48, 16), ("mamba2", 32, 8),
    ("mamba2", 32, 16), ("slstm", 24, 16)],
    ids=["mlstm_one_chunk", "mlstm_three_chunks", "mamba2_chunk8",
         "mamba2_chunk16", "slstm"])
def test_chunked_forms_match_jax(kind, t, chunk):
    """The full-sequence form (``state=None``) over T tokens at
    ``ssm_chunk`` = chunk, two requests: within rtol 1e-4 and 1e-5 x
    max|y| of the reference."""
    cfg, m, jcfg, jp = mixer_pair(kind)
    cfg, jcfg = cfg.replace(ssm_chunk=chunk), jcfg.replace(ssm_chunk=chunk)
    japply, apply = MIXERS[kind][1], MIXERS[kind][3]
    x = np.random.default_rng(3).standard_normal(
        (2, t, cfg.d_model)).astype(np.float32)
    jy, jnone = japply(jp, jnp.asarray(x), jcfg)
    y, none = apply(m, torch.from_numpy(x), cfg)
    assert none is None and jnone is None
    assert_close(y.numpy(), jy, 1e-4, 1e-5)


def test_slstm_over_steps_from_a_state_matches_jax():
    """sLSTM over 12 tokens from a random state (its chunked form with a
    state): the output and the returned state within rtol 1e-4 and 1e-5 x
    max of the reference."""
    cfg, m, jcfg, jp = mixer_pair("slstm")
    rng = np.random.default_rng(4)
    st = random_state("slstm", cfg, 2, rng)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    jst = {k: jnp.asarray(a) for k, a in st.items()}
    jy, jst = jssm.slstm_apply(jp, jnp.asarray(x), jcfg, state=jst)
    y, pst = ssm.slstm_apply(m, torch.from_numpy(x), cfg,
                             state={k: torch.from_numpy(a.copy())
                                    for k, a in st.items()})
    assert_close(y.numpy(), jy, 1e-4, 1e-5)
    for name in sorted(st):
        assert_close(pst[name].numpy(), jst[name], 1e-4, 1e-5, msg=name)


@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_chunked_form_equals_decode_steps(kind):
    """The port's own decode-equals-forward: the chunked form over 32
    tokens (two chunks of 16) against 32 decode steps from the fresh state,
    at the reference's tolerance for it (atol 2e-4, rtol 2e-3); a length
    that is no whole number of chunks raises."""
    cfg, m = mixer_pair(kind)[:2]
    apply = MIXERS[kind][3]
    init = {"mamba2": ssm.mamba2_state_init, "mlstm": ssm.mlstm_state_init,
            "slstm": ssm.slstm_state_init}[kind]
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32))
    full, _ = apply(m, x, cfg)
    st, rows = init(cfg, 2), []
    for i in range(32):
        y, st = apply(m, x[:, i:i + 1], cfg, state=st)
        rows.append(y)
    np.testing.assert_allclose(torch.cat(rows, 1).numpy(), full.numpy(),
                               atol=2e-4, rtol=2e-3)
    if kind != "slstm":                 # 24 tokens: no whole 16-token chunks
        with pytest.raises(ValueError, match="chunks"):
            apply(m, x[:, :24], cfg)


def test_fresh_states_hold_the_reference_starts():
    """mLSTM's m starts at -1e30 and sLSTM's n at ones, fp32; the Mamba2
    conv tail takes the model's dtype, its SSM state fp32; each equal to
    the reference's state init."""
    for kind, arch in (("mlstm", "xlstm-125m"), ("slstm", "xlstm-125m"),
                       ("mamba2", "zamba2-2.7b")):
        cfg, jcfg = reduced(get_config(arch)), jreduced(jget_config(arch))
        if kind == "mamba2":
            got = ssm.mamba2_state_init(cfg, 3, torch.bfloat16)
            want = jssm.mamba2_state_init(jcfg, 3, jnp.bfloat16)
        else:
            got = getattr(ssm, f"{kind}_state_init")(cfg, 3)
            want = getattr(jssm, f"{kind}_state_init")(jcfg, 3)
        assert sorted(got) == sorted(want)
        for name, t in got.items():
            w = np.asarray(want[name])
            assert str(t.dtype).endswith(w.dtype.name), (kind, name)
            np.testing.assert_array_equal(t.float().numpy(),
                                          w.astype(np.float32))
    xcfg = reduced(get_config("xlstm-125m"))
    assert float(ssm.mlstm_state_init(xcfg, 1)["m"].max()) == float(
        np.float32(-1e30))
    assert float(ssm.slstm_state_init(xcfg, 1)["n"].min()) == 1.0


# ---------------------------------------------------------------------------
# decode_step against the reference
# ---------------------------------------------------------------------------

def jax_cache_view(cfg, jcache):
    """The reference cache's leaves in the port's layout: each stack of
    mixer states flattened to one layer axis, the hybrid's shared K and V
    as ``k``, ``v``."""
    out = {"len": np.asarray(jcache["len"])}
    if cfg.family == "ssm":
        for name, a in jcache["mlstm"].items():
            a = np.asarray(a)
            out[f"mlstm_{name}"] = a.reshape((-1,) + a.shape[2:])
        for name, a in jcache["slstm"].items():
            out[f"slstm_{name}"] = np.asarray(a)
    else:
        for name, a in jcache["mamba"].items():
            a = np.asarray(a)
            out[f"mamba_{name}"] = a.reshape((-1,) + a.shape[2:])
        out["k"] = np.asarray(jcache["shared_kv"]["k"])
        out["v"] = np.asarray(jcache["shared_kv"]["v"])
    return out


def both_caches(m, jcfg, jp, b, max_len, rng, lens):
    """The port's and the reference's caches, every state leaf random (the
    stabilisers finite, sLSTM's n positive), K and V random in every
    position, lengths ``lens``."""
    cfg = m.cfg
    jcache = jmodel.init_cache(jcfg, jp, {"tokens": jnp.zeros((b, 1),
                                                              jnp.int32)},
                               b, max_len)
    cache = model.init_cache(m, b, max_len)
    view = jax_cache_view(cfg, jcache)
    assert sorted(cache) == sorted(view)
    groups = {"ssm": ("mlstm", "slstm"), "hybrid": ("mamba", "shared_kv")}
    for group in groups[cfg.family]:
        for name, a in jcache[group].items():
            shape = np.shape(a)
            r = 0.5 * rng.standard_normal(shape)
            if group == "slstm" and name == "n":
                r = rng.uniform(0.5, 2.0, shape)
            r = r.astype(np.asarray(a).dtype)
            jcache[group][name] = jnp.asarray(r)
            port = name if group == "shared_kv" else f"{group}_{name}"
            cache[port].copy_(torch.from_numpy(
                r.astype(np.float32)).reshape(cache[port].shape))
    jcache["len"] = jnp.asarray(lens)
    cache["len"] = torch.from_numpy(lens.copy())
    return cache, jcache


def assert_caches_match(cache, jcache, cfg, rtol=1e-4, atol_scale=1e-4):
    want = jax_cache_view(cfg, jcache)
    assert sorted(cache) == sorted(want)
    np.testing.assert_array_equal(cache["len"].numpy(), want["len"])
    for name in sorted(want):
        if name != "len":
            assert_close(cache[name].float().numpy(),
                         np.asarray(want[name], np.float32), rtol,
                         atol_scale, msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax_over_ragged_steps(arch):
    """Three requests at cache lengths 0, 3 and 7 from random states (and
    random shared K and V for zamba2, so its masking matters), eight steps
    of random tokens: the logits within rtol 1e-4 and 1e-4 x max|logit|
    of the reference's, every cache leaf within rtol 1e-4 and 1e-4 x its
    max."""
    cfg, m, jcfg, jp = pair(arch)
    b, max_len = 3, 16
    rng = np.random.default_rng(7)
    cache, jcache = both_caches(m, jcfg, jp, b, max_len, rng,
                                np.array([0, 3, 7], np.int32))
    assert_caches_match(cache, jcache, cfg)
    step = jax.jit(lambda p, c, t: jmodel.decode_step(jcfg, p, c, t))
    for _ in range(8):
        toks = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        jlogits, jcache = step(jp, jcache, jnp.asarray(toks))
        logits, cache = model.decode_step(m, cache,
                                          torch.from_numpy(toks).long())
        assert_close(logits.numpy(), jlogits, 1e-4, 1e-4)
    assert_caches_match(cache, jcache, cfg)
    if cfg.family == "ssm":
        assert "k" not in cache


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_decode_matches_jax(arch):
    """The bf16 model, one decode step of two requests from the fresh
    cache: the logits (|logit| up to ~0.6) within atol 2e-2 and rtol 2e-2
    of the reference's bf16 decode; the fp32 states stay fp32.  (Later
    steps drift apart by bf16 rounding alone: each side is as far from the
    fp32 model as from the other.)"""
    cfg, m, jcfg, jp = pair(arch, "bfloat16")
    b, rng = 2, np.random.default_rng(8)
    jcache = jmodel.init_cache(jcfg, jp, {"tokens": jnp.zeros((b, 1),
                                                              jnp.int32)},
                               b, 16)
    cache = model.init_cache(m, b, 16)
    toks = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
    jlogits, _ = jmodel.decode_step(jcfg, jp, jcache, jnp.asarray(toks))
    logits, cache = model.decode_step(m, cache, torch.from_numpy(toks).long())
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(logits.float().numpy(),
                               np.asarray(jlogits, np.float32), atol=2e-2,
                               rtol=2e-2)
    state = "mamba_ssm" if cfg.family == "hybrid" else "mlstm_C"
    assert cache[state].dtype == torch.float32
    if cfg.family == "hybrid":
        assert cache["mamba_conv"].dtype == torch.bfloat16
