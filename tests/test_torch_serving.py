"""The port's serving path against the JAX reference: ``decode_step`` on
carried-across weights, the ``ServingEngine`` token for token, and the
port's counterparts of tests/test_serving.py's engine tests.

Both sides build the same reduced configs (``reduced()`` is copied
exactly): qwen2-moe-a2.7b (4 layers, d 64, 4 experts top-2, one shared
expert, vocab 256) and granite-8b (the dense case).  The reference's
weights come from its ``init_params`` and cross as numpy arrays through
``convert.params_from_reference``; caches and tokens are numpy draws from a
seed.  fp32 on the CPU, where the port runs its kernels' plain versions.
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402

from repro_torch import serve  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import AggregationConfig  # noqa: E402
from repro_torch.core import AggregationExecutor, FaultInjector  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    EngineOverloaded, Request, ServingEngine,
)

ARCHS = ["qwen2-moe-a2.7b", "granite-8b"]
PROMPTS = [[5, 7, 9], [11, 3], [2, 2, 2, 2], [8], [13, 21], [1, 2, 3]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PAIRS = {}


def pair(arch):
    """(port cfg, port model, reference cfg, reference params), the port's
    weights copied from the reference's ``init_params(PRNGKey(0))``."""
    if arch not in _PAIRS:
        cfg, jcfg = reduced(get_config(arch)), jreduced(jget_config(arch))
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        np_params = jax.tree_util.tree_map(np.asarray, jp)
        _PAIRS[arch] = (cfg, convert.params_from_reference(
            np_params, cfg, device="cpu"), jcfg, jp)
    return _PAIRS[arch]


def ref_decode(cfg, m, prompt, n_new, max_len=64):
    """One request alone through the port's bucket-1 ``decode_step``."""
    cache = model.init_cache(m, 1, max_len)
    for t in prompt[:-1]:
        _, cache = model.decode_step(m, cache, torch.tensor([[t]]))
    tok, out = prompt[-1], []
    for _ in range(n_new):
        lg, cache = model.decode_step(m, cache, torch.tensor([[tok]]))
        tok = int(torch.argmax(lg[0]))
        out.append(tok)
    return out


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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_config("dbrx-132b")
    with pytest.raises(KeyError):
        get_config("no-such-model")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_every_leaf(arch):
    cfg, m, jcfg, jp = pair(arch)
    np_params = jax.tree_util.tree_map(np.asarray, jp)
    back = convert.params_to_reference(m)
    flat, tree = jax.tree_util.tree_flatten(np_params)
    flat_back, tree_back = jax.tree_util.tree_flatten(back)
    assert tree == tree_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(KeyError, match="no leaf"):
        convert.params_from_reference({"embed": np_params["embed"]}, cfg,
                                      device="cpu")


# ---------------------------------------------------------------------------
# decode_step against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax_over_ragged_steps(arch):
    """Three requests at cache lengths 0, 3 and 7 (random K/V in every
    position, so masking matters), six steps of random tokens: the logits
    agree at rtol 1e-4 and atol 1e-4 x max|logit| (the sums run in another
    order across 4 layers)."""
    cfg, m, jcfg, jp = pair(arch)
    b, max_len = 3, 16
    rng = np.random.default_rng(7)
    hd = cfg.resolved_head_dim
    shape = (cfg.n_layers, b, max_len, cfg.n_kv_heads, hd)
    kv = {n: (0.5 * rng.standard_normal(shape)).astype(np.float32)
          for n in ("k", "v")}
    lens = np.array([0, 3, 7], np.int32)
    jcache = jmodel.init_cache(jcfg, jp, {"tokens": jnp.zeros((b, 1),
                                                              jnp.int32)},
                               b, max_len)
    jcache["kv"] = {n: jnp.asarray(kv[n]) for n in ("k", "v")}
    jcache["len"] = jnp.asarray(lens)
    cache = model.init_cache(m, b, max_len)
    for n in ("k", "v"):
        cache[n].copy_(torch.from_numpy(kv[n]))
    cache["len"] = torch.from_numpy(lens.copy())
    step = jax.jit(lambda p, c, t: jmodel.decode_step(jcfg, p, c, t))
    for _ in range(6):
        toks = rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32)
        jlogits, jcache = step(jp, jcache, jnp.asarray(toks))
        logits, cache = model.decode_step(m, cache,
                                          torch.from_numpy(toks).long())
        want = np.asarray(jlogits)
        np.testing.assert_allclose(logits.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    np.testing.assert_array_equal(cache["len"].numpy(),
                                  np.asarray(jcache["len"]))
    for n in ("k", "v"):
        np.testing.assert_allclose(cache[n].numpy(),
                                   np.asarray(jcache["kv"][n]), rtol=1e-4,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the engine against the reference's engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(arch):
    cfg, m, jcfg, jp = pair(arch)
    jeng = JServingEngine(jcfg, jp, max_batch=4, max_len=64)
    eng = ServingEngine(cfg, m, max_batch=4, max_len=64, device="cpu")
    jreqs = [JRequest(i, p, max_new_tokens=4) for i, p in enumerate(PROMPTS)]
    reqs = [Request(i, p, max_new_tokens=4) for i, p in enumerate(PROMPTS)]
    for jr, r in zip(jreqs, reqs):
        jeng.submit(jr)
        eng.submit(r)
    jeng.run()
    eng.run()
    for jr, r in zip(jreqs, reqs):
        assert r.done and jr.done
        assert r.output == jr.output, r.rid
    assert eng.stats["launches"] == jeng.stats["launches"]
    assert eng.stats["aggregated_hist"] == jeng.stats["aggregated_hist"]
    assert eng.stats["tokens"] == jeng.stats["tokens"]


# ---------------------------------------------------------------------------
# tests/test_serving.py's engine tests, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_sequential(arch):
    cfg, m = pair(arch)[:2]
    eng = ServingEngine(cfg, m, max_batch=4, max_len=64, device="cpu")
    reqs = [Request(i, p, max_new_tokens=4) for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    for r in reqs:
        assert r.done
        assert r.output == ref_decode(cfg, m, r.prompt, 4), r.rid


def test_engine_aggregates_requests():
    """More requests than slots: the engine batches, admits continuously and
    launches only buckets of the ladder."""
    cfg, m = pair("granite-8b")[:2]
    eng = ServingEngine(cfg, m, max_batch=8, max_len=32, device="cpu")
    reqs = [Request(i, [i % 7 + 1], max_new_tokens=6) for i in range(20)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done for r in reqs)
    assert eng.stats["tokens"] == 20 * 6
    assert eng.stats["launches"] < eng.stats["tokens"]
    hist = eng.stats["aggregated_hist"]
    assert max(hist) == 8
    assert set(hist) <= {1, 2, 4, 8}


def test_engine_slot_reuse_no_crosstalk():
    """A slot freed by a finished request and reused by a new one does not
    leak the old request's KV state; pad lanes never touch a live slot."""
    cfg, m = pair("granite-8b")[:2]
    eng = ServingEngine(cfg, m, max_batch=2, max_len=32, device="cpu")
    first = [Request(0, [3, 1, 4], max_new_tokens=3),
             Request(1, [1, 5], max_new_tokens=5)]
    second = [Request(2, [9, 2, 6], max_new_tokens=4)]
    for r in first + second:
        eng.submit(r)
    eng.run()
    for r in first + second:
        assert r.output == ref_decode(cfg, m, r.prompt, r.max_new_tokens)


def test_engine_bucket_ladder_from_config():
    cfg, m = pair("granite-8b")[:2]
    agg = AggregationConfig(max_aggregated=4, buckets=(1, 4))
    eng = ServingEngine(cfg, m, max_batch=4, max_len=16, agg=agg,
                        device="cpu")
    assert eng.buckets == (1, 4)
    reqs = [Request(i, [i + 1, i + 2], max_new_tokens=2) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert set(eng.stats["aggregated_hist"]) == {1, 4}
    for r in reqs:
        assert r.output == ref_decode(cfg, m, r.prompt, 2)


def test_engine_backpressure_and_lifecycle():
    cfg, m = pair("granite-8b")[:2]
    eng = ServingEngine(cfg, m, max_batch=2, max_len=32, max_pending=2,
                        device="cpu")
    eng.submit(Request(0, [3, 5], max_new_tokens=2))
    eng.submit(Request(1, [2, 4], max_new_tokens=2))
    with pytest.raises(EngineOverloaded, match="queue full"):
        eng.submit(Request(2, [1], max_new_tokens=1))
    h = eng.healthz()
    assert h["queue_depth"] == 2 and h["max_pending"] == 2
    assert h["slots_free"] == 2 and not h["draining"] and not h["closed"]
    assert h["breakers"] == {} and h["tenants"]["queue_depth"] == {0: 2}
    eng.drain()
    assert not eng.pending and not eng.active
    with pytest.raises(EngineOverloaded, match="draining"):
        eng.submit(Request(3, [1], max_new_tokens=1))
    eng.close()
    with pytest.raises(EngineOverloaded, match="closed"):
        eng.submit(Request(4, [1], max_new_tokens=1))
    assert eng.healthz()["closed"]
    for bad in (Request(5, []), Request(6, [cfg.vocab_size]),
                Request(7, [1], max_new_tokens=0),
                Request(8, [1] * 30, max_new_tokens=3)):
        with pytest.raises(ValueError):
            ServingEngine(cfg, m, max_batch=2, max_len=32,
                          device="cpu").submit(bad)


def test_engine_deadline_shedding():
    cfg, m = pair("granite-8b")[:2]
    eng = ServingEngine(cfg, m, max_batch=2, max_len=32, device="cpu")
    with pytest.raises(ValueError):
        eng.submit(Request(0, [1], deadline_s=0))
    stale = Request(1, [3, 5], max_new_tokens=4, deadline_s=1e-4)
    live = Request(2, [2, 4], max_new_tokens=2, deadline_s=30.0)
    eng.submit(stale)
    eng.submit(live)
    time.sleep(0.005)
    eng.run()
    assert stale.failed and stale.done and "shed" in stale.error
    assert stale.output == []
    assert live.done and not live.failed and len(live.output) == 2
    assert eng.stats["faults"]["shed"] == 1
    slow = Request(3, [1, 2], max_new_tokens=8, deadline_s=60.0)
    eng.submit(slow)
    eng.step()
    assert slow in eng.active.values()
    slow._deadline = 0.0
    eng.step()
    assert slow.failed and "mid-decode" in slow.error
    assert sorted(eng.slots_free) == [0, 1]
    assert eng.stats["faults"]["shed"] == 2


# ---------------------------------------------------------------------------
# devices and what is not ported
# ---------------------------------------------------------------------------

def test_engine_without_a_device_needs_the_card(monkeypatch):
    cfg, m = pair("granite-8b")[:2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, m, max_batch=2, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init_params(cfg, 0)


def test_unported_engine_options_raise_naming_roadmap():
    cfg, m = pair("granite-8b")[:2]
    kw = dict(max_batch=2, max_len=16, device="cpu")
    # tenancy and the tune store are ported: a batcher is accepted and
    # reported in healthz, the store in stats
    class Batcher:
        def healthz(self):
            return {"count": 1, "queue_depth": {"acme": 4},
                    "shard_occupancy": [4]}
    eng = ServingEngine(cfg, m, batcher=Batcher(), agg=AggregationConfig(
        max_aggregated=2, tune_store="/nonexistent"), **kw)
    assert eng.healthz()["tenants"] == {
        "count": 1, "queue_depth": {"acme": 4}, "active": {},
        "shard_occupancy": [4]}
    assert eng.stats["tune_store"] == "/nonexistent"
    assert eng.stats["warm_start"] is True
    # containment is ported: an injector, a shared executor and the guard
    ServingEngine(cfg, m, fault_injector=FaultInjector([]),
                  executor=AggregationExecutor(device="cpu"),
                  agg=AggregationConfig(max_aggregated=2, guard="finite"),
                  **kw)
    with pytest.raises(ValueError, match="built for"):
        ServingEngine(pair("qwen2-moe-a2.7b")[0], m, **kw)


def test_serve_runs_on_cpu(capsys):
    serve.main(["--arch", "qwen2-moe-a2.7b", "--reduced", "--device", "cpu",
                "--requests", "6", "--max-batch", "4", "--max-len", "16",
                "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert "served 6/6 requests, 18 tokens" in out
    assert "histogram=" in out and "decode_attention_cuda 0" in out
