"""The port's compiled-program tables against the JAX reference's, on the
CPU: after the same warmup and submissions, every aggregation region's
``compiled`` keys, every ``s4`` region's and the serving engine's
``_decode`` equal the reference's, and the results stay within the
kernels' tolerance (exact for the affine bodies, tokens equal for the
engine).  On the CPU a program is the eager callable; the card's table of
graphs is exercised here through an injected capture stub
(``EagerProgram``: a ``BucketProgram`` whose capture records the site and
whose replay calls the function), which checks the bookkeeping: the
offsets per key, both ring buffers, the static parents and the bound on
the captures.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import amr_sedov as jamr_configs  # noqa: E402
from repro.configs.base import AggregationConfig as JAggregationConfig  # noqa: E402
from repro.core import AMRSedovScenario as JAMRSedovScenario  # noqa: E402
from repro.core import StrategyRunner as JStrategyRunner  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core.sharding import ShardedAggregationExecutor as JSharded  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402

from repro_torch.configs import amr_sedov as amr_configs  # noqa: E402
from repro_torch.configs.base import AggregationConfig  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AMRSedovScenario, AggregationExecutor, StrategyRunner, graphs,
)
from repro_torch.core.aggregation import greedy_decomposition  # noqa: E402
from repro_torch.core.executor import ExecutorPool  # noqa: E402
from repro_torch.core.sharding import ShardedAggregationExecutor  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

from test_torch_serving import pair  # noqa: E402

CPU = torch.device("cpu")
WM = 10 ** 9
AMR_CONFIGS = {"CONFIG": amr_configs.CONFIG,
               "CONFIG_MIXED": amr_configs.CONFIG_MIXED}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def affine(x, out=None):
    r = 2.0 * x + 1.0
    return r if out is None else out.copy_(r)


def jexecutor(cfg):
    """A reference executor on an always-idle pool (the port's CPU
    executors are never busy)."""
    exe = jagg.AggregationExecutor(jax.vmap(lambda x: 2.0 * x + 1.0), cfg)
    exe.pool.any_idle = lambda: True
    return exe


def keys(exe):
    """Every region's program keys, by region."""
    return {sig.describe(): set(r.compiled)
            for sig, r in exe.regions.items()}


def one_keys(exe):
    (k,) = keys(exe).values()
    return k


# ---------------------------------------------------------------------------
# the aggregation regions' keys against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("staging", ["device", "host"])
def test_per_task_warmup_keys_equal_reference(staging):
    """``warmup(example_args)``: ``("ring", b)`` under device staging (the
    reference's tests/test_slot_ring.py:108), ``("host", b)`` under host
    staging (:122); the launches after it add what the reference's add."""
    kw = dict(strategy="s3", max_aggregated=8, launch_watermark=WM,
              staging=staging)
    jexe = jexecutor(JAggregationConfig(**kw))
    jexe.warmup((jnp.zeros((3,)),))
    exe = AggregationExecutor(affine, AggregationConfig(**kw), device=CPU)
    exe.warmup(example_args=(torch.zeros(3),))
    mode = "ring" if staging == "device" else "host"
    want = {(mode, b) for b in AggregationConfig(**kw).bucket_sizes()}
    assert one_keys(exe) == set(jexe._compiled) == want
    xs = [np.full((3,), float(i), np.float32) for i in range(13)]
    jout = jexe.map([(jnp.asarray(x),) for x in xs])
    out = exe.map([(torch.from_numpy(x),) for x in xs])
    assert one_keys(exe) == set(jexe._compiled)
    for o, j in zip(out, jout):
        np.testing.assert_array_equal(o.numpy(), np.asarray(j))


def _ref_submissions(exe, parents, other, lib):
    """Ranges and per-task references: a warmed parent set in order and
    out of order, and a parent of another shape (no warmup)."""
    futs = [exe.submit_range((parents,), 0, 12),
            exe.submit_indexed((parents,), 20),
            exe.submit_indexed((parents,), 14),
            exe.submit_indexed((parents,), 17)]
    exe.flush()
    futs.append(exe.submit_range((other,), 1, 5))
    exe.flush()
    return [lib(f.result()) for f in futs]


def test_by_reference_keys_equal_reference():
    """``warmup(parent_shapes)`` files ``("gather", b, pk)`` and
    ``("prefix_aot", b, pk)``; a contiguous run of an unwarmed parent
    shape files ``("prefix", k)``; an unwarmed gather runs
    ``gather_jit``, which files nothing."""
    kw = dict(strategy="s3", max_aggregated=8, launch_watermark=WM)
    parents = np.arange(24 * 2, dtype=np.float32).reshape(24, 2)
    other = np.arange(9 * 2, dtype=np.float32).reshape(9, 2)
    jexe = jexecutor(JAggregationConfig(**kw))
    jexe.warmup(parent_shapes=(jnp.zeros((24, 2)),))
    exe = AggregationExecutor(affine, AggregationConfig(**kw), device=CPU)
    exe.warmup([((24, 2), torch.float32)])
    assert one_keys(exe) == set(jexe._compiled)
    jout = _ref_submissions(jexe, jnp.asarray(parents), jnp.asarray(other),
                            np.asarray)
    out = _ref_submissions(exe, torch.from_numpy(parents),
                           torch.from_numpy(other), lambda t: t.numpy())
    assert one_keys(exe) == set(jexe._compiled)
    assert ("prefix", 4) in set(jexe._compiled)
    assert ("gather", 1, ((24, 2),)) in set(jexe._compiled)
    for o, j in zip(out, jout):
        np.testing.assert_array_equal(o, j)


@pytest.mark.parametrize("name", ["CONFIG", "CONFIG_MIXED"])
def test_amr_warmup_keys_equal_reference(name):
    """The runner's warmup of the AMR scenario (the reference's
    tests/test_amr.py:158; ``CONFIG_MIXED`` has two families, a 16^3 and
    an 8^3 one) files the same programs per family."""
    agg = dict(strategy="s3", n_executors=1, max_aggregated=16,
               launch_watermark=WM)
    jr = JStrategyRunner(JAMRSedovScenario(getattr(jamr_configs, name)),
                         JAggregationConfig(**agg))
    jr.warmup()
    r = StrategyRunner(AMRSedovScenario(AMR_CONFIGS[name]),
                       AggregationConfig(**agg), device=CPU)
    r.warmup()
    want = {sig.describe(): set(reg.compiled)
            for sig, reg in jr.executor.regions.items()}
    assert len(want) == (2 if name == "CONFIG_MIXED" else 1)
    assert all(want.values())
    assert keys(r.executor) == want


def test_retune_files_the_used_decomposition_like_the_reference():
    """Autotune by launch count over mixed ranges and tasks: the new
    ladder's used buckets get their programs for every parent set, as the
    reference AOT-compiles them; the lazily filed programs agree too."""
    n_parent, cap = 40, 16
    parent = np.arange(n_parent * 2, dtype=np.float32).reshape(n_parent, 2)
    kw = dict(strategy="s3", max_aggregated=cap, autotune=True,
              autotune_warmup=2, compile_budget=3, launch_watermark=WM)
    waves = [[("range", 0, 13), ("task", 20), ("range", 21, 9)],
             [("range", 0, 27)], [("range", 3, 13), ("task", 30)],
             [("range", 0, 40)]]
    jexe = jexecutor(JAggregationConfig(**kw))
    exe = AggregationExecutor(affine, AggregationConfig(**kw), device=CPU)
    for e, p, fut_of in ((jexe, jnp.asarray(parent), np.asarray),
                         (exe, torch.from_numpy(parent),
                          lambda t: t.numpy())):
        for subs in waves:
            futs = [e.submit_range((p,), s[1], s[2]) if s[0] == "range"
                    else e.submit_indexed((p,), s[1]) for s in subs]
            e.flush()
            for f in futs:
                fut_of(f.result())
    (jregion,) = jexe.regions.values()
    (region,) = exe.regions.values()
    assert region.tuned and region.buckets == jregion.buckets != (1, 2, 4,
                                                                  8, 16)
    assert one_keys(exe) == set(jexe._compiled)
    assert any(k[0] == "prefix_aot" for k in jexe._compiled)


def test_chunk_resweep_resets_the_table_like_the_reference():
    """A retune whose ``inner_chunk="auto"`` re-sweep changes the chunk
    drops every program (``reset_compiled``) and files the used buckets
    anew, as the reference does.  The chunk choice and the candidates'
    measurement are pinned on both sides (no clock decides)."""
    n_parent, cap = 32, 8
    parent = np.arange(n_parent * 2, dtype=np.float32).reshape(n_parent, 2)
    kw = dict(strategy="s3", max_aggregated=cap, autotune=True,
              autotune_warmup=2, compile_budget=3, launch_watermark=WM,
              cost_model=True, inner_chunk="auto")

    def pin(e):
        def tune(region, parents, force=False):
            region.chunk = 2 if force else 4
            region.chunk_tuned = True
            region.stats["inner_chunk"] = region.chunk
        e._tune_chunk = tune
        e._measure_candidates = lambda region: None
        return e

    jexe = pin(jexecutor(JAggregationConfig(**kw)))
    jexe.warmup(parent_shapes=(jnp.zeros((n_parent, 2)),))
    exe = pin(AggregationExecutor(affine, AggregationConfig(**kw),
                                  device=CPU, timer=lambda fn, *a: (fn(),
                                                                    1e-3)[1]))
    exe.warmup([((n_parent, 2), torch.float32)])
    assert one_keys(exe) == set(jexe._compiled)
    before = set(jexe._compiled)
    for e, p in ((jexe, jnp.asarray(parent)), (exe, torch.from_numpy(parent))):
        for n in (11, 11, 11):
            f = e.submit_range((p,), 0, n)
            e.flush()
            f.result()
    (jregion,) = jexe.regions.values()
    (region,) = exe.regions.values()
    assert region.chunk == jregion.chunk == 2
    assert set(jexe._compiled) != before
    assert one_keys(exe) == set(jexe._compiled)


# ---------------------------------------------------------------------------
# s4 and the serving engine
# ---------------------------------------------------------------------------

def test_s4_drain_keys_equal_reference():
    """One range and two per-task submissions drain through
    ``("shard", local, key)`` programs on the one-device mesh, keyed by
    the arguments' shapes and dtypes as the reference spells them."""
    jexe = JSharded(jax.vmap(lambda x: 2.0 * x + 1.0),
                    config=JAggregationConfig(strategy="s4",
                                              max_aggregated=4,
                                              launch_watermark=WM),
                    name="toy")
    exe = ShardedAggregationExecutor(
        affine, config=AggregationConfig(strategy="s4", max_aggregated=4,
                                         launch_watermark=WM),
        name="toy", device=CPU)
    xs = np.arange(24, dtype=np.float32).reshape(12, 2)
    jf = jexe.submit_range((jnp.asarray(xs),), 2, 7)
    f = exe.submit_range((torch.from_numpy(xs),), 2, 7)
    js = [jexe.submit(jnp.asarray(xs[i])) for i in (0, 11)]
    s = [exe.submit(torch.from_numpy(xs[i])) for i in (0, 11)]
    jexe.flush()
    exe.flush()
    jk = {sig.describe(): set(r.compiled)
          for sig, r in jexe._regions.items()}
    assert keys(exe) == jk
    assert {k[0] for ks in jk.values() for k in ks} == {"shard"}
    np.testing.assert_array_equal(f.result().numpy(), np.asarray(jf.result()))
    for a, b in zip(s, js):
        np.testing.assert_array_equal(a.result().numpy(),
                                      np.asarray(b.result()))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "granite-8b"])
def test_engine_decode_programs_equal_reference(arch):
    """The same requests through both engines: one ``_decode`` program per
    engine bucket used, the same buckets, the same tokens."""
    cfg, m, jcfg, jp = pair(arch)
    prompts = [[5, 7, 9], [11, 3], [2, 2, 2, 2], [8], [13, 21]]
    jeng = JServingEngine(jcfg, jp, max_batch=4, max_len=64)
    eng = ServingEngine(cfg, m, max_batch=4, max_len=64, device="cpu")
    jreqs = [JRequest(i, p, max_new_tokens=3 + i) for i, p in
             enumerate(prompts)]
    reqs = [Request(i, p, max_new_tokens=3 + i) for i, p in
            enumerate(prompts)]
    for jr, r in zip(jreqs, reqs):
        jeng.submit(jr)
        eng.submit(r)
    jeng.run()
    eng.run()
    assert set(eng._decode) == set(jeng._decode)
    assert len(eng._decode) > 1
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    eng.close()
    assert not eng._decode


# ---------------------------------------------------------------------------
# the card's bookkeeping, through an injected capture stub
# ---------------------------------------------------------------------------

class EagerProgram(graphs.BucketProgram):
    """A ``BucketProgram`` whose capture records the site's inputs and
    whose replay is the eager call: the card's table, minus the graphs."""

    def _capture(self, args):
        return tuple(args)

    def _replay(self, site, args):
        return self.fn(*args)


@pytest.fixture
def stub(monkeypatch):
    monkeypatch.setattr(graphs, "make_program",
                        lambda fn, device, **kw: EagerProgram(fn, device,
                                                              **kw))


def _offsets(prog):
    return sorted(site[0][1] for site in prog.sites)


def test_stub_offsets_per_key_and_static_parents(stub):
    """512 slots at cap 32: warmup captures the 16 offsets of the wave's
    greedy drain on the static parent; waves of fresh parents are copied
    into it and replay those 16 graphs, capturing nothing more."""
    cap, n = 32, 512
    exe = AggregationExecutor(affine, AggregationConfig(
        strategy="s3", max_aggregated=cap, launch_watermark=WM), device=CPU)
    exe.warmup([((n, 2), torch.float32)])
    (region,) = exe.regions.values()
    pk = ((n, 2),)
    prog = region.compiled[("prefix_aot", cap, pk)]
    assert _offsets(prog) == list(range(0, n, cap))
    captured = exe.stats["captures"]
    assert captured == sum(len(p.sites) for p in region.compiled.values()
                           if isinstance(p, graphs.BucketProgram)) \
        + len(region.host_jit.sites)
    for wave in range(3):
        parent = torch.randn(n, 2, generator=torch.Generator().manual_seed(
            wave))
        fut = exe.submit_range((parent,), 0, n)
        exe.flush()
        assert torch.equal(fut.result(), affine(parent))
    assert exe.stats["captures"] == captured
    assert _offsets(prog) == list(range(0, n, cap))
    (static,) = region._statics[(pk, 0)]
    assert all(site[1] == ("fixed", id(static)) for site in prog.sites)
    # cap 512: one offset
    exe = AggregationExecutor(affine, AggregationConfig(
        strategy="s3", max_aggregated=n, launch_watermark=WM), device=CPU)
    exe.warmup([((n, 2), torch.float32)])
    (region,) = exe.regions.values()
    assert _offsets(region.compiled[("prefix_aot", n, pk)]) == [0]


def test_stub_ring_programs_use_both_buffers_within_the_bound(stub):
    """Per-task staging on the ring: ``warmup(example_args)`` captures each
    bucket at slot 0 of both ring buffers; watermark-1 waves add offsets,
    never more than the ladder's sum of (capacity - b + 1) per buffer."""
    cap = 8
    exe = AggregationExecutor(affine, AggregationConfig(
        strategy="s3", max_aggregated=cap, launch_watermark=1), device=CPU)
    exe.warmup(example_args=(torch.zeros(3),))
    (region,) = exe.regions.values()
    bufs = {id(b[0]) for b in region.ring.all_buffers()}
    for b in AggregationConfig(max_aggregated=cap).bucket_sizes():
        prog = region.compiled[("ring", b)]
        assert {site[1][1] for site in prog.sites} == bufs
        assert _offsets(prog) == [0, 0]
    for wave in range(4):
        xs = [torch.full((3,), float(wave * 20 + i)) for i in range(13)]
        assert all(torch.equal(o, affine(x))
                   for o, x in zip(exe.map([(x,) for x in xs]), xs))
    ladder = region.buckets
    bound = 2 * sum(cap - b + 1 for b in ladder)
    ring_sites = sum(len(region.compiled[("ring", b)].sites) for b in ladder)
    assert ring_sites <= bound
    assert exe.stats["captures"] == ring_sites + len(region.host_jit.sites)


def test_stub_engine_is_untouched_and_s4_reads_fixed_inputs(stub):
    """``s4`` under the stub: a range that does not keep its address is
    copied into the region's static inputs (one site per key, whatever
    the waves); ``fixed=True`` reads the parents in place."""
    exe = ShardedAggregationExecutor(
        affine, config=AggregationConfig(strategy="s4", max_aggregated=4),
        name="toy", device=CPU)
    for wave in range(3):
        xs = torch.full((7, 2), float(wave))
        f = exe.submit_range((xs,), 0, 7)
        exe.flush()
        assert torch.equal(f.result(), affine(xs))
    (region,) = exe.regions.values()
    (prog,) = region.compiled.values()
    assert len(prog.sites) == 1 and exe.stats["captures"] == 1
    fixed = torch.ones(7, 2)
    for _ in range(2):
        f = exe.submit_range((fixed,), 0, 7, fixed=True)
        exe.flush()
        assert torch.equal(f.result(), affine(fixed))
    assert len(prog.sites) == 2
    assert ("fixed", id(fixed)) in {s[0] for s in prog.sites}


def _stub_runs(make_scenario, state, dt, steps=2):
    """``s3`` (cap 8) and ``fused`` runs of ``steps`` RK3 steps; the s3
    runner."""
    outs, runner = [], None
    for strategy in ("s3", "fused"):
        r = StrategyRunner(make_scenario(), AggregationConfig(
            strategy=strategy, max_aggregated=8), device=CPU)
        r.warmup(wave_only=True)
        s = state
        for _ in range(steps):
            s = r.rk3_step(s, dt)
        outs.append(s if isinstance(s, tuple) else (s,))
        runner = runner or r
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    return runner


def test_stub_populations_written_in_place_copy_nothing(stub):
    """Under the stub the executor's statics are what ``s3`` hands the
    scenario: the uniform wave is extracted straight into static set 0,
    the two AMR levels (one family, one shape) into sets 0 and 1 with
    their widths, and no launch copies a parent; the results equal
    ``fused`` bit for bit."""
    from repro_torch.configs.base import HydroConfig
    from repro_torch.core import UniformSedovScenario
    from repro_torch.hydro.state import amr_sedov_init, sedov_init
    from repro_torch.hydro.stepper import amr_courant_dt, courant_dt

    cfg = HydroConfig(levels=2)
    u = sedov_init(cfg, device=CPU).u
    r = _stub_runs(lambda: UniformSedovScenario(cfg), u,
                   float(courant_dt(u, cfg)))
    assert r.executor.stats["static_parent_copies"] == 0
    (region,) = r.executor.regions.values()
    assert [k[1] for k in region._statics] == [0]

    acfg = amr_configs.CONFIG
    st = amr_sedov_init(acfg, device=CPU)
    sc = AMRSedovScenario(acfg)
    r = _stub_runs(lambda: sc, (st.uc, st.uf),
                   float(amr_courant_dt(st.uc, st.uf, acfg)))
    assert r.executor.stats["static_parent_copies"] == 0
    (region,) = r.executor.regions.values()
    assert sorted(k[1] for k in region._statics) == [0, 1]
    for slot, lvl in enumerate(sc.LEVELS):
        (pk,) = {k[0] for k in region._statics}
        assert torch.equal(region._statics[(pk, slot)][1],
                           sc.h_vec(lvl, CPU))


@pytest.mark.parametrize("strategy", ["s3", "s4"])
def test_stub_buffers_follow_the_executor(stub, strategy):
    """``s3`` hands ``populations`` its executor's ``population_buffers``
    at every stage; under ``s4`` the sharded executor writes nothing in
    place (``writes_in_place`` is False), so ``populations`` gets None."""
    from repro_torch.configs.base import HydroConfig
    from repro_torch.core import UniformSedovScenario
    from repro_torch.hydro.state import sedov_init
    from repro_torch.hydro.stepper import courant_dt

    seen = []

    class Spy(UniformSedovScenario):
        def populations(self, state, buffers=None):
            seen.append(buffers)
            return super().populations(state, buffers=buffers)

    cfg = HydroConfig(levels=2)
    u = sedov_init(cfg, device=CPU).u
    r = StrategyRunner(Spy(cfg), AggregationConfig(
        strategy=strategy, max_aggregated=8), device=CPU)
    r.warmup(wave_only=True)
    r.rk3_step(u, float(courant_dt(u, cfg)))
    assert r.executor.writes_in_place is (strategy == "s3")
    assert len(seen) == 3
    if strategy == "s3":
        assert all(b == r.executor.population_buffers for b in seen)
    else:
        assert seen == [None] * 3


def test_stub_gravity_families_share_one_parent_set(stub):
    """Gravity's two families read one parent set: written in place for
    the hydro region, copied by the gravity region (two tensors per
    stage)."""
    from repro_torch.configs.gravity import CONFIG_SMALL
    from repro_torch.core import GravityScenario
    from repro_torch.hydro.state import sedov_init
    from repro_torch.hydro.stepper import courant_dt

    u = sedov_init(CONFIG_SMALL.hydro, device=CPU).u
    r = _stub_runs(lambda: GravityScenario(CONFIG_SMALL), u,
                   float(courant_dt(u, CONFIG_SMALL.hydro)))
    assert r.executor.stats["static_parent_copies"] == 2 * 3 * 2


def test_stub_write_in_place_waits_and_reseeds_constant_parents(stub):
    """``population_buffers`` gives the region's static sets in request
    order; a constant parent is copied in once, and again only after
    other parents were copied over it."""
    n = 16
    exe = AggregationExecutor(lambda x, w, out=None: affine(x) * w[:, None],
                              AggregationConfig(strategy="s3",
                                                max_aggregated=8,
                                                launch_watermark=WM),
                              device=CPU)
    exe.warmup([((n, 2), torch.float32), ((n,), torch.float32)])
    w = torch.arange(float(n))
    ((x0, w0), (x1, w1)) = exe.population_buffers(
        [("region", (((n, 2), torch.float32), w))] * 2)
    assert x0 is not x1 and torch.equal(w0, w) and torch.equal(w1, w)
    x0.copy_(torch.ones(n, 2))
    fut = exe.submit_range((x0, w0), 0, n)
    exe.flush()
    assert torch.equal(fut.result(), affine(torch.ones(n, 2)) * w[:, None])
    assert exe.stats["static_parent_copies"] == 0
    w0.zero_()                      # the set's widths are not reseeded...
    ((again, w_again),) = exe.population_buffers(
        [("region", (((n, 2), torch.float32), w))])
    assert again is x0 and not w_again.any()
    fresh = (torch.zeros(n, 2), torch.ones(n))   # ...until a copy lands
    exe.submit_range(fresh, 0, n)
    exe.flush()
    assert exe.stats["static_parent_copies"] == 2
    ((_, w_again),) = exe.population_buffers(
        [("region", (((n, 2), torch.float32), w))])
    assert torch.equal(w_again, w)


def test_pool_total_dispatch_s_sums_every_executor():
    """``ExecutorPool.total_dispatch_s`` is the sum of the executors'
    ``dispatch_s`` after a wave, as the reference pool's is."""
    pool = ExecutorPool(3, device=CPU)
    exe = AggregationExecutor(affine, AggregationConfig(
        strategy="s2+s3", n_executors=3, max_aggregated=4,
        launch_watermark=WM), pool=pool, device=CPU)
    parent = torch.arange(22.0).reshape(11, 2)
    fut = exe.submit_range((parent,), 0, 11)
    exe.flush()
    assert torch.equal(fut.result(), affine(parent))
    per = [e.dispatch_s for e in pool.executors]
    assert all(s > 0 for s in per)
    assert pool.total_dispatch_s == sum(per)
    assert pool.total_launches == len(greedy_decomposition(
        11, AggregationConfig(max_aggregated=4).bucket_sizes()))
