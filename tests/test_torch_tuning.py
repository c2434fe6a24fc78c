"""The port's measured tuning against the JAX reference, on the CPU: the
ladder derivation, the cost model, the flush policies, the strategy
selection, ``inner_chunk`` and the public region API.

The pure functions get the same seeded random histograms, sample tables,
caps and budgets on both sides and must give identical output.  The
executors get the same submissions; where the reference's decision rests
on measured times, both are fed the same known times (the port through an
injected timer, the reference through its cost model's ``record``), so no
test is decided by a clock.  The reference's executors dispatch
asynchronously, so an executor may still be busy when the next submission
arrives; the tests pin its pool idle, as the port's CPU executors always
are, so both see the same launch criterion.
"""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AggregationConfig as JAggregationConfig  # noqa: E402
from repro.configs.base import resolve_family_option as jresolve  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402

from repro_torch.configs.base import (  # noqa: E402
    AggregationConfig, HydroConfig, resolve_family_option,
)
from repro_torch.core import aggregation as agg  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AggregationExecutor, BucketCostModel, StrategyRunner,
    UniformSedovScenario, aggregation_region, reset_regions,
)
from repro_torch.hydro.state import extract_subgrids, sedov_init  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only adds contention here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def affine(x, out=None):
    r = 2.0 * x + 1.0
    return r if out is None else out.copy_(r)


def jaffine(x):
    return 2.0 * x + 1.0


def jexecutor(cfg):
    """A reference executor on an always-idle pool."""
    exe = jagg.AggregationExecutor(jax.vmap(jaffine), cfg)
    exe.pool.any_idle = lambda: True
    return exe


def random_hist(rng, cap):
    return {int(k): int(rng.integers(1, 6))
            for k in rng.integers(1, 3 * cap, size=rng.integers(1, 5))}


def random_model(rng, cls, paths=("s3", "s2", "fused")):
    """The same seeded sample table in a model of class ``cls``."""
    model = cls()
    r = random.Random(int(rng.integers(1 << 30)))
    for path in paths:
        for b in r.sample(range(1, 80), r.randint(1, 6)):
            for _ in range(r.randint(1, 3)):
                model.record(b, r.uniform(1e-4, 1e-2), path=path)
    return model


# ---------------------------------------------------------------------------
# pure functions: identical output on seeded inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_ladder_functions_equal_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        cap = int(rng.integers(1, 70))
        budget = int(rng.integers(1, 7))
        hist = random_hist(rng, cap)
        assert agg.ladder_candidates(hist, cap) == \
            jagg.ladder_candidates(hist, cap)
        assert agg.derive_ladder(hist, cap, budget) == \
            jagg.derive_ladder(hist, cap, budget)
        ladder = agg.derive_ladder(hist, cap, budget)
        assert 1 in ladder and len(ladder) <= max(budget, 1)
        for k in hist:
            assert agg.greedy_launches(k, ladder) == \
                jagg.greedy_launches(k, ladder)
            assert agg.greedy_decomposition(k, ladder) == \
                jagg.greedy_decomposition(k, ladder)
        wave = int(rng.integers(1, 600))
        assert agg.s2_width_candidates(wave) == \
            jagg.s2_width_candidates(wave)


@pytest.mark.parametrize("seed", range(6))
def test_cost_model_predictions_and_ladders_equal_reference(seed):
    rng = np.random.default_rng(100 + seed)
    state = rng.bit_generator.state
    mine = random_model(rng, BucketCostModel)
    rng.bit_generator.state = state
    ref = random_model(rng, jagg.BucketCostModel)
    for path in ("s3", "s2", "fused"):
        assert mine.buckets(path) == ref.buckets(path)
        assert mine.as_stats(path) == ref.as_stats(path)
        for b in range(1, 130):
            assert mine.predict(b, path) == ref.predict(b, path)
        seq = [int(x) for x in rng.integers(1, 90, size=5)]
        assert mine.predict_seq(seq, path) == ref.predict_seq(seq, path)
    for wave in range(0, 200, 7):
        assert mine.predict_s2_wave(wave) == ref.predict_s2_wave(wave)
    for _ in range(10):
        cap = int(rng.integers(2, 70))
        budget = int(rng.integers(1, 6))
        hist = random_hist(rng, cap)
        assert agg.derive_ladder(hist, cap, budget, mine) == \
            jagg.derive_ladder(hist, cap, budget, ref)
    # priors answer only for a path without samples, counted alike
    for model in (mine, ref):
        model.seed_prior(4, 2e-3, path="s4")
        model.seed_prior(16, 5e-3, path="s4")
    assert mine.predict(9, "s4") == ref.predict(9, "s4")
    assert mine.prior_hits == ref.prior_hits == 1
    assert mine.sources() == ref.sources()
    with pytest.raises(ValueError, match="no measurements"):
        BucketCostModel().predict(3)


def test_resolve_family_option_equals_reference():
    cases = [None, "cost", {"k": "watermark", "*": "eager"},
             {"hydro_rhs": "s2"}, {"*": "fused"}, {}]
    for value in cases:
        for kernel in ("k", "hydro_rhs", "hydro_rhs+epi", "gravity", "k+epi"):
            assert resolve_family_option(value, kernel, "dflt") == \
                jresolve(value, kernel, "dflt")


# ---------------------------------------------------------------------------
# executors fed the same submissions
# ---------------------------------------------------------------------------

def _waves(seed, n_waves, n_parent):
    """Per wave, a list of ("range", start, n) / ("task", i) submissions."""
    rng = random.Random(seed)
    waves = []
    for _ in range(n_waves):
        subs, i = [], 0
        end = rng.randint(1, n_parent)
        while i < end:
            span = rng.randint(1, end - i)
            if span > 1 and rng.random() < 0.6:
                subs.append(("range", i, span))
            else:
                subs.append(("task", i))
                span = 1
            i += span
        waves.append(subs)
    return waves


def _drive(exe, parent, waves, submit_range, submit_task, flush):
    outs = []
    for subs in waves:
        futs = []
        for sub in subs:
            if sub[0] == "range":
                futs.append(submit_range(exe, parent, sub[1], sub[2]))
            else:
                futs.append(submit_task(exe, parent, sub[1]))
        flush(exe)
        outs.append(futs)
    return outs


def _port_run(cfg, parent, waves, timer=None):
    exe = AggregationExecutor(affine, cfg, device="cpu", timer=timer)
    outs = _drive(exe, parent, waves,
                  lambda e, p, s, n: e.submit_range((p,), s, n),
                  lambda e, p, i: e.submit_indexed((p,), i),
                  lambda e: e.flush())
    return exe, outs


def _jax_run(cfg, parent, waves, prepare=None):
    exe = jexecutor(cfg)
    if prepare is not None:
        prepare(exe)
    outs = _drive(exe, parent, waves,
                  lambda e, p, s, n: e.submit_range((p,), s, n),
                  lambda e, p, i: e.submit_indexed((p,), i),
                  lambda e: e.flush())
    return exe, outs


def _region_stats(exe):
    (st,) = exe.stats["regions"].values()
    return st


@pytest.mark.parametrize("seed", range(4))
def test_autotune_by_launch_count_derives_the_reference_ladder(seed):
    """Autotune without the cost model: the same waves give the same queue
    histogram, ladder and launch histograms as the reference executor,
    and the results stay exact."""
    n_parent, cap = 40, 16
    parent = np.arange(n_parent * 2, dtype=np.float32).reshape(n_parent, 2)
    waves = _waves(seed, 5, n_parent)
    kw = dict(strategy="s3", max_aggregated=cap, autotune=True,
              autotune_warmup=2, compile_budget=3)
    exe, outs = _port_run(AggregationConfig(**kw), torch.from_numpy(parent),
                          waves)
    jexe, _ = _jax_run(JAggregationConfig(**kw), jnp.asarray(parent), waves)
    mine, ref = _region_stats(exe), _region_stats(jexe)
    for key in ("queue_hist", "ladder", "aggregated_hist", "launches",
                "submitted", "tuned_by"):
        assert mine.get(key) == ref.get(key), key
    assert exe.stats["aggregated_hist"] == jexe.stats["aggregated_hist"]
    want = torch.from_numpy(2.0 * parent + 1.0)
    for subs, futs in zip(waves, outs):
        for sub, f in zip(subs, futs):
            got = f.result() if sub[0] == "range" else f.result()[None]
            i = sub[1]
            assert torch.equal(got, want[i:i + got.shape[0]])


def fake_timer(table):
    """A timer that runs the launch and reports ``table[path](size)``
    seconds: known times, no clock."""
    def timer(fn, device, path, size):
        fn()
        return table[path](size)
    return timer


TIMES = {"s3": lambda b: 1e-3 * (1.0 + 0.02 * b),
         "s2": lambda w: 1e-3 * (1.0 + 0.5 * w),
         "fused": lambda n: 1e-3 * (2.0 + 0.05 * n),
         "chunk": lambda c: 1e-3 * {0: 3.0, 2: 2.0, 4: 1.0, 8: 1.5}[c]}


def _record_like_port(jexe, port_exe):
    """Copy the port's measured tables into the reference's region."""
    (jregion,) = jexe.regions.values()
    (region,) = port_exe.regions.values()
    for path in region.cost.paths():
        for b in region.cost.buckets(path):
            for t in region.cost._paths[path][b]:
                jregion.cost.record(b, t, path=path)


@pytest.mark.parametrize("policy", ["watermark", "cost"])
@pytest.mark.parametrize("seed", range(3))
def test_flush_policies_decide_as_the_reference(policy, seed):
    """With the same known times, the adaptive flush policies make the
    same decisions (``flush_decisions``) and launches as the reference
    executor over the same submissions, and the results stay exact."""
    n_parent, cap = 24, 8
    parent = np.arange(n_parent * 3, dtype=np.float32).reshape(n_parent, 3)
    waves = _waves(50 + seed, 4, n_parent)
    kw = dict(strategy="s3", max_aggregated=cap, launch_watermark=1,
              flush_policy=policy)
    exe = AggregationExecutor(affine, AggregationConfig(cost_model=True,
                                                        **kw),
                              device="cpu", timer=fake_timer(TIMES))
    exe.warmup([((n_parent, 3), torch.float32)])
    (region,) = exe.regions.values()
    assert region.cost.as_stats() == {
        b: round(TIMES["s3"](b) * 1e3, 4) for b in region.buckets}
    tp = torch.from_numpy(parent)
    outs = _drive(exe, tp, waves,
                  lambda e, p, s, n: e.submit_range((p,), s, n),
                  lambda e, p, i: e.submit_indexed((p,), i),
                  lambda e: e.flush())
    jexe, _ = _jax_run(JAggregationConfig(**kw), jnp.asarray(parent), waves,
                       prepare=lambda j: (
                           j.warmup(parent_shapes=(jnp.zeros((n_parent, 3)),)),
                           _record_like_port(j, exe)))
    mine, ref = _region_stats(exe), _region_stats(jexe)
    assert mine["flush_decisions"] == ref["flush_decisions"]
    assert mine["aggregated_hist"] == ref["aggregated_hist"]
    assert mine["queue_hist"] == ref["queue_hist"]
    assert exe.stats["flush_policy"] == policy
    want = 2.0 * tp + 1.0
    for subs, futs in zip(waves, outs):
        for sub, f in zip(subs, futs):
            got = f.result() if sub[0] == "range" else f.result()[None]
            assert torch.equal(got, want[sub[1]:sub[1] + got.shape[0]])


def test_cost_policy_follows_the_model():
    """The reference's own cases: "cost" drains early exactly when the
    model says the split beats the one-shot wave."""
    parent = torch.arange(16.0).reshape(8, 2)
    exe = AggregationExecutor(affine, AggregationConfig(
        max_aggregated=32, flush_policy="cost"), device="cpu")
    exe.submit_range((parent,), 0, 8)
    exe.flush()
    (region,) = exe.regions.values()
    assert exe._idle_drain_pays(region, 4)       # no model yet: eager
    for b in (1, 2, 4, 8):
        region.cost.record(b, 1.0 + 0.01 * b)
    assert not exe._idle_drain_pays(region, 4)
    assert exe._idle_drain_pays(region, 8)
    region.cost.clear()
    for b, t in ((1, 1.0), (4, 4.0), (8, 100.0)):
        region.cost.record(b, t)
    assert exe._idle_drain_pays(region, 4)


def test_per_family_flush_policy_is_resolved_and_traced():
    exe = AggregationExecutor(affine, AggregationConfig(
        max_aggregated=32, flush_policy={"k": "watermark", "*": "eager"}),
        device="cpu", name="k")
    exe.register("other", affine)
    pa, pb = torch.ones(6, 2), torch.ones(5, 3)
    for _ in range(2):
        exe.submit_range((pa,), 0, 6, kernel="k")
        exe.submit_range((pb,), 0, 5, kernel="other")
        exe.flush()
    traced = {k.split("[")[0]: v.get("flush_decisions")
              for k, v in exe.stats["regions"].items()}
    assert traced["other"] is None
    assert traced["k"]["policy"] == "watermark" and traced["k"]["consulted"]
    with pytest.raises(ValueError, match="eager, watermark, cost"):
        AggregationConfig(flush_policy={"k": "bogus"})


def test_select_strategy_picks_the_reference_route():
    """The same measured s3, s2 and fused tables give the same strategy
    costs and the same route as the reference executor."""
    n = 24
    for times in (TIMES, dict(TIMES, s3=lambda b: 1e-3 * (5.0 + b)),
                  dict(TIMES, fused=lambda w: 1e-4 * w,
                       s3=lambda b: 1e-2 * b)):
        exe = AggregationExecutor(affine, AggregationConfig(
            max_aggregated=8, cost_model=True), device="cpu",
            timer=fake_timer(times))
        exe.warmup([((n, 2), torch.float32)])
        jexe = jexecutor(JAggregationConfig(max_aggregated=8))
        jexe.warmup(parent_shapes=(jnp.zeros((n, 2)),))
        _record_like_port(jexe, exe)
        assert exe.strategy_costs("region") == jexe.strategy_costs("region")
        assert exe.select_strategy("region") == jexe.select_strategy("region")
        st = _region_stats(exe)
        assert st["selected_strategy"] == _region_stats(jexe)[
            "selected_strategy"]
        assert st["strategy_costs"] == _region_stats(jexe)["strategy_costs"]


def test_measured_autotune_uses_the_timer_and_keeps_results():
    """cost_model=True: warmup and retune time buckets with the injected
    timer (the table holds its times), the derived ladder minimizes the
    predicted time as the reference's derivation does on the same table,
    and every wave's result stays exact."""
    parent = torch.arange(60.0).reshape(30, 2)
    cfg = AggregationConfig(max_aggregated=16, autotune=True,
                            autotune_warmup=1, cost_model=True,
                            compile_budget=3)
    exe = AggregationExecutor(affine, cfg, device="cpu",
                              timer=fake_timer(TIMES))
    exe.warmup([((30, 2), torch.float32)])
    for _ in range(2):
        f = exe.submit_range((parent,), 0, 30)
        exe.flush()
        assert torch.equal(f.result(), 2.0 * parent + 1.0)
    st = _region_stats(exe)
    assert st["tuned_by"] == "measured"
    ref_model = jagg.BucketCostModel()
    (region,) = exe.regions.values()
    for b in region.cost.buckets():
        ref_model.record(b, TIMES["s3"](b))
    assert tuple(st["ladder"]) == jagg.derive_ladder(
        st["queue_hist"], 16, 3, ref_model)
    assert st["measurement_launches"] > 0
    assert exe.retune() == {next(iter(exe.stats["regions"])):
                            tuple(st["ladder"])}


# ---------------------------------------------------------------------------
# inner_chunk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [1, 3, 7])
def test_inner_chunk_bit_equal_to_flat(chunk):
    """A 21-slot bucket of the hydro body as sequential chunk launches
    (through ``out=``) equals the flat launch bit for bit, directly and
    through the executor; the s2 scatter's ``out=`` path too."""
    cfg = HydroConfig(levels=2, subgrid=4)
    subs = extract_subgrids(sedov_init(cfg, device="cpu").u, 4, 3)[:21]
    body = ops.hydro_batched_body(cfg, 1.0 / 16)
    flat = body(subs)
    assert torch.equal(agg._chunked_eval(body, chunk, subs), flat)
    out = torch.empty_like(flat)
    assert agg._chunked_eval(body, chunk, subs, out=out) is out
    assert torch.equal(out, flat)
    exe = AggregationExecutor(body, AggregationConfig(
        max_aggregated=21, buckets=(1, 21), inner_chunk=chunk), device="cpu")
    f = exe.submit_range((subs,), 0, 21)
    exe.flush()
    assert torch.equal(f.result(), flat)
    # 5 does not divide 21: the flat call
    assert torch.equal(agg._chunked_eval(body, 5, subs), flat)


def test_inner_chunk_auto_is_timed_and_memoized():
    """``inner_chunk="auto"`` keeps the fastest timed chunk (4 here) and
    the results stay exact; a second executor with the same timer and
    body reads the memo."""
    body = ops.hydro_batched_body(HydroConfig(levels=1, subgrid=4), 0.125)
    subs = extract_subgrids(sedov_init(HydroConfig(levels=1, subgrid=4),
                                       device="cpu").u, 4, 3)
    timer = fake_timer(TIMES)
    cfg = AggregationConfig(max_aggregated=8, inner_chunk="auto")
    exe = AggregationExecutor(body, cfg, device="cpu", timer=timer)
    exe.warmup([(tuple(subs.shape), torch.float32)])
    st = _region_stats(exe)
    assert st["inner_chunk"] == 4 and st["measurement_launches"] > 0
    f = exe.submit_range((subs,), 0, 8)
    exe.flush()
    assert torch.equal(f.result(), body(subs))
    again = AggregationExecutor(body, cfg, device="cpu", timer=timer)
    again.warmup([(tuple(subs.shape), torch.float32)])
    st2 = _region_stats(again)
    assert st2["inner_chunk"] == 4 and st2["measurement_launches"] == 0


# ---------------------------------------------------------------------------
# s2 width, runner warmup and the public surface
# ---------------------------------------------------------------------------

def test_s2_measured_width_bit_equal_to_width_one():
    """``s2`` under cost_model=True takes the width its timer finds
    cheapest per wave (here the widest), launches that width over the
    divisible span, and equals ``fused`` bit for bit."""
    cfg = HydroConfig(levels=1)
    u = sedov_init(cfg, device="cpu").u
    ref = StrategyRunner(UniformSedovScenario(cfg), AggregationConfig(
        strategy="fused"), device="cpu").rk3_step(u, 1e-4)
    times = dict(TIMES, s2=lambda w: 1e-3 * (1.0 + 0.01 * w))
    r = StrategyRunner(UniformSedovScenario(cfg), AggregationConfig(
        strategy="s2", cost_model=True), device="cpu",
        timer=fake_timer(times))
    assert torch.equal(r.rk3_step(u, 1e-4), ref)
    (st,) = r.stats["regions"].values()
    assert st["s2_width"] == 8 and st["aggregated_hist"] == {8: 3}
    assert st["cost_model_paths"]["s2"] == {
        w: round(times["s2"](w) * 1e3, 4) for w in (1, 2, 8)}


def test_runner_warmup_wave_only_times_the_wave_buckets():
    cfg = HydroConfig(levels=1)
    agg_cfg = AggregationConfig(max_aggregated=32, cost_model=True,
                                family_strategies={"*": "s3"})
    r = StrategyRunner(UniformSedovScenario(cfg), agg_cfg, device="cpu",
                       timer=fake_timer(TIMES))
    r.warmup(wave_only=True)
    (st,) = r.stats["regions"].values()
    assert set(st["cost_model"]) == {8}          # the 8-task wave's bucket
    assert "cost_model_paths" not in st          # an explicit route probes
    with pytest.raises(ValueError, match="names no kernel family"):
        StrategyRunner(UniformSedovScenario(cfg), AggregationConfig(
            strategy="mixed", family_strategies={"gravity": "s2"}),
            device="cpu")


def test_aggregation_region_and_map():
    """The paper's named region: one executor per name, until reset;
    ``map`` returns the results in order, equal to the reference's."""
    reset_regions()
    a = aggregation_region("affine", affine, device="cpu")
    assert aggregation_region("affine", None) is a
    xs = [torch.full((3,), float(i)) for i in range(5)]
    got = a.map([(x,) for x in xs])
    ref = jagg.AggregationExecutor(jax.vmap(jaffine), JAggregationConfig())
    want = ref.map([(jnp.asarray(x.numpy()),) for x in xs])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    reset_regions()
    assert aggregation_region("affine", affine, device="cpu") is not a
    reset_regions()


def test_launch_timer_on_the_cpu_counts_one_call():
    calls = []
    timer = agg.LaunchTimer(reps=5)
    t = timer(lambda: calls.append(1), CPU, "s3", 1)
    assert t >= 0 and calls == [1]
    assert timer.launches_per_sample(CPU) == 1
    with pytest.raises(ValueError, match="reps"):
        agg.LaunchTimer(reps=0)
