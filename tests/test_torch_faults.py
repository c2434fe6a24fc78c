"""The port's fault injection and containment against the JAX reference, on
the CPU, at the executor level.

Every scenario of tests/test_faults.py runs through both executors with
the toy body ``x * 2 + 1`` on the same numpy-made inputs and the same
``FaultSpec``s: the failed task ids, the whole ``faults`` dict, the
breaker states, the injector's log, the launches and the bucket
histograms must be equal, and every survivor bit-equal to the port's
fault-free run (and to the reference's: ``x * 2 + 1`` rounds alike in
fp32).  The injector's pure-Python parts are held to the reference's
directly: ``FaultSpec`` validation, ``_coin``, the logs, schedule files
exchanged both ways, ``QuarantineList``.  Then the port's own hazards: a
guarded ring launch audited after its ring slots were written again (by
later waves or a compaction) still bisects on the inputs it launched with,
and a plain ``RuntimeError`` from a body is never taken for a fault.
"""
import time
from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AggregationConfig as JAggregationConfig  # noqa: E402
from repro.core import AggregationExecutor as JAggregationExecutor  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core.strategies.mixed import MixedStrategy as JMixedStrategy  # noqa: E402

from repro_torch.configs.base import AggregationConfig  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AggregationExecutor, FaultInjector, FaultSpec, QuarantineList,
    TaskFailedError, all_finite, gather_futures,
)
from repro_torch.core import faults  # noqa: E402
from repro_torch.core.faults import (  # noqa: E402
    LaunchFaultError, RegionFaultError, all_finite_async, poison_args,
    poison_slots,
)
from repro_torch.core.strategies.mixed import MixedStrategy  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _body(x):
    return x * 2.0 + 1.0


# ---------------------------------------------------------------------------
# the injector's pure-Python parts
# ---------------------------------------------------------------------------

BAD_SPECS = [
    dict(site="meteor"),
    dict(site="payload"),                       # needs task or rate
    dict(site="ring"),
    dict(site="payload", task=0, mode="explode"),
    dict(site="launch", mode="explode"),
    dict(site="launch"),
    dict(site="payload", task=0, rate=1.5),
    dict(site="payload", task=0, times=0),
]


@pytest.mark.parametrize("kw", BAD_SPECS, ids=lambda kw: str(sorted(kw)))
def test_fault_spec_validation_matches_reference(kw):
    with pytest.raises(Exception) as want:
        jfaults.FaultSpec(**kw)
    with pytest.raises(Exception) as got:
        FaultSpec(**kw)
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)


def test_fault_spec_valid_and_coin_equal_over_a_grid():
    FaultSpec(site="payload", task=3, mode="inf")
    FaultSpec(site="launch", mode="hang", bucket=8, times=2)
    for seed in (0, 7, 2 ** 31):
        for site in ("payload", "ring"):
            for kernel in ("k", "hydro_rhs", "decode"):
                for wave in (0, 1, 17):
                    for tid in (0, 5, 511):
                        key = (site, kernel, wave, tid)
                        assert faults._coin(seed, *key) == \
                            jfaults._coin(seed, *key)


def _drive_injector(inj):
    fired = []
    for wave in range(4):
        fired.append(inj.poison_positions("k", wave, list(range(8))))
        fired.append(inj.corrupt_ring("k", wave, wave + 1))
        fired.append(inj.compile_fails("k", 8 >> wave))
        fired.append(inj.launch_fault("k", 8))
    return fired, [tuple(e) for e in inj.log]


SCHEDULE = [
    dict(site="payload", rate=0.5, mode="nan"),
    dict(site="payload", kernel="k", task=2, mode="inf", times=1),
    dict(site="ring", rate=0.3),
    dict(site="compile", kernel="k", bucket=2),
    dict(site="launch", kernel="k", bucket=8, mode="fail", times=1),
    dict(site="launch", kernel="k", mode="delay", delay_s=0.0, times=2),
]


@pytest.mark.parametrize("seed", [0, 7, 11])
def test_injector_logs_equal_reference(seed):
    got = _drive_injector(FaultInjector(
        [FaultSpec(**d) for d in SCHEDULE], seed=seed))
    want = _drive_injector(jfaults.FaultInjector(
        [jfaults.FaultSpec(**d) for d in SCHEDULE], seed=seed))
    assert got == want and got[1]
    inj = FaultInjector([FaultSpec(site="payload", task=2, times=1)])
    assert inj.poison_positions("k", 0, [0, 1, 2, 3]) == {2: "nan"}
    assert inj.poison_positions("k", 1, [0, 1, 2, 3]) == {}     # spent


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_schedule_files_replay_across_packages(tmp_path, direction):
    specs = [dict(d) for d in SCHEDULE]
    src_mod, dst_mod = ((jfaults, faults) if direction == "jax_to_port"
                        else (faults, jfaults))
    src = src_mod.FaultInjector([src_mod.FaultSpec(**d) for d in specs],
                                seed=11)
    first = _drive_injector(src)
    path = src.save_schedule(str(tmp_path / "schedule.json"))
    replay = dst_mod.FaultInjector.from_schedule(path)
    assert replay.seed == 11
    assert [vars(s) for s in replay.specs] == [vars(s) for s in src.specs]
    assert _drive_injector(replay) == first


def test_quarantine_list_and_finite_helpers():
    for mod in (faults, jfaults):
        q = mod.QuarantineList(threshold=2)
        assert not q.record_offense(7)
        assert q.record_offense(7)
        assert not q.record_offense(7)            # already a member
        assert 7 in q and 8 not in q and q.as_stats() == [7]
    assert QuarantineList().threshold == jfaults.QuarantineList().threshold
    assert all_finite((torch.ones(3), torch.arange(3)))
    assert not all_finite(torch.tensor([1.0, float("nan")]))
    assert not all_finite([torch.ones(2), torch.tensor([float("inf")])])
    assert all_finite_async(torch.arange(3)) is True     # nothing checkable
    v = all_finite_async(torch.ones(4))
    assert isinstance(v, torch.Tensor) and v.dim() == 0 and bool(v)
    x = torch.ones(4, 2)
    y = poison_slots(x, [1, 3], {3: "inf"})
    assert torch.equal(x, torch.ones(4, 2))             # a copy by default
    assert torch.isnan(y[1]).all() and torch.isinf(y[3]).all()
    assert torch.equal(y[[0, 2]], x[[0, 2]])
    assert poison_slots(x, [0], inplace=True) is x and torch.isnan(x[0]).all()
    ints = torch.arange(4)
    assert poison_slots(ints, [1]) is ints
    a, b = poison_args((torch.ones(2), torch.arange(2)), "inf")
    assert torch.isinf(a).all() and torch.equal(b, torch.arange(2))


# ---------------------------------------------------------------------------
# every executor scenario of tests/test_faults.py, through both executors
# ---------------------------------------------------------------------------

def _spec(lib, d):
    return (FaultSpec if lib == "port" else jfaults.FaultSpec)(**d)


def _executor(lib, cap, guard, specs, seed=0, **cfg_kw):
    if lib == "port":
        cfg = AggregationConfig(max_aggregated=cap, guard=guard, **cfg_kw)
        inj = (FaultInjector([_spec(lib, d) for d in specs], seed=seed)
               if specs else None)
        exe = AggregationExecutor(None, cfg, device="cpu",
                                  fault_injector=inj)
    else:
        cfg = JAggregationConfig(max_aggregated=cap, guard=guard, **cfg_kw)
        inj = (jfaults.FaultInjector([_spec(lib, d) for d in specs],
                                     seed=seed) if specs else None)
        exe = JAggregationExecutor(None, cfg, fault_injector=inj)
    exe.register("k", _body)
    return exe, inj


def _parents(n, width=1):
    return (np.arange(n * width, dtype=np.float32).reshape(n, width) * 0.5,)


def _as_lib(lib, arrays):
    return tuple(torch.from_numpy(a.copy()) if lib == "port"
                 else jnp.asarray(a) for a in arrays)


def _survivors(fut, n):
    """{index: numpy result} of every task that did not fail."""
    bad = set(fut.failed_indices())
    return {i: np.asarray(fut.task_result(i)) for i in range(n)
            if i not in bad}


def _summary(lib, cap, guard, specs, waves, key="k[1]", per_task=False,
             seed=0, **cfg_kw):
    """Drive ``waves`` (wave sizes) through one executor of ``lib``; per
    wave the failed indices, the survivors and the breaker state; at the
    end the faults dict, launches, histograms, breaker states, the
    injector's log."""
    exe, inj = _executor(lib, cap, guard, specs, seed, **cfg_kw)
    per_wave = []
    for n in waves:
        if per_task:
            xs = [np.full((4,), float(i), np.float32) for i in range(n)]
            futs = [exe.submit(_as_lib(lib, (x,))[0], kernel="k")
                    for x in xs]
            exe.flush()
            failed = [i for i, f in enumerate(futs) if f.failed()]
            surv = {i: np.asarray(f.result()) for i, f in enumerate(futs)
                    if not f.failed()}
        else:
            fut = exe.submit_range(_as_lib(lib, _parents(n)), 0, n,
                                   kernel="k")
            exe.flush()
            failed = fut.failed_indices()
            surv = _survivors(fut, n)
        per_wave.append((failed, surv, exe.stats["regions"][key]["breaker"]))
    reg = exe.stats["regions"][key]
    return dict(per_wave=per_wave, faults=dict(reg["faults"]),
                launches=exe.stats["launches"],
                hist={int(k): v for k, v in
                      exe.stats["aggregated_hist"].items()},
                region_hist=dict(reg["aggregated_hist"]),
                breakers=exe.breaker_states(),
                log=[tuple(e) for e in inj.log] if inj is not None else [])


def _payload(task, mode="nan", **kw):
    return dict(site="payload", kernel="k", task=task, mode=mode, **kw)


SCENARIOS = {
    "single_nan_in_64_wave": dict(
        cap=64, guard="finite", specs=[_payload(17, times=1)], waves=[64]),
    "two_culprits": dict(
        cap=32, guard="finite",
        specs=[_payload(3, times=1), _payload(28, "inf", times=1)],
        waves=[32]),
    "range_result_culprit": dict(
        cap=16, guard="finite", specs=[_payload(5, times=1)], waves=[16]),
    "ring_corruption": dict(
        cap=8, guard="finite", per_task=True, key="k[4]",
        specs=[dict(site="ring", kernel="k", task=3, mode="nan")],
        waves=[8], launch_watermark=8),
    "untripped": dict(cap=32, guard="finite", specs=[], waves=[32, 20]),
    "compile_degrade": dict(
        cap=16, guard="off",
        specs=[dict(site="compile", kernel="k", bucket=16)],
        waves=[16, 16]),
    "transient_launch_fault": dict(
        cap=8, guard="off",
        specs=[dict(site="launch", kernel="k", bucket=8, mode="fail",
                    times=1)], waves=[8]),
    "persistent_launch_fault": dict(
        cap=4, guard="off", max_bucket_retries=1,
        specs=[dict(site="launch", kernel="k", mode="fail")], waves=[4]),
    "quarantine": dict(
        cap=16, guard="finite", quarantine_threshold=2,
        specs=[_payload(9)], waves=[16, 16, 16]),
    "armed_hang": dict(
        cap=8, guard="off", launch_timeout_s=0.05,
        specs=[dict(site="launch", kernel="k", bucket=8, mode="hang",
                    times=1)], waves=[8]),
    "persistent_hang_bans_rung": dict(
        cap=16, guard="off", launch_timeout_s=0.02,
        specs=[dict(site="launch", kernel="k", bucket=16, mode="hang")],
        waves=[16, 16]),
    "capped_backoff": dict(
        cap=8, guard="off", retry_backoff_s=0.2, retry_backoff_max_s=0.01,
        specs=[dict(site="launch", kernel="k", bucket=8, mode="fail",
                    times=2)], waves=[8]),
    "breaker_lifecycle": dict(
        cap=8, guard="finite", breaker_window=4, breaker_threshold=2,
        breaker_cooldown=2, specs=[_payload(1, times=3)], waves=[8] * 8),
    # the card's degraded-bucket check (chip_smoke.py, containment 4) at
    # the main path's wave and cap
    "degrade_at_cap_32": dict(
        cap=32, guard="off",
        specs=[dict(site="compile", kernel="k", bucket=32),
               dict(site="launch", kernel="k", bucket=16, mode="fail",
                    times=1)], waves=[512]),
    "rate_schedule": dict(
        cap=8, guard="finite", seed=5,
        specs=[dict(site="payload", kernel="k", rate=0.2, mode="inf")],
        waves=[24, 24, 24]),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_executor_scenario_equals_reference(name):
    case = dict(SCENARIOS[name])
    clean = {k: v for k, v in case.items() if k not in ("specs", "seed")}
    t0 = time.perf_counter()
    got = _summary("port", **case)
    elapsed = time.perf_counter() - t0
    want = _summary("jax", **case)
    ref = _summary("port", **dict(clean, specs=[], guard="off"))
    for key in ("faults", "launches", "hist", "region_hist", "breakers",
                "log"):
        assert got[key] == want[key], key
    for (g_failed, g_surv, g_br), (w_failed, w_surv, w_br), \
            (_, r_surv, _) in zip(got["per_wave"], want["per_wave"],
                                  ref["per_wave"]):
        assert g_failed == w_failed and g_br == w_br
        assert sorted(g_surv) == sorted(w_surv)
        for i, v in g_surv.items():
            np.testing.assert_array_equal(v, r_surv[i])   # port fault-free
            np.testing.assert_array_equal(v, w_surv[i])   # reference
    f = got["faults"]
    if name == "single_nan_in_64_wave":
        assert got["per_wave"][0][0] == [17]
        assert f["bisection_launches"] == 2 * 6 and got["hist"] == {64: 1}
    if name == "quarantine":
        assert 9 in f["quarantined"]
    if name == "capped_backoff":
        assert f["retries"] == 2 and elapsed < 0.3
    if name == "breaker_lifecycle":
        trace = [br for _, _, br in got["per_wave"]]
        assert {"open", "half_open", "closed"} <= set(trace)
        assert trace[-1] == "closed" and f["breaker_trips"] == 1
    if name == "degrade_at_cap_32":
        assert got["hist"] == {16: 32}
        assert (f["compile_failures"], f["launch_failures"], f["retries"],
                f["degraded_launches"]) == (1, 1, 1, 2)
    if name == "persistent_hang_bans_rung":
        assert f["timeouts"] == 3 and f["degraded_launches"] >= 2


def test_range_result_and_gather_raise_with_culprit_ids():
    exe, _ = _executor("port", 16, "finite", [_payload(5, times=1)])
    fut = exe.submit_range(_as_lib("port", _parents(16)), 0, 16, kernel="k")
    exe.flush()
    with pytest.raises(TaskFailedError) as exc:
        fut.result()
    assert exc.value.task_ids == (5,)
    with pytest.raises(TaskFailedError):
        gather_futures([fut])
    with pytest.raises(TaskFailedError) as one:
        fut.task_result(5)
    assert one.value.task_ids == (5,) and one.value.kernel == "k"
    assert fut.error(5) is one.value and fut.error() is one.value


def test_persistent_launch_fault_chains_the_dispatch_error():
    exe, _ = _executor("port", 4, "off",
                       [dict(site="launch", kernel="k", mode="fail")],
                       max_bucket_retries=1)
    fut = exe.submit_range(_as_lib("port", _parents(4)), 0, 4, kernel="k")
    exe.flush()
    assert fut.failed_indices() == [0, 1, 2, 3]
    assert isinstance(fut.error(0).__cause__, LaunchFaultError)


def test_disarmed_hang_raises_naming_the_budget():
    for lib in ("port", "jax"):
        exe, _ = _executor(lib, 8, "off", [dict(
            site="launch", kernel="k", bucket=8, mode="hang", times=1)])
        err = RegionFaultError if lib == "port" else jfaults.RegionFaultError
        with pytest.raises(err, match="launch_timeout_s"):
            exe.submit_range(_as_lib(lib, _parents(8)), 0, 8, kernel="k")
            exe.flush()


def test_breaker_open_pins_selection_and_mixed_route():
    states = {}
    for lib, mixed in (("port", MixedStrategy), ("jax", JMixedStrategy)):
        exe, _ = _executor(lib, 8, "finite", [_payload(0, times=1)],
                           breaker_window=4, breaker_threshold=1,
                           breaker_cooldown=3)
        exe.submit_range(_as_lib(lib, _parents(8)), 0, 8, kernel="k")
        exe.flush()
        ctx = SimpleNamespace(executor=exe, config=exe.config,
                              caches={("mixed_route", "k"): "fused"})
        states[lib] = (exe.breaker_state("k"), exe.select_strategy("k"),
                       mixed()._route("k", ctx),
                       ctx.caches[("mixed_route", "k")],
                       exe.breaker_state("nope"))
    assert states["port"] == states["jax"] == (
        "open", "s3", "s3", "fused", "closed")


def test_plain_runtime_error_propagates_unchanged():
    """A body that raises a plain RuntimeError (a build, load or launch
    error) under an armed guard and an attached injector is neither
    retried nor degraded nor counted: it surfaces as itself."""
    calls = []

    def broken(x):
        calls.append(x.shape[0])
        raise RuntimeError("CUDA error: an illegal memory access")

    cfg = AggregationConfig(max_aggregated=8, guard="finite",
                            launch_timeout_s=1.0, breaker_window=2,
                            breaker_threshold=1)
    inj = FaultInjector([FaultSpec(site="launch", kernel="k", bucket=4,
                                   mode="fail", times=1),
                         FaultSpec(site="payload", kernel="k", task=1)])
    exe = AggregationExecutor(None, cfg, device="cpu", fault_injector=inj)
    exe.register("k", broken)
    with pytest.raises(RuntimeError) as err:
        exe.submit_range(_as_lib("port", _parents(8)), 0, 8, kernel="k")
        exe.flush()
    assert type(err.value) is RuntimeError
    assert "illegal memory access" in str(err.value)
    assert calls == [8]                         # one attempt, no retry
    region = next(iter(exe.regions.values()))
    assert region.bad_buckets == set()
    f = exe.stats["regions"]["k[1]"]["faults"]
    assert all(v in (0, []) for v in f.values()), f
    assert exe.stats["launches"] == 0 and exe.breaker_states() == {
        "k": "closed"}


# ---------------------------------------------------------------------------
# the recovery property, on the port
# ---------------------------------------------------------------------------

@given(n1=st.integers(4, 24), n2=st.integers(4, 24),
       c1=st.integers(0, 23), c2=st.integers(0, 23),
       seed=st.integers(0, 10_000))
@settings(max_examples=10, deadline=None)
def test_recovery_property(n1, n2, c1, c2, seed):
    """For any injected schedule across two interleaved families: exactly
    the injected tasks fail, and every survivor is bit-identical to the
    family's fault-free fused result."""
    c1, c2 = c1 % n1, c2 % n2
    inj = FaultInjector([
        FaultSpec(site="payload", kernel="a", task=c1, mode="nan", times=1),
        FaultSpec(site="payload", kernel="b", task=c2, mode="inf", times=1),
    ], seed=seed)
    exe = AggregationExecutor(None, AggregationConfig(
        max_aggregated=16, guard="finite"), device="cpu", fault_injector=inj)
    exe.register("a", lambda x: x * 3.0 - 2.0)
    exe.register("b", lambda x: torch.sqrt(torch.abs(x)) + x)
    pa = torch.arange(n1 * 2, dtype=torch.float32).reshape(n1, 2) * 0.25
    pb = torch.arange(n2 * 3, dtype=torch.float32).reshape(n2, 3) * 0.125
    fa = exe.submit_range((pa,), 0, n1, kernel="a")
    fb = exe.submit_range((pb,), 0, n2, kernel="b")
    exe.flush()
    ref_a, ref_b = pa * 3.0 - 2.0, torch.sqrt(torch.abs(pb)) + pb
    assert fa.failed_indices() == [c1] and fb.failed_indices() == [c2]
    for i in range(n1):
        if i != c1:
            assert torch.equal(fa.task_result(i), ref_a[i])
    for i in range(n2):
        if i != c2:
            assert torch.equal(fb.task_result(i), ref_b[i])


# ---------------------------------------------------------------------------
# the port's ring hazard: in-place ring buffers under a late audit
# ---------------------------------------------------------------------------

def _per_task_ring_run(cfg_kw, specs, n, n_waves=1):
    """``n_waves`` x ``n`` per-task submissions (width 4), one flush at the
    end; returns (futures, inputs)."""
    cfg = AggregationConfig(guard="finite" if specs is not None else "off",
                            **cfg_kw)
    inj = FaultInjector(specs) if specs else None
    exe = AggregationExecutor(None, cfg, device="cpu", fault_injector=inj)
    exe.register("k", _body)
    rng = np.random.default_rng(3)
    xs = torch.from_numpy(rng.standard_normal((n_waves * n, 4)).astype(
        np.float32))
    futs = [exe.submit(x, kernel="k") for x in xs.unbind(0)]
    exe.flush()
    return exe, futs, xs


@pytest.mark.parametrize("case", ["ring_reused_by_later_waves",
                                  "compaction_before_audit"])
def test_guarded_ring_launch_bisects_its_own_inputs(case):
    """Guarded ring launches audited at one flush after the ring buffers
    were written again: by later waves (cap 8: a buffer comes round every
    other launch) or by a compaction (a ladder (1, 3) at cap 4 leaves a
    remainder queued at every launch).  Exactly the poisoned tasks fail;
    every survivor equals the body on its own input bit for bit."""
    if case == "ring_reused_by_later_waves":
        cfg_kw = dict(max_aggregated=8, launch_watermark=10 ** 9)
        # wave 0 task 5 (ring site) and wave 2 task 3 (payload)
        specs = [FaultSpec(site="ring", kernel="k", task=5, wave=0),
                 FaultSpec(site="payload", kernel="k", task=3, wave=2)]
        want_failed = [5, 19]
    else:
        cfg_kw = dict(max_aggregated=4, buckets=(1, 3),
                      launch_watermark=10 ** 9)
        specs = [FaultSpec(site="ring", kernel="k", task=4),
                 FaultSpec(site="payload", kernel="k", task=13)]
        want_failed = [4, 13]
    exe, futs, xs = _per_task_ring_run(cfg_kw, specs, 24)
    ring = exe.ring
    if case == "ring_reused_by_later_waves":
        assert ring.swaps >= 3 and exe.stats["regions"]["k[4]"][
            "queue_hist"] == {8: 3}
    else:
        assert ring.compactions >= 3
    assert [i for i, f in enumerate(futs) if f.failed()] == want_failed
    f = exe.stats["regions"]["k[4]"]["faults"]
    assert f["trips"] == 2 and f["failed_tasks"] == 2
    for i, fut in enumerate(futs):
        if i not in want_failed:
            assert torch.equal(fut.result(), _body(xs[i])), i
