"""The port's aggregation runtime (executors, aggregation executor,
scenario, strategies, runner) on the CPU, against the JAX reference where
the reference has the same function.

Within the port every strategy must equal ``fused`` bit for bit
(``torch.equal``): the CPU body is per-slot independent and the executors
run inline.  Across frameworks, the multi-step case is held allclose (the
tolerance is stated at the test).
"""
import ast
import collections
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import AggregationConfig as JAggregationConfig  # noqa: E402
from repro.configs.base import HydroConfig as JHydroConfig  # noqa: E402
from repro.core.aggregation import (  # noqa: E402
    greedy_decomposition as j_greedy_decomposition,
)
from repro.hydro import state as jstate  # noqa: E402
from repro.hydro import stepper as jstepper  # noqa: E402

from repro_torch.configs.base import (  # noqa: E402
    AggregationConfig, HydroConfig, validate_ladder,
)
from repro_torch.core import (  # noqa: E402
    AggregationExecutor, ExecutorPool, RangeFuture, SlotView, StrategyRunner,
    UniformSedovScenario, gather_futures, greedy_decomposition,
)
from repro_torch.hydro.state import (  # noqa: E402
    sedov_init, state_from_numpy, state_to_numpy,
)
from repro_torch.hydro.stepper import courant_dt, total_conserved  # noqa: E402
from repro_torch import sedov_blastwave  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CFG = HydroConfig(levels=1)          # 8 sub-grids of 8^3
JCFG = JHydroConfig(levels=1)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only adds contention here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _double(x):
    return x * 2.0


# ---------------------------------------------------------------------------
# bucket ladders and the greedy drain
# ---------------------------------------------------------------------------

LADDERS = [(1,), (1, 2), (1, 3, 7), (1, 2, 4, 8), (1, 2, 4, 8, 16, 32),
           (1, 5, 6, 64)]


def test_greedy_decomposition_matches_reference():
    ladders = LADDERS + [AggregationConfig(max_aggregated=c).bucket_sizes()
                         for c in (1, 2, 3, 5, 8, 32, 64, 512)]
    for ladder in ladders:
        for k in range(0, 130):
            assert greedy_decomposition(k, ladder) == \
                j_greedy_decomposition(k, ladder), (k, ladder)
    assert len(greedy_decomposition(512, (1, 2, 4, 8, 16, 32))) == 16


def test_ladders_match_reference():
    for cap in (1, 2, 3, 5, 8, 32, 512):
        assert AggregationConfig(max_aggregated=cap).bucket_sizes() == \
            JAggregationConfig(max_aggregated=cap).bucket_sizes()
    assert AggregationConfig(max_aggregated=8, buckets=(1, 3, 8)
                             ).bucket_sizes() == (1, 3, 8)
    for bad in [(2, 4), (1, 4, 2), (1, 1), (1, 16)]:
        with pytest.raises(ValueError, match="invalid bucket ladder"):
            validate_ladder(bad, 8)


@pytest.mark.parametrize("cap,buckets", [(1, ()), (2, ()), (3, ()),
                                         (8, ()), (32, ()), (5, (1, 3, 5))])
def test_range_launch_histogram_equals_greedy(cap, buckets):
    """One 8-task range drains in the reference's greedy buckets, in order,
    and reassembles to the whole-wave result."""
    agg = AggregationConfig(max_aggregated=cap, buckets=buckets)
    sizes = []

    def body(x):
        sizes.append(x.shape[0])
        return x * 2.0

    exe = AggregationExecutor(body, agg, device=CPU)
    parent = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    fut = exe.submit_range((parent,), 0, 8)
    exe.flush()
    want = j_greedy_decomposition(8, JAggregationConfig(
        max_aggregated=cap, buckets=buckets).bucket_sizes())
    assert tuple(sizes) == want
    assert exe.stats["aggregated_hist"] == dict(collections.Counter(want))
    assert exe.stats["launches"] == len(want)
    assert torch.equal(fut.result(), parent * 2.0)
    assert torch.equal(fut.task_result(5), parent[5] * 2.0)


def test_one_launch_range_result_is_the_launch_output():
    exe = AggregationExecutor(_double, AggregationConfig(max_aggregated=8),
                              device=CPU)
    parent = torch.ones(8, 2)
    fut = exe.submit_range((parent,), 0, 8)
    exe.flush()
    (seg,) = list(fut._segments())
    assert fut.result() is seg[0]


def test_indexed_submissions_gather_out_of_order_buckets():
    """Non-contiguous buckets go through one index_select; contiguous ones
    read a view of the parent.  (An idle executor drains each submission
    at once; the watermark holds them back to aggregate.)"""
    seen = []

    def body(x):
        seen.append(x)
        return x + 1.0

    exe = AggregationExecutor(body, AggregationConfig(
        max_aggregated=4, launch_watermark=10**9), device=CPU)
    parent = torch.arange(10, dtype=torch.float32).reshape(10, 1)
    order = [7, 2, 5, 1]
    futs = [exe.submit_indexed((parent,), i) for i in order]
    exe.flush()
    def shares_parent(x):
        return (x.untyped_storage().data_ptr()
                == parent.untyped_storage().data_ptr())

    assert len(seen) == 1 and not shares_parent(seen[0])  # gathered copy
    for i, f in zip(order, futs):
        assert torch.equal(f.result(), parent[i] + 1.0)
    assert torch.equal(gather_futures(futs), parent[order] + 1.0)
    seen.clear()
    for i in (3, 4):
        exe.submit(SlotView(parent, i))
    exe.flush()
    assert shares_parent(seen[0])                       # view, no copy


def test_gather_futures_mixes_ranges_and_tasks():
    exe = AggregationExecutor(_double, AggregationConfig(max_aggregated=4),
                              device=CPU)
    parent = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    r = exe.submit_range((parent,), 0, 3)
    t = exe.submit_indexed((parent,), 3)
    r2 = exe.submit_range((parent,), 4, 2)
    exe.flush()
    assert isinstance(r, RangeFuture) and len(r) == 3
    assert torch.equal(gather_futures([r, t, r2]), parent * 2.0)


def test_submissions_by_value_wait_in_roadmap():
    """Per-task tensors, once in ROADMAP.md, now go through the slot ring
    (tests/test_torch_staging.py holds the ring to the reference's); an
    out-of-bounds range still raises."""
    exe = AggregationExecutor(_double, device=CPU)
    f = exe.submit(torch.ones(3))
    exe.flush()
    assert torch.equal(f.result(), torch.full((3,), 2.0))
    assert exe.ring.writes == 1
    with pytest.raises(ValueError, match="out of bounds"):
        exe.submit_range((torch.ones(4, 1),), 2, 3)


def test_executor_pool_on_cpu_is_inline_and_round_robin():
    pool = ExecutorPool(3, device=CPU)
    for i in range(7):
        out = pool.get().launch(_double, torch.ones(2), family="f")
        assert torch.equal(out, torch.full((2,), 2.0))
    assert [e.launches for e in pool.executors] == [3, 2, 2]
    assert pool.launches_by_family == {"f": 7}
    assert pool.any_idle() and not any(e.busy() for e in pool.executors)
    pool.join()
    pool.drain()


# ---------------------------------------------------------------------------
# configs and devices
# ---------------------------------------------------------------------------

def test_unported_config_values_raise_naming_roadmap():
    # warm start and s4 are ported: they build, and s4 runs on the CPU
    for strategy in ("s4", "sharded"):
        AggregationConfig(strategy=strategy)
        StrategyRunner(UniformSedovScenario(CFG),
                       AggregationConfig(strategy=strategy), device="cpu")
    AggregationConfig(prior="roofline", tune_store="/nonexistent")
    with pytest.raises(ValueError, match="prior mode"):
        AggregationConfig(prior="bogus")
    # a mesh of 2 devices where the CPU is the one device
    with pytest.raises(ValueError, match=r"outside 1\.\.1"):
        StrategyRunner(UniformSedovScenario(CFG), AggregationConfig(
            strategy="s4", shard_devices=2), device="cpu")
    # containment is ported: the guard, the watchdog and the breakers build
    AggregationConfig(guard="finite", launch_timeout_s=1.0, breaker_window=2)
    with pytest.raises(ValueError, match="guard mode"):
        AggregationConfig(guard="paranoid")
    # strategy 1 is a config (16^3 sub-grids) under any strategy
    with pytest.raises(ValueError, match="CONFIG_16"):
        AggregationConfig(strategy="s1")
    # s2, mixed, host staging, fused stages and the tuning knobs are ported
    AggregationConfig(strategy="s2", staging="host", fuse_epilogue=True)
    AggregationConfig(strategy="mixed", autotune=True, cost_model=True,
                      flush_policy={"hydro_rhs": "cost"}, inner_chunk="auto",
                      family_strategies={"hydro_rhs": "s3"})
    with pytest.raises(ValueError, match="valid modes"):
        AggregationConfig(staging="pinned")
    with pytest.raises(ValueError, match="valid strategies"):
        StrategyRunner(UniformSedovScenario(CFG),
                       AggregationConfig(strategy="bogus"), device="cpu")


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StrategyRunner(UniformSedovScenario(CFG), AggregationConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sedov_init(CFG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        state_from_numpy(np.zeros((5, 2, 2, 2), np.float32))
    runner = StrategyRunner(UniformSedovScenario(CFG), AggregationConfig(),
                            device="cpu")
    assert runner.device == CPU
    with pytest.raises(ValueError, match="lives on"):
        runner.rhs(torch.zeros((5, 16, 16, 16), device="meta"))


# ---------------------------------------------------------------------------
# the main path: StrategyRunner under fused / s3 / s2+s3
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sedov_fused():
    """One RK3 step of the port's fused strategy on the CPU."""
    u0 = sedov_init(CFG, device="cpu").u
    dt = courant_dt(u0, CFG)
    runner = StrategyRunner(UniformSedovScenario(CFG),
                            AggregationConfig(strategy="fused"), device="cpu")
    return u0, dt, runner.rk3_step(u0, dt)


@pytest.mark.parametrize("strategy,cap,n_exec", [
    ("s3", 2, 1), ("s3", 8, 1), ("s2+s3", 4, 2)])
def test_strategies_bit_identical_to_fused(sedov_fused, strategy, cap,
                                           n_exec):
    u0, dt, want = sedov_fused
    agg = AggregationConfig(strategy=strategy, max_aggregated=cap,
                            n_executors=n_exec)
    runner = StrategyRunner(UniformSedovScenario(CFG), agg, device="cpu")
    runner.warmup()
    got = runner.rk3_step(u0, dt)
    assert torch.equal(got, want)
    per_stage = greedy_decomposition(CFG.n_subgrids, agg.bucket_sizes())
    assert runner.stats["kernel_launches"] == 3 * len(per_stage)
    (region,) = runner.stats["regions"].values()
    assert region["aggregated_hist"] == {
        k: 3 * v for k, v in collections.Counter(per_stage).items()}
    assert runner.pool.total_launches == 3 * len(per_stage)


@pytest.fixture(scope="module")
def jax_three_steps():
    """The reference's Sedov IC stepped 3 RK3 steps by
    ``repro.hydro.stepper.rk3_step``, with the dts it used."""
    u = jstate.sedov_init(JCFG).u
    u0 = np.asarray(u)
    dts = []
    for _ in range(3):
        dt = jstepper.courant_dt(u, JCFG)
        dts.append(np.float32(dt))
        u = jstepper.rk3_step(u, dt, JCFG)
    return u0, dts, np.asarray(u)


def test_port_s3_matches_reference_rk3(jax_three_steps):
    """The reference's state, carried across and stepped 3 RK3 steps by the
    port's s3 runner over the same dts.

    Tolerance: the per-stage RHS agrees to the kernel tolerance (2e-6 of
    scale); over 9 stages the float32 rounding of two frameworks' operation
    orders compounds, so the state is held at rtol=1e-5 with atol=1e-6 of
    its largest value (the blast energy).
    """
    u0, dts, want = jax_three_steps
    u = state_from_numpy(u0, "cpu")
    runner = StrategyRunner(UniformSedovScenario(CFG),
                            AggregationConfig(strategy="s3",
                                              max_aggregated=4),
                            device="cpu")
    for dt in dts:
        u = runner.rk3_step(u, torch.tensor(dt))
    got = state_to_numpy(u)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))
    h = CFG.domain / got.shape[-1]
    c0 = total_conserved(state_from_numpy(u0, "cpu"), h)
    c1 = total_conserved(u, h)
    assert abs(float((c1[0] - c0[0]) / c0[0])) < 1e-6      # mass
    assert abs(float((c1[4] - c0[4]) / c0[4])) < 1e-6      # energy


def test_sedov_blastwave_runs_on_cpu(capsys):
    sedov_blastwave.main(["--strategy", "s3", "--levels", "1", "--steps",
                          "1", "--device", "cpu", "--max-aggregated", "8"])
    out = capsys.readouterr().out
    assert "step 1:" in out and "mass drift" in out and "on cpu" in out


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules "
        "if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert "repro_torch" in roots
    assert not roots & {"jax", "jaxlib", "repro"}
