"""The port's ``s2`` strategy (one launch per task into an output ring) on
the CPU, against the JAX reference's ``fused`` path.

The reference's own ``s2`` is not the yardstick: its scatter ring is not
bit-identical to its ``fused`` path on XLA:CPU (ROADMAP.md, Queue 3).  So
the port's ``s2`` is held to the JAX ``fused`` RK3 step within the
tolerance the port's s3 is held to (tests/test_torch_runtime.py: rtol
1e-5, atol 1e-6 of the largest value, the kernel tolerance compounded over
three stages), and to the port's own ``fused`` bit for bit.  Every output
ring starts NaN-filled, so a slot left unwritten would show.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs import amr_sedov as jamr_configs  # noqa: E402
from repro.configs.base import AggregationConfig as JAggregationConfig  # noqa: E402
from repro.configs.base import HydroConfig as JHydroConfig  # noqa: E402
from repro.configs.gravity import CONFIG_SMALL as JGCFG  # noqa: E402
from repro.core import AMRSedovScenario as JAMRSedovScenario  # noqa: E402
from repro.core import GravityScenario as JGravityScenario  # noqa: E402
from repro.core import StrategyRunner as JStrategyRunner  # noqa: E402
from repro.core import UniformSedovScenario as JUniformSedovScenario  # noqa: E402

from repro_torch import sedov_blastwave  # noqa: E402
from repro_torch.configs.amr_sedov import CONFIG as ACFG  # noqa: E402
from repro_torch.configs.amr_sedov import CONFIG_MIXED  # noqa: E402
from repro_torch.configs.base import AggregationConfig, HydroConfig  # noqa: E402
from repro_torch.configs.gravity import CONFIG_SMALL as GCFG  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AMRSedovScenario, ExecutorPool, GravityScenario, StrategyRunner,
    UniformSedovScenario, make_s2_scatter,
)
from repro_torch.core.strategies.base import RunContext  # noqa: E402
from repro_torch.core.strategies.s2 import S2Strategy  # noqa: E402
from repro_torch.hydro.state import amr_sedov_init, sedov_init  # noqa: E402
from repro_torch.hydro.stepper import amr_courant_dt, courant_dt  # noqa: E402

CFG = HydroConfig(levels=1)          # 8 sub-grids of 8^3
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only adds contention here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy(state):
    if isinstance(state, tuple):
        return tuple(np.asarray(x) for x in state)
    return (np.asarray(state),)


def _case(name):
    """(port scenario, JAX scenario, port state, JAX state, dt as float32,
    tasks per family and iteration)."""
    if name == "uniform":
        u = sedov_init(CFG, device="cpu").u
        dt = np.float32(courant_dt(u, CFG))
        return (UniformSedovScenario(CFG),
                JUniformSedovScenario(JHydroConfig(levels=1)), u,
                jnp.asarray(u.numpy()), dt, {"hydro_rhs": 8})
    if name == "gravity":
        u = sedov_init(GCFG.hydro, device="cpu").u
        dt = np.float32(courant_dt(u, GCFG.hydro))
        return (GravityScenario(GCFG), JGravityScenario(JGCFG), u,
                jnp.asarray(u.numpy()), dt, {"hydro_rhs": 8, "gravity": 8})
    cfg, jcfg = ((ACFG, jamr_configs.CONFIG) if name == "amr"
                 else (CONFIG_MIXED, jamr_configs.CONFIG_MIXED))
    st = amr_sedov_init(cfg, device="cpu")
    dt = np.float32(amr_courant_dt(st.uc, st.uf, cfg))
    tasks = {}
    for s, n in ((cfg.coarse_subgrid, cfg.n_subgrids_coarse),
                 (cfg.fine_subgrid, cfg.n_subgrids_fine)):
        tasks[f"hydro_rhs_s{s}"] = tasks.get(f"hydro_rhs_s{s}", 0) + n
    return (AMRSedovScenario(cfg), JAMRSedovScenario(jcfg), (st.uc, st.uf),
            (jnp.asarray(st.uc.numpy()), jnp.asarray(st.uf.numpy())), dt,
            tasks)


@pytest.mark.parametrize("case", ["uniform", "gravity", "amr", "amr_mixed"])
def test_s2_matches_reference_fused_and_port_fused(case):
    """One RK3 step under ``s2`` on 3 executors: bit-identical to the
    port's ``fused``, allclose to the reference's ``fused``, 3 launches per
    task and step in every family, and the family stats published."""
    sc, jsc, state, jstate, dt, tasks = _case(case)
    fused = StrategyRunner(sc, AggregationConfig(strategy="fused"),
                           device="cpu").rk3_step(state, torch.tensor(dt))
    runner = StrategyRunner(sc, AggregationConfig(strategy="s2",
                                                  n_executors=3),
                            device="cpu")
    got = runner.rk3_step(state, torch.tensor(dt))
    want = JStrategyRunner(jsc, JAggregationConfig(strategy="fused")
                           ).rk3_step(jstate, dt)
    for g, f, w in zip(_numpy(got), _numpy(fused), _numpy(want)):
        assert np.isfinite(g).all()
        np.testing.assert_array_equal(g, f)
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(w).max()))
    want_launches = {k: 3 * n for k, n in tasks.items()}
    assert runner.launches_by_family == want_launches
    assert runner.stats["kernel_launches"] == sum(want_launches.values())
    regions = runner.stats["regions"]
    assert {d.split("[")[0] for d in regions} == set(tasks)
    for desc, st in regions.items():
        n = 3 * tasks[desc.split("[")[0]]
        assert st["selected_strategy"] == "s2" and st["s2_width"] == 1
        assert st["launches"] == st["submitted"] == n
        assert st["aggregated_hist"] == {1: n}


def test_s2_family_keys_are_the_executors():
    """``s2`` publishes its stats under the family keys the aggregation
    executor uses, so s2 and s3 rows compare family by family."""
    sc = GravityScenario(GCFG)
    u = sedov_init(GCFG.hydro, device="cpu").u
    keys = {}
    for strategy in ("s2", "s3"):
        r = StrategyRunner(sc, AggregationConfig(strategy=strategy),
                           device="cpu")
        r.rhs(u)
        keys[strategy] = set(r.stats["regions"])
    assert keys["s2"] == keys["s3"] and len(keys["s2"]) == 2


def test_output_ring_starts_nan_filled():
    """A body that writes nothing leaves the whole ring NaN: the ring is
    not reused from an earlier launch and holds no stale values."""
    sc = UniformSedovScenario(CFG)
    pop = sc.populations(sedov_init(CFG, device="cpu").u)[0]

    def ctx():                            # one run's context, plans and all
        return RunContext(AggregationConfig(strategy="s2"),
                          ExecutorPool(2, device=CPU), None,
                          {"kernel_launches": 0, "regions": {}})

    ring = S2Strategy().launch_population(sc, pop, ctx())
    assert ring.shape == (8, 5, 8, 8, 8) and torch.isfinite(ring).all()

    def silent(u, out=None):
        return torch.empty(u.shape[0], 5, 8, 8, 8, device=u.device) \
            if out is None else out

    ring = S2Strategy().launch_population(
        UniformSedovScenario(CFG, batched_body=silent), pop, ctx())
    assert torch.isnan(ring).all()


@pytest.mark.parametrize("width", [1, 2, 4])
def test_scatter_writes_its_slice_only(width):
    parents = (torch.arange(24.0).reshape(8, 3), torch.ones(8))

    def body(x, y, out=None):
        return out.copy_(2.0 * x + y[:, None])

    ring = torch.full((8, 3), float("nan"))
    scatter = make_s2_scatter(body, width)
    dst = scatter(ring, 4, *parents)
    assert dst.data_ptr() == ring[4].data_ptr()
    assert torch.equal(ring[4:4 + width], 2.0 * parents[0][4:4 + width] + 1)
    assert torch.isnan(ring[:4]).all() and torch.isnan(ring[4 + width:]).all()


def test_s2_with_fuse_epilogue_takes_the_generic_path():
    """``s2`` has no ``run_stage``: ``fuse_epilogue`` is declined at
    construction and the step equals plain ``s2``."""
    u = sedov_init(CFG, device="cpu").u
    dt = courant_dt(u, CFG)
    plain = StrategyRunner(UniformSedovScenario(CFG),
                           AggregationConfig(strategy="s2"), device="cpu")
    fused = StrategyRunner(UniformSedovScenario(CFG), AggregationConfig(
        strategy="s2", fuse_epilogue=True), device="cpu")
    assert not fused.fuse_epilogue
    assert torch.equal(fused.rk3_step(u, dt), plain.rk3_step(u, dt))
    assert fused.launches_by_family == {"hydro_rhs": 24}


def test_sedov_blastwave_runs_s2_on_cpu(capsys):
    sedov_blastwave.main(["--strategy", "s2", "--levels", "1", "--steps",
                          "1", "--device", "cpu", "--executors", "2"])
    out = capsys.readouterr().out
    assert "strategy=s2" in out and "(24 launches total)" in out
