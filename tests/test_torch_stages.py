"""The port's epilogue-fused RK stages (``fuse_epilogue``) on the CPU, for
the uniform, gravity and two-level AMR scenarios, against the JAX
reference.

Across frameworks the stage path is held to the reference's
``reference_stage`` stage by stage, on the same inputs, within the kernel
tolerance (tests/test_kernels.py: rtol 2e-5, atol 2e-6 of the largest
value), and a whole fused-stage RK3 step to the reference's within the
tolerance the port's generic step is held to (tests/test_torch_runtime.py:
rtol 1e-5, atol 1e-6 of the largest value).  Within the port ``s3`` and
``s2+s3`` equal the fused stage path bit for bit, and the fused stages stay
within rtol 1e-5, atol 1e-5 of the largest value of the generic combine
(the stage update is ``c0*u0 + c1*(v + dt*rhs)`` per slot, the generic
path's combine association differs for gravity's source tail).
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

from repro_torch.configs.amr_sedov import CONFIG as ACFG  # noqa: E402
from repro_torch.configs.amr_sedov import CONFIG_MIXED  # noqa: E402
from repro_torch.configs.base import AggregationConfig, HydroConfig  # noqa: E402
from repro_torch.configs.gravity import CONFIG_SMALL as GCFG  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AggregationExecutor, AMRSedovScenario, GravityScenario, StrategyRunner,
    TaskPopulation, UniformSedovScenario, greedy_decomposition,
)
from repro_torch.core.strategies.s3 import S3Strategy  # noqa: E402
from repro_torch.hydro.state import amr_sedov_init, sedov_init  # noqa: E402
from repro_torch.hydro.stepper import (  # noqa: E402
    amr_courant_dt, courant_dt, stage_coeff_vectors,
)

CFG = HydroConfig(levels=1)          # 8 sub-grids of 8^3
STAGES = ((0.0, 1.0), (0.75, 0.25), (1.0 / 3.0, 2.0 / 3.0))
CASES = ["uniform", "gravity", "amr", "amr_mixed"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: torch's thread pool only adds contention here."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _levels(state):
    return state if isinstance(state, tuple) else (state,)


def _to_jax(state):
    out = tuple(jnp.asarray(x.numpy()) for x in _levels(state))
    return out if isinstance(state, tuple) else out[0]


def _to_torch(state):
    out = tuple(torch.from_numpy(np.array(x)) for x in _levels(state))
    return out if isinstance(state, tuple) else out[0]


def _case(name):
    """(port scenario, JAX scenario, port state, dt as float32)."""
    if name == "uniform":
        u = sedov_init(CFG, device="cpu").u
        return (UniformSedovScenario(CFG),
                JUniformSedovScenario(JHydroConfig(levels=1)), u,
                np.float32(courant_dt(u, CFG)))
    if name == "gravity":
        u = sedov_init(GCFG.hydro, device="cpu").u
        return (GravityScenario(GCFG), JGravityScenario(JGCFG), u,
                np.float32(courant_dt(u, GCFG.hydro)))
    cfg, jcfg = ((ACFG, jamr_configs.CONFIG) if name == "amr"
                 else (CONFIG_MIXED, jamr_configs.CONFIG_MIXED))
    st = amr_sedov_init(cfg, device="cpu")
    return (AMRSedovScenario(cfg), JAMRSedovScenario(jcfg), (st.uc, st.uf),
            np.float32(amr_courant_dt(st.uc, st.uf, cfg)))


def _assert_close(got, want, rtol, atol_scale):
    for g, w in zip(_levels(got), _levels(want)):
        g, w = np.asarray(g), np.asarray(w)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=atol_scale * float(np.abs(w).max()))


def _assert_equal(got, want):
    for g, w in zip(_levels(got), _levels(want)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", CASES)
def test_reference_stage_matches_reference(case):
    """Each of the three stages, on the same (u0, v), against the
    reference's ``reference_stage``; v is the reference's previous stage."""
    sc, jsc, u0, dt = _case(case)
    ju0 = _to_jax(u0)
    jv = ju0
    for c0, c1 in STAGES:
        want = jsc.reference_stage(ju0, jv, dt, c0, c1)
        v = u0 if jv is ju0 else _to_torch(jv)
        got = sc.reference_stage(u0, v, torch.tensor(dt), c0, c1)
        _assert_close(got, want, rtol=2e-5, atol_scale=2e-6)
        jv = want


@pytest.mark.parametrize("case", CASES)
def test_fused_stage_step_matches_reference_and_generic(case):
    """A fused-stage RK3 step under ``fused``: within the step tolerance
    of the reference's fused-stage step, and of the port's generic step."""
    sc, jsc, u0, dt = _case(case)
    runner = StrategyRunner(sc, AggregationConfig(strategy="fused",
                                                  fuse_epilogue=True),
                            device="cpu")
    assert runner.fuse_epilogue
    got = runner.rk3_step(u0, torch.tensor(dt))
    assert runner.stats["iterations"] == 3
    jrunner = JStrategyRunner(jsc, JAggregationConfig(strategy="fused",
                                                      fuse_epilogue=True))
    _assert_close(got, jrunner.rk3_step(_to_jax(u0), dt), rtol=1e-5,
                  atol_scale=1e-6)
    generic = StrategyRunner(sc, AggregationConfig(strategy="fused"),
                             device="cpu").rk3_step(u0, torch.tensor(dt))
    _assert_close(got, generic, rtol=1e-5, atol_scale=1e-5)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("strategy,n_exec", [("s3", 1), ("s2+s3", 3)])
def test_aggregated_stages_bit_identical_to_fused_stages(case, strategy,
                                                         n_exec):
    """``s3`` and ``s2+s3`` at cap 4 through the stage families: equal to
    the fused stage path bit for bit, with the greedy decomposition's
    launches in every ``+epi`` family (and gravity's)."""
    sc, _, u0, dt = _case(case)
    dt = torch.tensor(dt)
    fused = StrategyRunner(sc, AggregationConfig(
        strategy="fused", fuse_epilogue=True), device="cpu").rk3_step(u0, dt)
    agg = AggregationConfig(strategy=strategy, n_executors=n_exec,
                            max_aggregated=4, fuse_epilogue=True)
    runner = StrategyRunner(sc, agg, device="cpu")
    runner.warmup()
    _assert_equal(runner.rk3_step(u0, dt), fused)
    want = {}
    for pop in sc.stage_populations(u0, u0, dt, 0.0, 1.0):
        want[pop.kernel] = want.get(pop.kernel, 0) + 3 * len(
            greedy_decomposition(pop.n_tasks, agg.bucket_sizes()))
    assert runner.launches_by_family == want
    assert any(k.endswith("+epi") for k in want)


def test_stage_coeff_vectors_cached_per_dt_object():
    cache = {}
    dt = torch.tensor(0.5)
    a = stage_coeff_vectors(cache, dt, 0.75, 0.25, 4, torch.float32,
                            torch.device("cpu"))
    assert [v.tolist() for v in a] == [[0.75] * 4, [0.25] * 4, [0.5] * 4]
    assert stage_coeff_vectors(cache, dt, 0.75, 0.25, 4, torch.float32,
                               torch.device("cpu")) is a
    b = stage_coeff_vectors(cache, torch.tensor(0.5), 0.75, 0.25, 4,
                            torch.float32, torch.device("cpu"))
    assert b is not a and all(torch.equal(x, y) for x, y in zip(a, b))
    c = stage_coeff_vectors(cache, 0.25, 0.0, 1.0, 2, torch.float32,
                            torch.device("cpu"))
    assert c[2].tolist() == [0.25, 0.25] and len(cache) == 2


@pytest.mark.parametrize("agg", [
    AggregationConfig(strategy="s3", staging="host", fuse_epilogue=True),
    AggregationConfig(strategy="s2", fuse_epilogue=True)])
def test_fuse_epilogue_declined_where_the_reference_declines(agg):
    """Host staging keeps the per-task baseline and ``s2`` has no stage
    path: both take the generic combine, equal to ``fused``."""
    u = sedov_init(CFG, device="cpu").u
    dt = courant_dt(u, CFG)
    runner = StrategyRunner(UniformSedovScenario(CFG), agg, device="cpu")
    assert not runner.fuse_epilogue
    fused = StrategyRunner(UniformSedovScenario(CFG), AggregationConfig(
        strategy="fused"), device="cpu").rk3_step(u, dt)
    assert torch.equal(runner.rk3_step(u, dt), fused)
    assert set(runner.launches_by_family) == {"hydro_rhs"}


def test_empty_population_yields_a_zero_length_batch():
    sc = UniformSedovScenario(CFG)
    exe = AggregationExecutor(None, AggregationConfig(), device="cpu")
    exe.register("hydro_rhs", sc.batched_body)
    pops = (TaskPopulation("hydro_rhs", (torch.zeros(0, 5, 14, 14, 14),)),)
    futs = S3Strategy._submit_populations(exe, pops, host=False)
    outs = S3Strategy._drain(sc, exe, pops, futs)
    assert outs[0].shape == (0, 5, 8, 8, 8)
    assert exe.stats["launches"] == 0
