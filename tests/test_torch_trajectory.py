"""The port's trajectory entry points against the JAX reference, on the CPU:
``StrategyRunner.rk3_trajectory``, ``time_step(use_scan=True)``,
``hydro.stepper.rk3_trajectory``, the deprecated runner factories and the
AMR exchange's CPU path.

Within the port the ``fused`` trajectory equals the ``rk3_step`` loop bit
for bit (on the card it is one CUDA graph; tests/test_torch_cuda.py holds
that graph to the loop).  Against the reference's ``lax.scan`` trajectory
the states agree within the kernel tolerance between the frameworks:
rtol 1e-5, atol 1e-5 x max|u|, as ``tests/test_slot_ring.py``.
"""
import warnings

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
from repro.hydro import stepper as jstepper  # noqa: E402

from repro_torch.configs.amr_sedov import CONFIG as ACFG  # noqa: E402
from repro_torch.configs.base import AggregationConfig, HydroConfig  # noqa: E402
from repro_torch.configs.gravity import CONFIG_SMALL as GCFG  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AMRSedovScenario, AMRStrategyRunner, GravityScenario,
    HydroStrategyRunner, StrategyRunner, UniformSedovScenario,
)
from repro_torch.hydro.state import (  # noqa: E402
    amr_sedov_init, extract_subgrids_multilevel, sedov_init,
)
from repro_torch.hydro.stepper import (  # noqa: E402
    amr_courant_dt, courant_dt, rk3_step, rk3_trajectory,
)

CFG = HydroConfig(subgrid=8, ghost=3, levels=1)     # 8 sub-grids of 8^3
CASES = ["uniform", "gravity", "amr"]
FUSED = AggregationConfig(strategy="fused")


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


def _case(name):
    """(port scenario factory, JAX scenario, port state, 0-dim fp32 dt)."""
    if name == "uniform":
        u = sedov_init(CFG, device="cpu").u
        return (lambda: UniformSedovScenario(CFG),
                JUniformSedovScenario(JHydroConfig(levels=1)), u,
                courant_dt(u, CFG))
    if name == "gravity":
        u = sedov_init(GCFG.hydro, device="cpu").u
        return (lambda: GravityScenario(GCFG), JGravityScenario(JGCFG), u,
                courant_dt(u, GCFG.hydro))
    st = amr_sedov_init(ACFG, device="cpu")
    return (lambda: AMRSedovScenario(ACFG),
            JAMRSedovScenario(jamr_configs.CONFIG), (st.uc, st.uf),
            amr_courant_dt(st.uc, st.uf, ACFG))


def _loop(runner, state, dt, n):
    for _ in range(n):
        state = runner.rk3_step(state, dt)
    return state


def _assert_equal(got, want):
    assert type(got) is type(want)
    for g, w in zip(_levels(got), _levels(want)):
        assert torch.equal(g, w)


def _assert_close(got, want):
    for g, w in zip(_levels(got), _levels(want)):
        g, w = np.asarray(g), np.asarray(w)
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))


@pytest.mark.parametrize("case", CASES)
def test_fused_trajectory_bit_equal_to_step_loop(case):
    """One launch and 3 x n iterations counted; the caller's state kept."""
    make, _, u0, dt = _case(case)
    want = _loop(StrategyRunner(make(), FUSED, device="cpu"), u0, dt, 2)
    before = tuple(u.clone() for u in _levels(u0))
    runner = StrategyRunner(make(), FUSED, device="cpu")
    got = runner.rk3_trajectory(u0, dt, 2)
    _assert_equal(got, want)
    assert runner.stats["kernel_launches"] == 1
    assert runner.stats["iterations"] == 6
    _assert_equal(_levels(u0), before)
    assert not runner.trajectory_graphs          # graphs are the card's


@pytest.mark.parametrize("case", CASES)
def test_fused_trajectory_matches_reference_trajectory(case):
    """The port's trajectory against the reference's ``lax.scan`` one on
    the same state and dt."""
    make, jsc, u0, dt = _case(case)
    want = JStrategyRunner(jsc, JAggregationConfig(
        strategy="fused")).rk3_trajectory(_to_jax(u0), jnp.float32(dt), 2)
    got = StrategyRunner(make(), FUSED, device="cpu").rk3_trajectory(
        u0, dt, 2)
    _assert_close(got, want)


@pytest.mark.parametrize("kw", [dict(strategy="s3", max_aggregated=4),
                                dict(strategy="s2", n_executors=2)],
                         ids=["s3", "s2"])
def test_other_strategies_loop_over_rk3_step(kw):
    """Outside ``fused`` the trajectory is the step loop, counted as such;
    it equals ``fused`` bit for bit."""
    make, _, u0, dt = _case("amr")
    runner = StrategyRunner(make(), AggregationConfig(**kw), device="cpu")
    stepped = StrategyRunner(make(), AggregationConfig(**kw), device="cpu")
    want = _loop(stepped, u0, dt, 2)
    got = runner.rk3_trajectory(u0, dt, 2)
    _assert_equal(got, want)
    assert runner.stats["kernel_launches"] == stepped.stats["kernel_launches"]
    assert runner.stats["iterations"] == 6
    _assert_equal(got, StrategyRunner(make(), FUSED,
                                      device="cpu").rk3_trajectory(u0, dt, 2))


def test_fused_stage_runner_trajectory_takes_the_generic_combine():
    """As in the reference, the trajectory runs ``reference_rhs`` and the
    generic combine even where the runner's steps take the fused stages."""
    make, _, u0, dt = _case("gravity")
    runner = StrategyRunner(make(), AggregationConfig(
        strategy="fused", fuse_epilogue=True), device="cpu")
    assert runner.fuse_epilogue
    _assert_equal(runner.rk3_trajectory(u0, dt, 1),
                  StrategyRunner(make(), FUSED, device="cpu").rk3_step(u0,
                                                                       dt))


@pytest.mark.parametrize("case", ["uniform", "amr"])
def test_time_step_use_scan(case):
    make, _, u0, dt = _case(case)
    runner = StrategyRunner(make(), FUSED, device="cpu")
    assert runner.time_step(u0, dt, 2, use_scan=True) > 0
    assert runner.stats["iterations"] == 6
    assert runner.stats["kernel_launches"] == 1
    s3 = StrategyRunner(make(), AggregationConfig(strategy="s3"),
                        device="cpu")
    s3.time_step(u0, dt, 2, use_scan=True)      # not fused: the step loop
    assert s3.stats["iterations"] == 6


def test_stepper_trajectory_matches_reference_and_loop():
    """``hydro.stepper.rk3_trajectory``: the loop of the port's
    ``rk3_step`` bit for bit, the reference's ``lax.scan`` trajectory
    within tolerance; its input kept."""
    u0 = sedov_init(CFG, device="cpu").u
    dt = courant_dt(u0, CFG)
    before = u0.clone()
    got = rk3_trajectory(u0, dt, CFG, 2)
    assert torch.equal(got, rk3_step(rk3_step(u0, dt, CFG), dt, CFG))
    assert torch.equal(u0, before)
    jcfg = JHydroConfig(subgrid=8, ghost=3, levels=1)
    want = jstepper.rk3_trajectory(jnp.asarray(u0.numpy()), jnp.float32(dt),
                                   jcfg, 2)
    _assert_close(got, want)


@pytest.mark.parametrize("which", ["hydro", "amr"])
def test_deprecated_runner_factories_warn_and_build_the_runner(which):
    if which == "hydro":
        with pytest.warns(DeprecationWarning, match="HydroStrategyRunner"):
            runner = HydroStrategyRunner(CFG, FUSED, device="cpu")
        assert isinstance(runner.scenario, UniformSedovScenario)
        make, _, u0, dt = _case("uniform")
    else:
        with pytest.warns(DeprecationWarning, match="AMRStrategyRunner"):
            runner = AMRStrategyRunner(ACFG, FUSED, device="cpu")
        assert isinstance(runner.scenario, AMRSedovScenario)
        make, _, u0, dt = _case("amr")
    assert isinstance(runner, StrategyRunner)
    assert runner.device.type == "cpu" and runner.strategy == "fused"
    _assert_equal(runner.rk3_step(u0, dt),
                  StrategyRunner(make(), FUSED, device="cpu").rk3_step(u0,
                                                                       dt))


def test_deprecated_factories_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            HydroStrategyRunner(CFG, FUSED)


def test_amr_exchange_stays_eager_on_the_cpu():
    """On the CPU the exchange is ``extract_subgrids_multilevel`` itself,
    a new pair of tensors per call, and no graph is made."""
    st = amr_sedov_init(ACFG, device="cpu")
    sc = AMRSedovScenario(ACFG)
    first = sc.exchange(st.uc, st.uf)
    second = sc.exchange(st.uc, st.uf)
    want = extract_subgrids_multilevel(st.uc, st.uf, ACFG)
    for a, b, w in zip(first, second, want):
        assert torch.equal(a, w) and torch.equal(b, w)
        assert a.data_ptr() != b.data_ptr()
    assert not sc.exchange_graphs
