"""The port's ``mixed`` strategy under containment against the JAX
reference, on the CPU, on the self-gravitating scenario
(``configs/gravity.CONFIG_SMALL``): the three guard cases of
tests/test_mixed.py (an ``s3``-routed fault bisected, the tripwire of the
``s2`` and ``fused`` routes naming the family and its route, unguarded
faults flowing into the result) and the circuit breaker pinning gravity to
``s3`` while it is not closed, then handing it back to its cached route.

Both sides get the same numpy-made state and the same ``FaultSpec``s; the
exceptions, breaker states and launches are equal, every iteration is
bit-equal to the port's ``fused`` one and within the kernel tolerance
(rtol 2e-5, atol 2e-6 of the largest value) of the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AggregationConfig as JAggregationConfig  # noqa: E402
from repro.configs.gravity import CONFIG_SMALL as JGCFG  # noqa: E402
from repro.core import GravityScenario as JGravityScenario  # noqa: E402
from repro.core import StrategyRunner as JStrategyRunner  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402

from repro_torch.configs.base import AggregationConfig  # noqa: E402
from repro_torch.configs.gravity import CONFIG_SMALL as GCFG  # noqa: E402
from repro_torch.core import (  # noqa: E402
    FaultInjector, FaultSpec, GravityScenario, NonFiniteStateError,
    StrategyRunner, TaskFailedError,
)
from repro_torch.hydro.state import sedov_init  # noqa: E402
from repro_torch.hydro.stepper import courant_dt  # noqa: E402

WM = 10 ** 9
# the gravity family's breaker states in
# test_breaker_pins_gravity_to_s3_then_returns_to_fused (two faulted
# direct waves, then four mixed iterations); chip_smoke.py's containment
# phase holds Path A to the same sequence
BREAKER_SEQUENCE = ["closed", "open", "open", "half_open", "closed",
                    "closed"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tol(want):
    return dict(rtol=2e-5, atol=2e-6 * max(float(np.abs(want).max()), 1.0))


def _inj(lib, specs, seed=0):
    if lib == "port":
        return FaultInjector([FaultSpec(**d) for d in specs], seed=seed)
    return jfaults.FaultInjector([jfaults.FaultSpec(**d) for d in specs],
                                 seed=seed)


def _gravity():
    u = sedov_init(GCFG.hydro, device="cpu").u
    return u, jnp.asarray(u.numpy()), float(courant_dt(u, GCFG.hydro))


# ---------------------------------------------------------------------------
# mixed: the three guard cases of tests/test_mixed.py, and the breaker
# ---------------------------------------------------------------------------

def _mixed(lib, fam, inj_specs, **kw):
    if lib == "port":
        agg = AggregationConfig(strategy="mixed", n_executors=2,
                                max_aggregated=16, launch_watermark=WM,
                                family_strategies=fam, **kw)
        return StrategyRunner(GravityScenario(GCFG), agg, device="cpu",
                              fault_injector=_inj("port", inj_specs))
    agg = JAggregationConfig(strategy="mixed", n_executors=2,
                             max_aggregated=16, launch_watermark=WM,
                             family_strategies=fam, **kw)
    return JStrategyRunner(JGravityScenario(JGCFG), agg,
                           fault_injector=_inj("jax", inj_specs))


def _payload0(kernel):
    return [dict(site="payload", kernel=kernel, task=0, mode="nan",
                 times=1)]


@pytest.mark.parametrize("kernel,route,other", [
    ("hydro_rhs", "s3", "s2"),
    ("gravity", "s3", "fused"),
])
def test_mixed_guard_s3_routed_fault_bisected(kernel, route, other):
    u, ju, dt = _gravity()
    fam = {kernel: route,
           ("gravity" if kernel == "hydro_rhs" else "hydro_rhs"): other}
    for lib, state, err_t in (("port", u, TaskFailedError),
                              ("jax", ju, jfaults.TaskFailedError)):
        r = _mixed(lib, fam, _payload0(kernel), guard="finite")
        with pytest.raises(err_t) as err:
            r.rk3_step(state, dt)
        assert err.value.task_ids == (0,) and err.value.kernel == kernel


@pytest.mark.parametrize("kernel,route", [
    ("hydro_rhs", "s2"), ("hydro_rhs", "fused"),
    ("gravity", "s2"), ("gravity", "fused"),
])
def test_mixed_guard_nonexecutor_route_tripwire(kernel, route):
    u, ju, dt = _gravity()
    fam = {"hydro_rhs": "s3", "gravity": "s3"}
    fam[kernel] = route
    msgs = []
    for lib, state, err_t in (("port", u, NonFiniteStateError),
                              ("jax", ju, jfaults.NonFiniteStateError)):
        r = _mixed(lib, fam, _payload0(kernel), guard="finite")
        with pytest.raises(err_t) as err:
            r.rk3_step(state, dt)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert kernel in msgs[0] and route in msgs[0]


def test_mixed_unguarded_faults_still_poison():
    u, ju, dt = _gravity()
    fam = {"hydro_rhs": "s2", "gravity": "s3"}
    out = _mixed("port", fam, _payload0("hydro_rhs")).rk3_step(u, dt)
    jout = _mixed("jax", fam, _payload0("hydro_rhs")).rk3_step(ju, dt)
    assert not bool(torch.isfinite(out).all())
    assert not bool(jnp.isfinite(jout).all())


def _breaker_trace(lib, state):
    """Two direct gravity waves, each with a payload fault on task 3 (the
    breaker opens), then four ``mixed`` iterations with gravity's cached
    route ``fused``: pinned to ``s3`` while not closed (bucket 1 while
    open), a clean half-open probe closes the breaker, and the family
    returns to ``fused``.  Returns the states, the executor launches per
    iteration and the iterations' outputs."""
    r = _mixed(lib, {"hydro_rhs": "s3", "gravity": "fused"},
               [dict(site="payload", kernel="gravity", task=3, times=2)],
               guard="finite", breaker_window=4, breaker_threshold=2,
               breaker_cooldown=2)
    exe = r.executor if lib == "port" else r._agg_exec
    assert r._strategy.routes(r.scenario, r.ctx)["gravity"] == "fused"
    pops = {p.kernel: p for p in r.scenario.populations(state)}
    states, launches, outs = [], [], []
    for _ in range(2):
        fut = pops["gravity"].submit_to(exe)
        exe.flush()
        assert fut.failed_indices() == [3]
        states.append(exe.breaker_state("gravity"))
    for _ in range(4):
        before = exe.stats["launches"]
        outs.append(np.asarray(r.rhs(state)))
        launches.append(exe.stats["launches"] - before)
        states.append(exe.breaker_state("gravity"))
    assert r.ctx.caches[("mixed_route", "gravity")] == "fused"
    return states, launches, outs, exe.breaker_states()


def test_breaker_pins_gravity_to_s3_then_returns_to_fused():
    u, ju, _ = _gravity()
    got = _breaker_trace("port", u)
    want = _breaker_trace("jax", ju)
    assert got[0] == want[0] == BREAKER_SEQUENCE
    assert got[1] == want[1] and got[3] == want[3]
    n_grav = GravityScenario(GCFG).populations(u)[1].n_tasks
    # open: gravity at bucket 1; closed again: gravity fused (no launch)
    assert got[1][0] - got[1][3] == n_grav
    fused = StrategyRunner(GravityScenario(GCFG), AggregationConfig(
        strategy="fused"), device="cpu").rhs(u)
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g, fused.numpy())
        np.testing.assert_allclose(g, w, **_tol(w))
