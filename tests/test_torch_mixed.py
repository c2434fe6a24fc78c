"""The port's ``mixed`` strategy (per-family routing to s2, s3 or fused)
on the CPU.

Every product of routes over a scenario's families is held to the port's
``fused`` RK3 step bit for bit (every route runs the family's same body;
only the batch decomposition differs) and to the JAX reference's ``fused``
step within the tolerance the port's other strategies are held to
(tests/test_torch_s2.py: rtol 1e-5, atol 1e-6 of the largest value, the
kernel tolerance compounded over three stages).  The reference's own
``s2`` route is no yardstick: it is among its known failures on XLA:CPU
(ROADMAP.md, Queue 3).  The measured choice (``"auto"``) is decided by an
injected timer's known times, never by a clock.
"""
import itertools

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

from repro_torch.configs.amr_sedov import CONFIG_MIXED  # noqa: E402
from repro_torch.configs.base import AggregationConfig, HydroConfig  # noqa: E402
from repro_torch.configs.gravity import CONFIG_SMALL as GCFG  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AMRSedovScenario, GravityScenario, StrategyRunner, UniformSedovScenario,
)
from repro_torch.core.strategies.mixed import MixedStrategy  # noqa: E402
from repro_torch.hydro.state import amr_sedov_init, sedov_init  # noqa: E402
from repro_torch.hydro.stepper import amr_courant_dt, courant_dt  # noqa: E402

CFG = HydroConfig(levels=1)          # 8 sub-grids of 8^3
ROUTES = ("s2", "s3", "fused")
FAMILIES = {"uniform": ("hydro_rhs",), "gravity": ("hydro_rhs", "gravity"),
            "amr_mixed": ("hydro_rhs_s16", "hydro_rhs_s8")}


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
    """(port scenario, JAX scenario, port state, JAX state, dt)."""
    if name == "uniform":
        u = sedov_init(CFG, device="cpu").u
        return (UniformSedovScenario(CFG),
                JUniformSedovScenario(JHydroConfig(levels=1)), u,
                jnp.asarray(u.numpy()), np.float32(courant_dt(u, CFG)))
    if name == "gravity":
        u = sedov_init(GCFG.hydro, device="cpu").u
        return (GravityScenario(GCFG), JGravityScenario(JGCFG), u,
                jnp.asarray(u.numpy()),
                np.float32(courant_dt(u, GCFG.hydro)))
    st = amr_sedov_init(CONFIG_MIXED, device="cpu")
    return (AMRSedovScenario(CONFIG_MIXED),
            JAMRSedovScenario(jamr_configs.CONFIG_MIXED), (st.uc, st.uf),
            (jnp.asarray(st.uc.numpy()), jnp.asarray(st.uf.numpy())),
            np.float32(amr_courant_dt(st.uc, st.uf, CONFIG_MIXED)))


_REFS = {}


def _refs(name):
    """The case, the port's fused step and the JAX fused step (once)."""
    if name not in _REFS:
        sc, jsc, state, jstate, dt = _case(name)
        fused = StrategyRunner(sc, AggregationConfig(strategy="fused"),
                               device="cpu").rk3_step(state, torch.tensor(dt))
        want = JStrategyRunner(jsc, JAggregationConfig(strategy="fused")
                               ).rk3_step(jstate, dt)
        _REFS[name] = (sc, state, dt, _numpy(fused), _numpy(want))
    return _REFS[name]


def _products():
    for case, fams in FAMILIES.items():
        for combo in itertools.product(ROUTES, repeat=len(fams)):
            yield case, dict(zip(fams, combo))


@pytest.mark.parametrize("case,routes", list(_products()),
                         ids=lambda v: v if isinstance(v, str)
                         else "-".join(v.values()))
def test_route_product_bit_identical_to_fused(case, routes):
    """One RK3 step under ``mixed`` with the given route per family (3
    streams, cap 4 so s3 drains several buckets; warmed up, so every
    family's region exists to record its route): bit-identical to the
    port's ``fused``, within tolerance of the JAX ``fused`` step; each
    family recorded under its route, the launches per family as its route
    launches them."""
    sc, state, dt, fused, want = _refs(case)
    runner = StrategyRunner(sc, AggregationConfig(
        strategy="mixed", n_executors=3, max_aggregated=4,
        family_strategies=routes), device="cpu")
    runner.warmup()
    got = runner.rk3_step(state, torch.tensor(dt))
    for g, f, w in zip(_numpy(got), fused, want):
        assert np.isfinite(g).all()
        np.testing.assert_array_equal(g, f)
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(w).max()))
    assert runner._strategy.routes(sc, runner.ctx) == {
        **routes, **{f.kernel: routes[f.kernel.split("+")[0]]
                     for f in sc.stage_families()}}
    by_kernel = {}
    for desc, st in runner.stats["regions"].items():
        kernel = desc.split("[")[0]
        if kernel in routes:
            by_kernel[kernel] = st
    for kernel, route in routes.items():
        st = by_kernel[kernel]
        assert st["selected_strategy"] == route
        n = st["submitted"]
        if route == "s2":
            assert st["aggregated_hist"] == {1: n}
        elif route == "fused":
            assert st["launches"] == 3
            assert set(st["aggregated_hist"]) == {n // 3}
        else:
            assert max(st["aggregated_hist"]) <= 4


def fake_timer(table):
    def timer(fn, device, path, size):
        fn()
        return table[path](size)
    return timer


@pytest.mark.parametrize("winner", ROUTES)
def test_auto_route_follows_the_measured_costs(winner):
    """``auto`` takes the route with the least predicted time from the
    warmup's measurements (known times here), records it with its costs,
    and stays bit-identical to ``fused``."""
    fast, slow = (lambda n: 1e-5), (lambda n: 1e-1 * (1 + n))
    table = {"s3": slow, "s2": slow, "fused": slow, "chunk": slow}
    table[winner] = fast
    sc, state, dt, fused, _ = _refs("gravity")
    runner = StrategyRunner(sc, AggregationConfig(
        strategy="mixed", cost_model=True, max_aggregated=8),
        device="cpu", timer=fake_timer(table))
    runner.warmup()
    got = runner.rk3_step(state, torch.tensor(dt))
    np.testing.assert_array_equal(_numpy(got)[0], fused[0])
    routes = runner._strategy.routes(sc, runner.ctx)
    assert routes["hydro_rhs"] == routes["gravity"] == winner
    for st in runner.stats["regions"].values():
        if "strategy_costs" in st:
            assert st["selected_strategy"] == winner
            assert {"s3", "s2", "fused"} <= set(st["strategy_costs"])


def test_auto_route_without_measurements_is_s3():
    sc, state, dt, fused, _ = _refs("uniform")
    runner = StrategyRunner(sc, AggregationConfig(strategy="mixed"),
                            device="cpu")
    got = runner.rk3_step(state, torch.tensor(dt))
    np.testing.assert_array_equal(_numpy(got)[0], fused[0])
    assert runner._strategy.routes(sc, runner.ctx) == {
        "hydro_rhs": "s3", "hydro_rhs+epi": "s3"}


@pytest.mark.parametrize("case", ["uniform", "gravity"])
def test_fused_stages_under_mixed_equal_fused_stages(case):
    """``fuse_epilogue`` under ``mixed`` (routes s2 / fused per family):
    each stage wave through the stage families, equal bit for bit to the
    ``fused`` strategy's fused stages."""
    sc, state, dt, _, _ = _refs(case)
    want = StrategyRunner(sc, AggregationConfig(
        strategy="fused", fuse_epilogue=True), device="cpu").rk3_step(
            state, torch.tensor(dt))
    routes = {"*": "s2"} if case == "uniform" else {"hydro_rhs": "fused",
                                                   "gravity": "s3"}
    runner = StrategyRunner(sc, AggregationConfig(
        strategy="mixed", fuse_epilogue=True, max_aggregated=4,
        family_strategies=routes), device="cpu")
    assert runner.fuse_epilogue
    got = runner.rk3_step(state, torch.tensor(dt))
    assert torch.equal(got, want)
    assert any(k.startswith("hydro_rhs+epi") for k in runner.stats["regions"])


def test_mixed_declines_host_staging_stages_and_rejects_bad_routes():
    sc, state, dt, fused, _ = _refs("uniform")
    runner = StrategyRunner(sc, AggregationConfig(
        strategy="mixed", staging="host", fuse_epilogue=True,
        family_strategies={"*": "s3"}), device="cpu")
    assert not runner.fuse_epilogue
    got = runner.rk3_step(state, torch.tensor(dt))
    np.testing.assert_array_equal(_numpy(got)[0], fused[0])
    with pytest.raises(ValueError, match="valid assignments"):
        AggregationConfig(strategy="mixed", family_strategies={"*": "s4"})
    assert MixedStrategy.uses_executor
