"""The port's containment on its hydro paths against the JAX reference,
on the CPU: the uniform Sedov scenario under ``s3`` with a hydro payload
fault (the culprit, the counters, the ``describe_task`` text) and the
executor-less tripwire of ``fused`` and ``s2``.

Both sides get the same numpy-made states and the same ``FaultSpec``s;
survivors are bit-equal to the port's fault-free run and within the kernel
tolerance (rtol 2e-5, atol 2e-6 of the largest value) of the reference's.
The ``mixed`` cases are in tests/test_torch_faults_mixed.py, serving in
tests/test_torch_faults_serving.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.configs.base import AggregationConfig as JAggregationConfig  # noqa: E402
from repro.configs.base import HydroConfig as JHydroConfig  # noqa: E402
from repro.core import StrategyRunner as JStrategyRunner  # noqa: E402
from repro.core import UniformSedovScenario as JUniformSedovScenario  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402

from repro_torch.configs.base import AggregationConfig, HydroConfig  # noqa: E402
from repro_torch.core import (  # noqa: E402
    FaultInjector, FaultSpec, NonFiniteStateError, StrategyRunner,
    TaskFailedError, UniformSedovScenario,
)
from repro_torch.hydro.state import sedov_init  # noqa: E402

CFG = HydroConfig(levels=1)          # 8 sub-grids of 8^3


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


def _uniform():
    u = sedov_init(CFG, device="cpu").u
    return u, jnp.asarray(u.numpy())


# ---------------------------------------------------------------------------
# the uniform scenario under s3 with a hydro payload fault
# ---------------------------------------------------------------------------

def test_uniform_s3_hydro_payload_fault_equals_reference():
    """A payload fault on task 3 of the uniform scenario's hydro wave, at
    cap 8: through each runner's executor directly (the culprit, the
    counters, the survivors), then through ``rhs`` (the culprit named in
    the scenario's words)."""
    u, ju = _uniform()
    spec = [dict(site="payload", kernel="hydro_rhs", task=3)]
    out, msgs = {}, {}
    for lib, state in (("port", u), ("jax", ju), ("clean", u)):
        if lib == "jax":
            runner = JStrategyRunner(
                JUniformSedovScenario(JHydroConfig(levels=1)),
                JAggregationConfig(strategy="s3", max_aggregated=8,
                                   guard="finite"),
                fault_injector=_inj("jax", spec))
            exe = runner._agg_exec
        else:
            runner = StrategyRunner(UniformSedovScenario(CFG), AggregationConfig(
                strategy="s3", max_aggregated=8, guard="finite"),
                device="cpu",
                fault_injector=_inj("port", spec if lib == "port" else []))
            exe = runner.executor
        (pop,) = runner.scenario.populations(state)
        fut = pop.submit_to(exe)
        exe.flush()
        bad = fut.failed_indices()
        out[lib] = (bad, {i: np.asarray(fut.task_result(i))
                          for i in range(pop.n_tasks) if i not in bad},
                    dict(next(iter(exe.stats["regions"].values()))["faults"]))
        if lib == "clean":
            continue
        err_t = TaskFailedError if lib == "port" else jfaults.TaskFailedError
        with pytest.raises(err_t) as err:
            runner.rhs(state)
        assert err.value.task_ids == (3,) and err.value.kernel == "hydro_rhs"
        msgs[lib] = str(err.value).split(" failed during")[0]
    assert out["port"][0] == out["jax"][0] == [3] and out["clean"][0] == []
    assert out["port"][2] == out["jax"][2]
    assert out["port"][2]["bisection_launches"] == 2 * 3
    for i, got in out["port"][1].items():
        np.testing.assert_array_equal(got, out["clean"][1][i])
        np.testing.assert_allclose(got, out["jax"][1][i],
                                   **_tol(out["jax"][1][i]))
    assert msgs["port"] == msgs["jax"] == "task 3 of family 'hydro_rhs'"


@pytest.mark.parametrize("strategy", ["fused", "s2"])
def test_executor_less_tripwire_equals_reference(strategy):
    u, ju = _uniform()
    bad, jbad = u.clone(), ju.at[(0,) * ju.ndim].set(float("nan"))
    bad.view(-1)[0] = float("nan")
    for guard in ("finite", "off"):
        p = StrategyRunner(UniformSedovScenario(CFG), AggregationConfig(
            strategy=strategy, guard=guard, max_aggregated=1), device="cpu")
        j = JStrategyRunner(JUniformSedovScenario(JHydroConfig(levels=1)),
                            JAggregationConfig(strategy=strategy,
                                               guard=guard,
                                               max_aggregated=1))
        np.testing.assert_allclose(np.asarray(p.rhs(u)),
                                   np.asarray(j.rhs(ju)),
                                   **_tol(np.asarray(j.rhs(ju))))
        if guard == "finite":
            with pytest.raises(NonFiniteStateError, match=strategy):
                p.rhs(bad)
            with pytest.raises(jfaults.NonFiniteStateError):
                j.rhs(jbad)
        else:                        # unguarded: propagates silently
            assert not bool(torch.isfinite(p.rhs(bad)).all())
            assert not bool(jnp.isfinite(j.rhs(jbad)).all())
