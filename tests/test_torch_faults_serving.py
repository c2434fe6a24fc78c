"""The port's serving containment against the JAX reference, on the CPU,
at the reduced configs (granite-8b and qwen2-moe-a2.7b, the reference's
weights carried across): a poisoned request evicted mid decode and mid
prefill (tests/test_faults.py, tests/test_serving.py), its co-tenant's
tokens equal to a fault-free run, its slot serving the next request, the
same tokens, errors and counters as the reference engine; and ``healthz``
reporting a shared executor's breaker states.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.configs.base import AggregationConfig as JAggregationConfig  # noqa: E402
from repro.core import AggregationExecutor as JAggregationExecutor  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingEngine as JServingEngine  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.configs.base import AggregationConfig  # noqa: E402
from repro_torch.core import (  # noqa: E402
    AggregationExecutor, FaultInjector, FaultSpec,
)
from repro_torch.models import convert  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inj(lib, specs, seed=0):
    if lib == "port":
        return FaultInjector([FaultSpec(**d) for d in specs], seed=seed)
    return jfaults.FaultInjector([jfaults.FaultSpec(**d) for d in specs],
                                 seed=seed)


# ---------------------------------------------------------------------------
# serving: eviction and healthz breakers
# ---------------------------------------------------------------------------

_PAIRS = {}


def _pair(arch):
    if arch not in _PAIRS:
        cfg, jcfg = reduced(get_config(arch)), jreduced(jget_config(arch))
        jp = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        np_params = jax.tree_util.tree_map(np.asarray, jp)
        _PAIRS[arch] = (cfg, convert.params_from_reference(
            np_params, cfg, device="cpu"), jcfg, jp)
    return _PAIRS[arch]


def _serve(lib, arch, specs, guard, prompts, seed, later=None):
    cfg, m, jcfg, jp = _pair(arch)
    if lib == "port":
        eng = ServingEngine(cfg, m, max_batch=4, max_len=32, device="cpu",
                            agg=AggregationConfig(max_aggregated=4,
                                                  guard=guard),
                            fault_injector=(_inj("port", specs, seed)
                                            if specs else None))
        req = Request
    else:
        eng = JServingEngine(jcfg, jp, max_batch=4, max_len=32,
                             agg=JAggregationConfig(max_aggregated=4,
                                                    guard=guard),
                             fault_injector=(_inj("jax", specs, seed)
                                             if specs else None))
        req = JRequest
    reqs = [req(i, p, max_new_tokens=4) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    again = None
    if later is not None:
        again = req(len(prompts), later, max_new_tokens=4)
        eng.submit(again)
        eng.run()
    return eng, reqs, again


@pytest.mark.parametrize("arch", ["granite-8b", "qwen2-moe-a2.7b"])
@pytest.mark.parametrize("when", ["mid_decode", "mid_prefill"])
def test_engine_evicts_poisoned_request_as_reference(arch, when):
    """A poisoned request is evicted and its slot recycled; the co-batched
    request's tokens equal a fault-free run; the recycled slot serves the
    next request as a fresh one would be served.  The reference, on the
    same weights and schedule, does the same thing token for token."""
    if when == "mid_decode":
        prompts, seed, later = [[3, 5, 7], [2, 4, 6]], 5, [3, 5, 7]
    else:
        # request 0 prefills at launches 1-2, request 1 at 3-5: times=1 on
        # request 1 fires mid-prefill, before any decode
        prompts, seed, later = [[3, 5, 7], [2, 4, 6, 8]], 3, [2, 4, 6, 8]
    spec = [dict(site="payload", kernel="decode", task=1, mode="nan",
                 times=1)]
    results = {}
    for lib in ("port", "jax"):
        _, clean, _ = _serve(lib, arch, [], "off", prompts, seed)
        eng, reqs, again = _serve(lib, arch, spec, "finite", prompts, seed,
                                  later)
        assert reqs[1].failed and reqs[1].done
        assert "non-finite" in reqs[1].error and "evicted" in reqs[1].error
        assert not reqs[0].failed
        assert reqs[0].output == clean[0].output
        assert eng.stats["faults"] == {"trips": 1, "evicted": 1, "shed": 0}
        assert sorted(eng.slots_free) == list(range(4))
        assert again.output == clean[0 if when == "mid_decode" else 1].output
        if when == "mid_prefill":
            assert reqs[1].output == []
        results[lib] = ([r.output for r in reqs], again.output, reqs[1].error,
                        eng.stats["launches"],
                        dict(eng.stats["aggregated_hist"]))
    assert results["port"] == results["jax"]


def test_engine_healthz_reports_breaker_states():
    cfg, m, jcfg, jp = _pair("granite-8b")
    got = []
    for lib in ("port", "jax"):
        if lib == "port":
            exe = AggregationExecutor(None, AggregationConfig(
                max_aggregated=4, breaker_window=4), device="cpu")
            exe.register("k", lambda x: x * 2.0)
            eng = ServingEngine(cfg, m, max_batch=2, max_len=16,
                                executor=exe, device="cpu")
            task = (torch.ones(2),)
        else:
            exe = JAggregationExecutor(None, JAggregationConfig(
                max_aggregated=4, breaker_window=4))
            exe.register("k", lambda x: x * 2.0)
            eng = JServingEngine(jcfg, jp, max_batch=2, max_len=16,
                                 executor=exe)
            task = (jnp.ones((2,)),)
        before = eng.healthz()["breakers"]
        exe.map([task] * 3, kernel="k")
        got.append((before, eng.healthz()["breakers"]))
    assert got[0] == got[1] == ({}, {"k": "closed"})
