import os

# Tests run on the single real CPU device; only launch/dryrun.py forces the
# 512-device host platform (per the dry-run spec, NOT set globally here).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "requires_cuda: needs an NVIDIA GPU; skips on a host "
        "without one")


def greedy_launches(q: int, buckets) -> int:
    """Shared oracle: launches the executor's greedy bucket decomposition
    performs for a queue of length q (import from tests as
    ``from conftest import greedy_launches``)."""
    n = 0
    while q:
        b = max(x for x in buckets if x <= q)
        q -= b
        n += 1
    return n

# ---------------------------------------------------------------------------
# hypothesis fallback: the container image ships without `hypothesis`, which
# made test_aggregation.py / test_moe.py fail at collection.  When the real
# package is absent, install a minimal deterministic stand-in (integers
# strategy + @given/@settings) so the property tests still run: strategy
# endpoints first, then seeded random draws.  Remove once the dependency is
# available in CI images.
# ---------------------------------------------------------------------------
try:
    import hypothesis  # noqa: F401
except ModuleNotFoundError:
    import functools
    import inspect as _inspect
    import random as _random
    import sys
    import types

    _MAX_EXAMPLES = 10

    class _IntegersStrategy:
        def __init__(self, min_value, max_value):
            self.min_value, self.max_value = min_value, max_value

        def sample(self, rng):
            return rng.randint(self.min_value, self.max_value)

    def _st_integers(min_value, max_value):
        return _IntegersStrategy(min_value, max_value)

    def _settings(**kw):
        max_examples = min(kw.get("max_examples", _MAX_EXAMPLES),
                           _MAX_EXAMPLES)

        def deco(fn):
            fn._stub_max_examples = max_examples
            return fn
        return deco

    def _given(**strats):
        def deco(fn):
            n_examples = getattr(fn, "_stub_max_examples", _MAX_EXAMPLES)

            @functools.wraps(fn)
            def wrapper():
                rng = _random.Random(0)
                names = list(strats)
                cases = [{n: strats[n].min_value for n in names},
                         {n: strats[n].max_value for n in names}]
                while len(cases) < n_examples:
                    cases.append({n: strats[n].sample(rng) for n in names})
                for kw in cases:
                    fn(**kw)
            # pytest must see a zero-arg test, not the wrapped signature
            # (the strategy params would otherwise look like fixtures)
            del wrapper.__wrapped__
            wrapper.__signature__ = _inspect.Signature()
            return wrapper
        return deco

    _hyp = types.ModuleType("hypothesis")
    _hyp_st = types.ModuleType("hypothesis.strategies")
    _hyp_st.integers = _st_integers
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _hyp_st
    _hyp.__stub__ = True
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _hyp_st
