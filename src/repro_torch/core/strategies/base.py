"""Strategy plugin base: the registry, the ``Strategy`` interface and the
shared ``RunContext``.

A strategy decides HOW a scenario's task populations launch; it is
registered by name and implements ``run_iteration(scenario, state, ctx)``.
``StrategyRunner`` resolves names at construction, so an unknown strategy
fails fast with the valid names listed.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, ClassVar, Dict, Optional, Tuple, Type

from repro_torch.configs.base import AggregationConfig
from repro_torch.core.aggregation import AggregationExecutor
from repro_torch.core.executor import ExecutorPool

_REGISTRY: Dict[str, Type["Strategy"]] = {}


def register_strategy(*names: str):
    """Class decorator: register a Strategy under one or more names."""
    def deco(cls: Type["Strategy"]) -> Type["Strategy"]:
        for name in names:
            _REGISTRY[name] = cls
        return cls
    return deco


def available_strategies() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_strategy_class(name: str) -> Type["Strategy"]:
    """Resolve a strategy name, failing fast with the valid names listed."""
    cls = _REGISTRY.get(name)
    if cls is None:
        raise ValueError(
            f"unknown strategy {name!r} — valid strategies: "
            f"{', '.join(available_strategies())}")
    return cls


@dataclass
class RunContext:
    """What a strategy shares across iterations: the launch config, the
    executor pool, the (optional) aggregation executor, the stats, a
    private per-run cache (``s2``'s launch plans, ``mixed``'s routes) and
    the launch timer of measured choices (None: ``LaunchTimer``)."""

    config: AggregationConfig
    pool: ExecutorPool
    executor: Optional[AggregationExecutor]
    stats: Dict[str, Any]
    caches: Dict[Any, Any] = field(default_factory=dict)
    timer: Optional[Callable] = None


class Strategy:
    """One launch structure, stateless by convention.  ``uses_executor``
    tells the runner to build an aggregation executor with the scenario's
    families registered; ``executor_cls`` picks its class (None: the
    ``AggregationExecutor``; ``s4`` the ``ShardedAggregationExecutor``,
    which takes the same constructor)."""

    name: ClassVar[str] = ""
    uses_executor: ClassVar[bool] = False
    executor_cls: ClassVar[Optional[type]] = None

    def run_iteration(self, scenario, state, ctx: RunContext):
        """One solver iteration: launch every population, assemble
        d(state)/dt."""
        raise NotImplementedError

    def run_stage(self, scenario, u0, v, dt, c0, c1, ctx: RunContext):
        """One epilogue-fused RK stage: launch the scenario's stage
        populations and return the next stage's state.  ``None``: this
        strategy has no fused-stage path, and the runner takes
        ``run_iteration`` and the generic combine."""
        return None
