"""Work-aggregation strategy plugins (the paper's S1 / S2 / S3 and combos).

* ``s1``   — larger sub-problems: not a runtime mode but a *config* (16^3
             sub-grids, ``repro_torch.configs.sedov.CONFIG_16``), run under
             any strategy; ``AggregationConfig(strategy="s1")`` says so.
* ``s2``   — implicit aggregation (``s2.py``): one launch per task (or per
             measured coalesce width), round-robin over the pool's CUDA
             streams, into an output ring.
* ``s3``   — explicit aggregation (``s3.py``): tasks fused on the fly into
             bucketed launches of the batched kernel by the
             ``AggregationExecutor``.
* ``s2+s3``— s3 over a pool of several CUDA streams (the paper's best rows).
* ``mixed``— per-family routing (``mixed.py``): each kernel family goes to
             s2, s3 or fused, explicitly (``family_strategies``) or by the
             measured cost model.
* ``fused``— whole-graph upper bound (``fused.py``).
* ``s4`` / ``sharded`` — ``s3``'s submission through the
             ``ShardedAggregationExecutor`` (``s4.py``) over a mesh of
             devices (DESIGN.md §15).

All strategies are bit-identical in results to the scenario's fused
reference; only the launch structure differs.
"""
from repro_torch.core.strategies.base import (
    RunContext, Strategy, available_strategies, get_strategy_class,
    register_strategy,
)
from repro_torch.core.strategies import (  # noqa: F401 (register)
    fused, mixed, s2, s3, s4,
)
from repro_torch.core.strategies.runner import (
    AMRStrategyRunner, HydroStrategyRunner, StrategyRunner,
)

__all__ = [
    "RunContext", "Strategy", "available_strategies", "get_strategy_class",
    "register_strategy", "StrategyRunner", "s2", "AMRStrategyRunner",
    "HydroStrategyRunner",
]
