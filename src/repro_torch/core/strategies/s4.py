"""``s4`` / ``sharded``: explicit aggregation over a mesh of cards.

The submission is ``s3``'s (this class subclasses :class:`S3Strategy`):
one bulk range per population.  What changes is the executor:
``executor_cls`` is the
:class:`~repro_torch.core.sharding.ShardedAggregationExecutor`, and
``_drain`` ends with its ``ghost_gather``, the reference's one collective
per family per wave.  The mesh is ``StrategyRunner(mesh=)`` or
``shard_devices`` cards; ``s4`` equals ``s3`` bit for bit on any mesh
(DESIGN.md §15).
"""
from __future__ import annotations

from repro_torch.core.sharding import ShardedAggregationExecutor
from repro_torch.core.strategies.base import register_strategy
from repro_torch.core.strategies.s3 import S3Strategy


@register_strategy("s4", "sharded")
class S4Strategy(S3Strategy):
    name = "s4"
    uses_executor = True
    executor_cls = ShardedAggregationExecutor

    def _drain(self, scenario, exe, pops, futs):
        outs = super()._drain(scenario, exe, pops, futs)
        return [exe.ghost_gather(o) for o in outs]
