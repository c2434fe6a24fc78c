"""``s3`` / ``s2+s3``: explicit on-the-fly aggregation through the
``AggregationExecutor``.

Each population is submitted as ONE bulk range entry
(``TaskPopulation.submit_to`` -> ``AggregationExecutor.submit_range``); the
executor drains it greedily through its bucket ladder, each launch reading
a contiguous slot run of the parent in place, and ``gather_futures`` hands
the range back (no copy when one launch covered it).  ``s2+s3`` is the same
strategy over a pool of several CUDA streams (the paper's best rows).
Stats report per-call deltas of the executor's cumulative counters.
"""
from __future__ import annotations

from repro_torch.core.aggregation import gather_futures
from repro_torch.core.strategies.base import (
    RunContext, Strategy, register_strategy,
)


@register_strategy("s3", "s2+s3")
class S3Strategy(Strategy):
    name = "s3"
    uses_executor = True

    def run_iteration(self, scenario, state, ctx: RunContext):
        exe = ctx.executor
        pops = scenario.populations(state)
        before_launches = exe.stats["launches"]
        before_staging = exe.stats["staging_s"]
        futs = [pop.submit_to(exe) for pop in pops]
        exe.flush()
        outs = [gather_futures([f]) for f in futs]
        ctx.stats["staging_s"] += exe.stats["staging_s"] - before_staging
        ctx.stats["kernel_launches"] += (exe.stats["launches"]
                                         - before_launches)
        return scenario.assemble(state, outs)
