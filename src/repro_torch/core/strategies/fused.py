"""``fused``: the whole-graph upper bound — one launch per family over its
whole population.  It runs the scenario's own reference paths
(``reference_rhs``, and ``reference_stage`` for a fused stage), so it IS
the bit-exact reference by construction."""
from __future__ import annotations

from repro_torch.core.strategies.base import (
    RunContext, Strategy, register_strategy,
)


@register_strategy("fused")
class FusedStrategy(Strategy):
    name = "fused"

    def run_iteration(self, scenario, state, ctx: RunContext):
        pops = scenario.populations(state)
        outs = [scenario.family(p.kernel).batched_body(*p.parents)
                for p in pops]
        ctx.stats["kernel_launches"] += len(pops)
        return scenario.assemble(state, outs)

    def run_stage(self, scenario, u0, v, dt, c0, c1, ctx: RunContext):
        pops = scenario.stage_populations(u0, v, dt, c0, c1)
        if pops is None:
            return None
        outs = [scenario.family(p.kernel).batched_body(*p.parents)
                for p in pops]
        ctx.stats["kernel_launches"] += len(pops)
        return scenario.assemble_stage(v, outs, dt, c0, c1)
