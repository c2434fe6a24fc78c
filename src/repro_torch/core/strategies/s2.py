"""``s2``: implicit aggregation — one launch per task, round-robin over the
executor pool's CUDA streams; the device is left to overlap them (the
paper's finding: it works iff the runtime can).

Each launch (``make_s2_scatter``) runs the family's batched body on one
task, ``parents[j].narrow(0, i, 1)``, and the body's kernel writes its
result straight into slot ``i`` of the population's output ring through
its ``out=`` — no staging copy and no concatenation.  Unlike the
reference's donated JAX carry, launches into disjoint slices are not
chained, so the streams really overlap; ``pool.join()`` orders the
caller's stream after every launch before ``assemble``.

The output ring is allocated per population and iteration from the
caching allocator (so it is recycled, not malloc'd), NaN-filled, and
sized by running the body on meta tensors.  It is not kept across
iterations: a state assembled from a single sub-grid is a view of its
ring, which a later iteration would overwrite.  Each launch records the
ring on its stream, so the allocator hands the block out again only after
every launch that writes it.

The classic width 1 is the only width.  The reference's measured width
selection under ``cost_model=True`` (``measure_s2_widths``,
``s2_width_candidates``) waits for the cost model (ROADMAP.md, Queue 1
item 8).

Stats: per family, ``ctx.stats["regions"][desc]`` (``desc`` the
``TaskSignature`` key the aggregation executor would use) carries
``submitted``, ``launches``, ``aggregated_hist``, ``selected_strategy`` and
``s2_width``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.aggregation import (
    SlotView, TaskSignature, make_s2_scatter,
)
from repro_torch.core.strategies.base import (
    RunContext, Strategy, register_strategy,
)

WIDTH = 1


@register_strategy("s2")
class S2Strategy(Strategy):
    name = "s2"

    @staticmethod
    def _plan_for(scenario, pop, ctx: RunContext):
        """The launch plan of one (kernel, parent shapes): the scatter, the
        output ring's shape and dtype, and the family's stats.  Built once
        per run."""
        shapes = tuple((tuple(p.shape), p.dtype) for p in pop.parents)
        key = ("s2_plan", pop.kernel, shapes)
        plan = ctx.caches.get(key)
        if plan is not None:
            return plan
        body = scenario.family(pop.kernel).batched_body
        spec = body(*(torch.empty(p.shape, dtype=p.dtype, device="meta")
                      for p in pop.parents))
        desc = TaskSignature.from_args(
            pop.kernel, [SlotView(p, 0) for p in pop.parents]).describe()
        stats = ctx.stats.setdefault("regions", {}).setdefault(
            desc, {"submitted": 0, "launches": 0, "aggregated_hist": {}})
        stats["selected_strategy"] = "s2"
        stats["s2_width"] = WIDTH
        plan = (make_s2_scatter(body, WIDTH), (spec.shape, spec.dtype),
                stats)
        ctx.caches[key] = plan
        return plan

    def launch_population(self, scenario, pop, ctx: RunContext):
        """One launch per task into a fresh output ring; returns the ring
        (the caller joins the pool before reading it)."""
        scatter, (shape, dtype), stats = self._plan_for(scenario, pop, ctx)
        device = pop.parents[0].device
        ring = (torch.full(shape, math.nan, dtype=dtype, device=device)
                if dtype.is_floating_point
                else torch.empty(shape, dtype=dtype, device=device))
        n = pop.n_tasks
        for i in range(0, n, WIDTH):
            ctx.pool.get().launch(scatter, ring, i, *pop.parents,
                                  family=pop.kernel)
        launches = n // WIDTH
        ctx.stats["kernel_launches"] += launches
        stats["submitted"] += n
        stats["launches"] += launches
        if launches:
            hist = stats["aggregated_hist"]
            hist[WIDTH] = hist.get(WIDTH, 0) + launches
        return ring

    def run_iteration(self, scenario, state, ctx: RunContext):
        outs = [self.launch_population(scenario, pop, ctx)
                for pop in scenario.populations(state)]
        ctx.pool.join()
        return scenario.assemble(state, outs)
