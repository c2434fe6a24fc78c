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

The classic width is 1.  Under ``cost_model=True`` the width is measured:
the scatter launch is timed at ``s2_width_candidates`` (or the table the
``mixed`` strategy's executor already measured is read) and the width with
the least predicted time per wave is kept; width-w launches cover the
divisible span, width-1 launches the remainder.  Every width gives the
same values per task: the body is independent per slot.

Stats: per family, ``ctx.stats["regions"][desc]`` (``desc`` the
``TaskSignature`` key the aggregation executor would use) carries
``submitted``, ``launches``, ``aggregated_hist``, ``selected_strategy``,
``s2_width`` and, when measured, ``cost_model_paths``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.aggregation import (
    BucketCostModel, SlotView, TaskSignature, make_s2_scatter,
    measure_s2_widths, s2_width_candidates,
)
from repro_torch.core.strategies.base import (
    RunContext, Strategy, register_strategy,
)


def _measured_width(body, pop, ctx: RunContext, stats) -> int:
    """The coalesce width with the least predicted time for the
    population: from the executor's table for the family when the
    ``mixed`` strategy measured it at warmup, else timed here."""
    model = None
    exe = ctx.executor
    if exe is not None:
        region = exe._primary_region(pop.kernel)
        if region is not None and region.cost.measured("s2"):
            model = region.cost
    if model is None:
        model = BucketCostModel()
        for w, t in measure_s2_widths(
                body, pop.parents, s2_width_candidates(pop.n_tasks),
                samples=ctx.config.cost_samples, timer=ctx.timer).items():
            model.record(w, t, path="s2")
    if model.measured("s2"):
        stats["cost_model_paths"] = {"s2": model.as_stats("s2")}
    best = model.predict_s2_wave(pop.n_tasks)
    return 1 if best is None else best[0]


@register_strategy("s2")
class S2Strategy(Strategy):
    name = "s2"

    @staticmethod
    def _plan_for(scenario, pop, ctx: RunContext):
        """The launch plan of one (kernel, parent shapes): the width, the
        scatters by width, the output ring's shape and dtype, and the
        family's stats.  Built once per run."""
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
        width = (_measured_width(body, pop, ctx, stats)
                 if ctx.config.cost_model and pop.n_tasks else 1)
        stats["selected_strategy"] = "s2"
        stats["s2_width"] = width
        scatters = {w: make_s2_scatter(body, w) for w in {width, 1}}
        plan = (width, scatters, (spec.shape, spec.dtype), stats)
        ctx.caches[key] = plan
        return plan

    def launch_population(self, scenario, pop, ctx: RunContext):
        """Width-w launches over the divisible span, width-1 launches over
        the remainder, into a fresh output ring; returns the ring (the
        caller joins the pool before reading it)."""
        width, scatters, (shape, dtype), stats = self._plan_for(
            scenario, pop, ctx)
        device = pop.parents[0].device
        ring = (torch.full(shape, math.nan, dtype=dtype, device=device)
                if dtype.is_floating_point
                else torch.empty(shape, dtype=dtype, device=device))
        n = pop.n_tasks
        main = n - n % width
        for i in range(0, main, width):
            ctx.pool.get().launch(scatters[width], ring, i, *pop.parents,
                                  family=pop.kernel)
        for i in range(main, n):
            ctx.pool.get().launch(scatters[1], ring, i, *pop.parents,
                                  family=pop.kernel)
        launches = main // width + (n - main)
        ctx.stats["kernel_launches"] += launches
        stats["submitted"] += n
        stats["launches"] += launches
        hist = stats["aggregated_hist"]
        if main:
            hist[width] = hist.get(width, 0) + main // width
        if n - main:
            hist[1] = hist.get(1, 0) + (n - main)
        return ring

    def run_iteration(self, scenario, state, ctx: RunContext):
        outs = [self.launch_population(scenario, pop, ctx)
                for pop in scenario.populations(state)]
        ctx.pool.join()
        return scenario.assemble(state, outs)
