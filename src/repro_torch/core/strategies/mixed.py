"""``mixed``: per-family strategy routing.

Octo-Tiger does not force one launch strategy on every kernel type: the
hydro solver aggregates while gravity runs fused.  This strategy routes
each kernel family of a wave on its own to

* ``"s3"``    — bucketed aggregation through the shared
                ``AggregationExecutor`` (ranges submitted, ladder drained);
* ``"s2"``    — one scatter launch per task, or per measured coalesce
                width (``S2Strategy.launch_population``);
* ``"fused"`` — one whole-family launch on an executor stream.

The route comes from ``AggregationConfig(family_strategies=...)`` (the
exact kernel id, the ``+epi`` twin's base kernel, or ``"*"``); a missing
or ``"auto"`` entry takes the executor's ``select_strategy``, the
cheapest of the measured ``s2``, ``s3`` and ``fused`` times (``s3`` before
any measurement).  Routes resolve once per run and go into
``stats["regions"][fam]["selected_strategy"]`` with the costs behind them.

Every route runs the family's same batched body; only the batch
decomposition differs, so every assignment is bit-identical to ``fused``.

Containment: a family whose circuit breaker is not closed runs under
``s3`` for that wave (only the executor has the bucket-1 floor and
bisection), its cached route kept for when the breaker closes.  The
``s2`` and ``fused`` routes have no bucket to bisect: injected payload
faults fire on them too (the same schedule, wave-relative task ids), and
under ``guard="finite"`` a non-finite output raises
``NonFiniteStateError`` naming the family and its route.
"""
from __future__ import annotations

from repro_torch import tracing
from repro_torch.configs.base import resolve_family_option
from repro_torch.core.aggregation import SlotView, TaskSignature
from repro_torch.core.faults import (
    NonFiniteStateError, all_finite, poison_slots,
)
from repro_torch.core.strategies.base import (
    RunContext, Strategy, register_strategy,
)
from repro_torch.core.strategies.s2 import S2Strategy
from repro_torch.core.strategies.s3 import S3Strategy


@register_strategy("mixed")
class MixedStrategy(Strategy):
    name = "mixed"
    uses_executor = True

    def __init__(self):
        self._s2 = S2Strategy()
        self._s3 = S3Strategy()

    # -- routing -----------------------------------------------------------
    def _route(self, kernel: str, ctx: RunContext) -> str:
        if ctx.executor.breaker_state(kernel) != "closed":
            # breaker override for this wave; the cached route stays
            return "s3"
        key = ("mixed_route", kernel)
        choice = ctx.caches.get(key)
        if choice is not None:
            return choice
        choice = resolve_family_option(ctx.config.family_strategies, kernel,
                                       "auto")
        if choice == "auto":
            choice = ctx.executor.select_strategy(kernel)
        else:
            ctx.executor.record_selection(kernel, choice)
        ctx.caches[key] = choice
        return choice

    def routes(self, scenario, ctx: RunContext) -> dict:
        """The resolved route (kernel -> strategy) of every family the
        scenario can launch."""
        kernels = [f.kernel for f in scenario.families()]
        kernels += [f.kernel for f in scenario.stage_families()]
        return {k: self._route(k, ctx) for k in kernels}

    # -- one wave ----------------------------------------------------------
    def _run_wave(self, scenario, pops, ctx: RunContext):
        """Route one wave: the ``s3`` populations enter the executor as
        ranges first (their queues fill while the other routes launch),
        then the ``s2`` and ``fused`` populations launch on the pool, then
        the executor drains and joins every stream.  Outputs come back in
        population order."""
        exe = ctx.executor
        routes = [self._route(pop.kernel, ctx) for pop in pops]
        before_launches = exe.stats["launches"]
        before_staging = exe.stats["staging_s"]
        s3_idx = [i for i, r in enumerate(routes) if r == "s3"]
        s3_pops = [pops[i] for i in s3_idx]
        futs = self._s3._submit_populations(
            exe, s3_pops, host=ctx.config.staging == "host")
        outs = [None] * len(pops)
        with tracing.span("repro_torch.agg.submit"):
            for i, (pop, route) in enumerate(zip(pops, routes)):
                if route == "s2":
                    outs[i] = self._s2.launch_population(scenario, pop, ctx)
                elif route == "fused":
                    outs[i] = self._launch_fused(scenario, pop, ctx)
        for i, out in zip(s3_idx, self._s3._drain(scenario, exe, s3_pops,
                                                  futs)):
            outs[i] = out
        ctx.stats["staging_s"] += exe.stats["staging_s"] - before_staging
        ctx.stats["kernel_launches"] += (exe.stats["launches"]
                                         - before_launches)
        self._audit(pops, routes, outs, ctx)
        return outs

    @staticmethod
    def _audit(pops, routes, outs, ctx: RunContext) -> None:
        """Fault injection and the guard's tripwire for the ``s2`` and
        ``fused`` routes (the ``s3`` ones are audited in the executor's
        flush), after the drain joined every stream: the poison is a copy
        made on the caller's stream."""
        exe = ctx.executor
        injector = exe._injector
        guard = ctx.config.guard == "finite"
        if injector is None and not guard:
            return
        for i, (pop, route) in enumerate(zip(pops, routes)):
            if route == "s3" or outs[i] is None:
                continue
            if injector is not None:
                wave_key = ("mixed_wave", pop.kernel)
                wave = ctx.caches.get(wave_key, 0)
                ctx.caches[wave_key] = wave + 1
                poisons = injector.poison_positions(
                    pop.kernel, wave, list(range(pop.n_tasks)))
                if poisons:
                    outs[i] = poison_slots(outs[i], sorted(poisons), poisons)
            if guard and not all_finite(outs[i]):
                raise NonFiniteStateError(
                    f"non-finite output in family {pop.kernel!r} routed to "
                    f"{route!r} under 'mixed' — only aggregated (s3-routed) "
                    f"families can bisect; assign the family to 's3' in "
                    f"family_strategies to isolate the task")

    @staticmethod
    def _launch_fused(scenario, pop, ctx: RunContext):
        """The whole population as one launch on a pool stream, counted
        under the family's ``TaskSignature`` key as the executor and
        ``s2`` count theirs."""
        out = ctx.pool.get().launch(scenario.family(pop.kernel).batched_body,
                                    *pop.parents, family=pop.kernel)
        ctx.stats["kernel_launches"] += 1
        key = ("mixed_desc", pop.kernel,
               tuple((tuple(p.shape), p.dtype) for p in pop.parents))
        desc = ctx.caches.get(key)
        if desc is None:
            desc = TaskSignature.from_args(
                pop.kernel, [SlotView(p, 0) for p in pop.parents]).describe()
            ctx.caches[key] = desc
        stats = ctx.stats.setdefault("regions", {}).setdefault(
            desc, {"submitted": 0, "launches": 0, "aggregated_hist": {}})
        stats["submitted"] += pop.n_tasks
        stats["launches"] += 1
        hist = stats["aggregated_hist"]
        hist[pop.n_tasks] = hist.get(pop.n_tasks, 0) + 1
        stats.setdefault("selected_strategy", "fused")
        return out

    # -- strategy protocol -------------------------------------------------
    def run_iteration(self, scenario, state, ctx: RunContext):
        with tracing.span("repro_torch.scenario.populations"):
            pops = scenario.populations(state)
        outs = self._run_wave(scenario, pops, ctx)
        with tracing.span("repro_torch.scenario.assemble"):
            return scenario.assemble(state, outs)

    def run_stage(self, scenario, u0, v, dt, c0, c1, ctx: RunContext):
        if ctx.config.staging == "host":
            return None                  # the baseline stays per task
        with tracing.span("repro_torch.scenario.populations"):
            pops = scenario.stage_populations(u0, v, dt, c0, c1)
        if pops is None:
            return None
        outs = self._run_wave(scenario, pops, ctx)
        with tracing.span("repro_torch.scenario.assemble"):
            return scenario.assemble_stage(v, outs, dt, c0, c1)
