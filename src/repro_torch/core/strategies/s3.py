"""``s3`` / ``s2+s3``: explicit on-the-fly aggregation through the
``AggregationExecutor``.

Under device staging each population is submitted as ONE bulk range entry
(``TaskPopulation.submit_to`` -> ``AggregationExecutor.submit_range``); the
executor drains it greedily through its bucket ladder, each launch reading
a contiguous slot run of the parent in place, and ``gather_futures`` hands
the range back (no copy when one launch covered it).  Under
``staging="host"`` (the seed's baseline) every task is submitted on its
own, one per family in turn, and each bucket is stacked at launch.
``s2+s3`` is the same strategy over a pool of several CUDA streams (the
paper's best rows).

On the card each population is written in place: the scenario extracts
it straight into the executor's static parents
(``AggregationExecutor.population_buffers``), which the bucket graphs read
where they are, so no launch copies its parents first.

``run_stage`` drives a whole RK stage through the scenario's epilogue-fused
stage families (device staging only); a stage wave may carry several
families (the AMR levels' twins, or gravity's hydro twin beside the plain
gravity family), coupled by ``assemble_stage``.  Stats report per-call
deltas of the executor's cumulative counters.
"""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.core.aggregation import gather_futures
from repro_torch.core.faults import LaunchTimeoutError, TaskFailedError
from repro_torch.core.strategies.base import (
    RunContext, Strategy, register_strategy,
)


@register_strategy("s3", "s2+s3")
class S3Strategy(Strategy):
    name = "s3"
    uses_executor = True

    @staticmethod
    def _submit_populations(exe, pops, host: bool):
        """One wave: a range per population (device staging), or one
        submission per task, round-robin across kernel families (host
        staging)."""
        with tracing.span("repro_torch.agg.submit"):
            futs = [[] for _ in pops]
            if not host:
                for pi, pop in enumerate(pops):
                    if pop.n_tasks:
                        futs[pi].append(pop.submit_to(exe))
                return futs
            # each family's populations as one ordered task list, then one
            # submission per family per turn
            lanes = {}
            for pi, pop in enumerate(pops):
                lanes.setdefault(pop.kernel, []).extend(
                    (pi, pop, i) for i in range(pop.n_tasks))
            cursors = [iter(lane) for lane in lanes.values()]
            while cursors:
                live = []
                for cur in cursors:
                    nxt = next(cur, None)
                    if nxt is None:
                        continue
                    pi, pop, i = nxt
                    futs[pi].append(exe.submit(
                        *(par[i] for par in pop.parents), kernel=pop.kernel))
                    live.append(cur)
                cursors = live
            return futs

    @staticmethod
    def _drain(scenario, exe, pops, futs):
        """Flush the wave and gather each population's outputs; an empty
        population yields a zero-length batch of the body's output shape.
        A watchdog timeout names the wave's families; a failed task is
        named in the scenario's words (``describe_task``)."""
        try:
            exe.flush()
        except LaunchTimeoutError as err:
            # a real stall caught at flush: its futures were fulfilled
            # already, so it cannot be retried here
            fams = sorted({pop.kernel for pop in pops if pop.n_tasks})
            raise LaunchTimeoutError(
                f"watchdog timeout while draining wave of families "
                f"{fams}: {err}") from err
        with tracing.span("repro_torch.agg.gather"):
            outs = []
            for pop, f in zip(pops, futs):
                if f:
                    try:
                        outs.append(gather_futures(f))
                    except TaskFailedError as err:
                        what = ", ".join(
                            scenario.describe_task(pop.kernel, tid)
                            for tid in err.task_ids) or "unknown task"
                        raise TaskFailedError(
                            f"{what} failed during aggregated execution: "
                            f"{err}", task_ids=err.task_ids,
                            kernel=pop.kernel) from err
                    continue
                body = scenario.family(pop.kernel).batched_body
                spec = body(*(torch.empty(p.shape, dtype=p.dtype,
                                          device="meta")
                              for p in pop.parents))
                outs.append(torch.empty(spec.shape, dtype=spec.dtype,
                                        device=pop.parents[0].device))
            return outs

    def _wave(self, scenario, pops, ctx: RunContext, host: bool):
        exe = ctx.executor
        before_launches = exe.stats["launches"]
        before_staging = exe.stats["staging_s"]
        futs = self._submit_populations(exe, pops, host)
        outs = self._drain(scenario, exe, pops, futs)
        ctx.stats["staging_s"] += exe.stats["staging_s"] - before_staging
        ctx.stats["kernel_launches"] += (exe.stats["launches"]
                                         - before_launches)
        return outs

    def run_iteration(self, scenario, state, ctx: RunContext):
        exe = ctx.executor
        buffers = exe.population_buffers if exe.writes_in_place else None
        with tracing.span("repro_torch.scenario.populations"):
            pops = (scenario.populations(state, buffers=buffers) if buffers
                    else scenario.populations(state))
        outs = self._wave(scenario, pops, ctx,
                          host=ctx.config.staging == "host")
        with tracing.span("repro_torch.scenario.assemble"):
            return scenario.assemble(state, outs)

    def run_stage(self, scenario, u0, v, dt, c0, c1, ctx: RunContext):
        if ctx.config.staging == "host":
            return None                  # the baseline stays per task
        with tracing.span("repro_torch.scenario.populations"):
            pops = scenario.stage_populations(u0, v, dt, c0, c1)
        if pops is None:
            return None
        outs = self._wave(scenario, pops, ctx, host=False)
        with tracing.span("repro_torch.scenario.assemble"):
            return scenario.assemble_stage(v, outs, dt, c0, c1)
