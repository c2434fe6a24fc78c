"""The execution facade: ``StrategyRunner(scenario, agg, device=...)``.

The runner owns the executor pool (one CUDA stream per executor on the
card), the aggregation executor with every scenario family registered
(strategies that use one), the stats, and the scenario-agnostic loops:
RK3 stepping, warmup and per-step timing.  A state is a tensor, or a tuple
of tensors (one per AMR level) combined level by level.  The device
defaults to the card and a missing card raises; ``device="cpu"`` runs the
plain PyTorch path.

With ``AggregationConfig(fuse_epilogue=True)`` each RK stage runs through
the scenario's epilogue-fused stage families (``Strategy.run_stage``),
decided at construction: only when the scenario declares stage families,
the strategy has a ``run_stage`` and staging is on the device.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import AggregationConfig
from repro_torch.core.aggregation import AggregationExecutor
from repro_torch.core.executor import ExecutorPool
from repro_torch.core.scenario import Scenario
from repro_torch.core.strategies.base import (
    RunContext, Strategy, get_strategy_class,
)
from repro_torch.device import DeviceLike, resolve_device


def per_level(fn: Callable, *states):
    """``fn`` over a tensor state, or level by level over tuple states."""
    if isinstance(states[0], tuple):
        return tuple(fn(*levels) for levels in zip(*states))
    return fn(*states)


class StrategyRunner:
    """Drives a :class:`~repro_torch.core.scenario.Scenario` under a
    registered strategy.  ``stats["kernel_launches"]`` and
    ``stats["iterations"]`` accumulate per call; ``stats["regions"]`` is
    the per-family launch statistics: the aggregation executor's bucket
    histograms, or those ``s2`` publishes itself."""

    def __init__(self, scenario: Scenario, agg: AggregationConfig,
                 device: DeviceLike = None):
        strategy_cls = get_strategy_class(agg.strategy)   # fail fast
        self.device = resolve_device(device)
        self.scenario = scenario
        self.agg = agg
        self.strategy = agg.strategy
        self._strategy = strategy_cls()
        self.pool = ExecutorPool(agg.n_executors, device=self.device)
        self._agg_exec: Optional[AggregationExecutor] = None
        self.stats: Dict[str, Any] = {"kernel_launches": 0, "iterations": 0,
                                      "staging_s": 0.0, "regions": {}}
        if strategy_cls.uses_executor:
            self._agg_exec = AggregationExecutor(
                None, agg, pool=self.pool, name=scenario.name,
                device=self.device)
            for fam in scenario.families() + tuple(
                    scenario.stage_families()):
                self._agg_exec.register(fam.kernel, fam.batched_body)
            self.stats["regions"] = self._agg_exec.stats["regions"]
        self.ctx = RunContext(config=agg, pool=self.pool,
                              executor=self._agg_exec, stats=self.stats)
        has_stage = strategy_cls.run_stage is not Strategy.run_stage
        self._fuse_epilogue = (agg.fuse_epilogue
                               and bool(scenario.stage_families())
                               and has_stage and agg.staging != "host")

    @property
    def fuse_epilogue(self) -> bool:
        """Whether RK stages run through the epilogue-fused stage path."""
        return self._fuse_epilogue

    @property
    def executor(self) -> Optional[AggregationExecutor]:
        """The aggregation executor (s3 / s2+s3), else None."""
        return self._agg_exec

    @property
    def launches_by_family(self) -> dict:
        """The pool's launch counts per kernel family (executor strategies;
        ``fused`` launches outside the pool)."""
        return self.pool.launches_by_family

    def warmup(self) -> None:
        """Launch every family's bucket ladder once at the shapes of the
        scenario's submission waves (executor strategies), or each family's
        body once over its whole wave (``fused``, ``s2``).  On the fused
        stage path only the stage waves are warmed: the plain families
        never launch there.  Builds the CUDA kernel at first use."""
        specs_of = (self.scenario.stage_warmup_parent_specs
                    if self._fuse_epilogue
                    else self.scenario.warmup_parent_specs)
        seen = set()
        for kernel, specs in specs_of():
            key = (kernel, specs)
            if key in seen:
                continue
            seen.add(key)
            if self._agg_exec is not None:
                self._agg_exec.warmup(specs, kernel=kernel)
                continue
            parents = [torch.zeros(shape, dtype=dtype, device=self.device)
                       for shape, dtype in specs]
            self.scenario.family(kernel).batched_body(*parents)
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _check_state(self, state) -> None:
        for u in state if isinstance(state, tuple) else (state,):
            if u.device != self.device:
                raise ValueError(f"state lives on {u.device}, the runner "
                                 f"on {self.device}")

    # -- one solver iteration ----------------------------------------------
    def rhs(self, state):
        self._check_state(state)
        self.stats["iterations"] += 1
        return self._strategy.run_iteration(self.scenario, state, self.ctx)

    # -- RK3 (three iterations per time-step, as in the paper) -------------
    def rk3_step(self, state, dt):
        """Shu-Osher TVD-RK3 over a tensor or a tuple of levels, each level
        combined in the same expression order (``hydro.stepper``'s
        ``rk3_step`` and ``amr_rk3_step``), or through the fused stages.
        ``dt`` is a float or a 0-dim tensor (e.g. ``courant_dt``'s, which
        stays on the device)."""
        if self._fuse_epilogue:
            out = self._rk3_step_fused_stages(state, dt)
            if out is not None:
                return out
        l0 = self.rhs(state)
        u1 = per_level(lambda u, l: u + dt * l, state, l0)
        l1 = self.rhs(u1)
        u2 = per_level(lambda u, a, l: 0.75 * u + 0.25 * (a + dt * l),
                       state, u1, l1)
        l2 = self.rhs(u2)
        out = per_level(
            lambda u, a, l: (1.0 / 3.0) * u + (2.0 / 3.0) * (a + dt * l),
            state, u2, l2)
        return self.scenario.finalize_step(out)

    def _rk3_step_fused_stages(self, state, dt):
        """RK3 through the epilogue-fused stage path: each Shu-Osher stage
        is one submission wave of the scenario's stage families, the body
        and the stage update in one launch per bucket.  Returns None (the
        generic path follows) when the strategy's ``run_stage`` declines."""
        self._check_state(state)
        stage = self._strategy.run_stage
        sc = self.scenario
        u1 = stage(sc, state, state, dt, 0.0, 1.0, self.ctx)
        if u1 is None:
            self._fuse_epilogue = False
            return None
        u2 = stage(sc, state, u1, dt, 0.75, 0.25, self.ctx)
        out = stage(sc, state, u2, dt, 1.0 / 3.0, 2.0 / 3.0, self.ctx)
        self.stats["iterations"] += 3
        return sc.finalize_step(out)

    def time_step(self, state, dt, n_steps: int = 1) -> float:
        """Average wall seconds per time-step (the Table III metric), the
        device synchronised before and after."""
        self._sync()
        t0 = time.perf_counter()
        out = state
        for _ in range(n_steps):
            out = self.rk3_step(out, dt)
        self._sync()
        return (time.perf_counter() - t0) / n_steps
