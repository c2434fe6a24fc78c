"""The execution facade: ``StrategyRunner(scenario, agg, device=...)``.

The runner owns the executor pool (one CUDA stream per executor on the
card), the aggregation executor with every scenario family registered
(strategies that use one), the stats, and the scenario-agnostic loops:
RK3 stepping, warmup, per-step timing, whole trajectories (one
CUDA graph per trajectory under ``fused`` on the card) and the
crash-consistent ``run`` / ``resume`` (``repro_torch.checkpoint``).  A
state is a tensor, or a tuple of tensors (one per AMR level) combined
level by level.  The device defaults to the card and a missing card
raises; ``device="cpu"`` runs the plain PyTorch path.

With ``AggregationConfig(fuse_epilogue=True)`` each RK stage runs through
the scenario's epilogue-fused stage families (``Strategy.run_stage``),
decided at construction: only when the scenario declares stage families,
the strategy has a ``run_stage`` and staging is on the device.

Measured tuning lives in the aggregation executor: under ``autotune`` each
family re-derives its ladder after ``autotune_warmup`` waves, and
``stats["regions"][fam]`` carries its ``cost_model`` table and, under
``mixed``, its ``selected_strategy``.  With a tune store
(``AggregationConfig(tune_store=)`` or ``warmup(store=)``) warmup restores
each family's tuned state, and ``save_tuning`` (also at every checkpoint
of ``run``) writes it, so a second or resumed process warm-starts.

Containment (``guard="finite"``, ``fault_injector=``) lives there too;
the executor-less strategies (``fused``, ``s2``) have no bucket to bisect,
so under the guard ``rhs`` checks the whole iteration instead and raises
``NonFiniteStateError``.  ``rk3_trajectory`` is never guarded: it runs
``reference_rhs``, as the reference does.
"""
from __future__ import annotations

import time
import warnings
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import tracing
from repro_torch.checkpoint.ckpt import (
    latest_step, restore_checkpoint, save_checkpoint,
)
from repro_torch.configs.base import (
    AggregationConfig, AMRHydroConfig, HydroConfig,
)
from repro_torch.core.aggregation import (
    AggregationExecutor, greedy_decomposition,
)
from repro_torch.core.executor import ExecutorPool
from repro_torch.core.faults import (
    FaultInjector, NonFiniteStateError, all_finite,
)
from repro_torch.core.graphs import CapturedCall
from repro_torch.core.scenario import (
    AMRSedovScenario, Scenario, UniformSedovScenario,
)
from repro_torch.core.strategies.base import (
    RunContext, Strategy, get_strategy_class,
)
from repro_torch.device import DeviceLike, resolve_device


def per_level(fn: Callable, *states):
    """``fn`` over a tensor state, or level by level over tuple states."""
    if isinstance(states[0], tuple):
        return tuple(fn(*levels) for levels in zip(*states))
    return fn(*states)


def shu_osher(rhs: Callable, state, dt):
    """One Shu-Osher TVD-RK3 combine over ``rhs``, before
    ``finalize_step``: each level combined in the expression order of
    ``hydro.stepper``'s ``rk3_step`` and ``amr_rk3_step``."""
    l0 = rhs(state)
    u1 = per_level(lambda u, l: u + dt * l, state, l0)
    l1 = rhs(u1)
    u2 = per_level(lambda u, a, l: 0.75 * u + 0.25 * (a + dt * l),
                   state, u1, l1)
    l2 = rhs(u2)
    return per_level(
        lambda u, a, l: (1.0 / 3.0) * u + (2.0 / 3.0) * (a + dt * l),
        state, u2, l2)


class StrategyRunner:
    """Drives a :class:`~repro_torch.core.scenario.Scenario` under a
    registered strategy.  ``stats["kernel_launches"]`` and
    ``stats["iterations"]`` accumulate per call; ``stats["regions"]`` is
    the per-family launch statistics: the aggregation executor's bucket
    histograms, or those ``s2`` publishes itself.  ``timer`` times the
    launches of measured choices (see ``AggregationExecutor``);
    ``fault_injector`` goes to the aggregation executor, and ``mesh``
    (``s4`` only) to the sharded executor, whose default mesh is
    ``agg.shard_devices`` cards."""

    def __init__(self, scenario: Scenario, agg: AggregationConfig,
                 device: DeviceLike = None,
                 timer: Optional[Callable] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 mesh=None):
        strategy_cls = get_strategy_class(agg.strategy)   # fail fast
        self._validate_family_strategies(scenario, agg)
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
            exe_cls = strategy_cls.executor_cls or AggregationExecutor
            kw = {} if mesh is None else {"mesh": mesh}
            self._agg_exec = exe_cls(
                None, agg, pool=self.pool, name=scenario.name,
                device=self.device, timer=timer,
                fault_injector=fault_injector, **kw)
            for fam in scenario.families() + tuple(
                    scenario.stage_families()):
                self._agg_exec.register(fam.kernel, fam.batched_body)
            self.stats["regions"] = self._agg_exec.stats["regions"]
        self.ctx = RunContext(config=agg, pool=self.pool,
                              executor=self._agg_exec, stats=self.stats,
                              timer=timer)
        has_stage = strategy_cls.run_stage is not Strategy.run_stage
        self._fuse_epilogue = (agg.fuse_epilogue
                               and bool(scenario.stage_families())
                               and has_stage and agg.staging != "host")
        # (n_steps, level shapes and dtypes, dt dtype) -> the trajectory's
        # CUDA graph (``fused`` on the card); at most one entry, a new key
        # replaces the old graph and frees its memory pool
        self.trajectory_graphs: Dict[Any, CapturedCall] = {}

    @staticmethod
    def _validate_family_strategies(scenario: Scenario,
                                    agg: AggregationConfig) -> None:
        """Fail fast on a ``family_strategies`` key that is no kernel the
        scenario can launch (plain or stage family) nor ``"*"`` (the config
        checks the values)."""
        known = {f.kernel for f in scenario.families()}
        known |= {f.kernel for f in scenario.stage_families()}
        for kernel in agg.family_strategies or {}:
            if kernel not in known | {"*"}:
                raise ValueError(
                    f"family_strategies key {kernel!r} names no kernel "
                    f"family of scenario {scenario.name!r} — known "
                    f"families: {sorted(known)} (or '*')")

    def set_fault_injector(self,
                           injector: Optional[FaultInjector]) -> None:
        """Attach (or detach) a fault schedule to the aggregation executor
        (executor strategies; the others have no injection site)."""
        if self._agg_exec is not None:
            self._agg_exec.set_fault_injector(injector)

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

    def warmup(self, wave_only: bool = False,
               store: Optional[Any] = None) -> None:
        """Launch every family's bucket ladder once at the shapes of the
        scenario's submission waves (executor strategies), or each family's
        body once over its whole wave (``fused``, ``s2``).  On the fused
        stage path only the stage waves are warmed: the plain families
        never launch there.  Builds the CUDA kernel at first use, and
        under ``cost_model=True`` times the buckets warmed.
        ``wave_only=True`` warms only the buckets of a full wave's greedy
        decomposition under the config's ladder.  ``store`` (a path or a
        ``TuneStore``, else the config's ``tune_store``) restores each
        family's tuned state from the store, measuring nothing for it
        (executor strategies; the others have no tuned state)."""
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
                buckets = None
                if wave_only:
                    wave = min(shape[0] for shape, _ in specs)
                    buckets = sorted(set(greedy_decomposition(
                        wave, self._agg_exec.config.bucket_sizes())))
                self._agg_exec.warmup(specs, kernel=kernel, buckets=buckets,
                                      store=store)
                continue
            parents = [torch.zeros(shape, dtype=dtype, device=self.device)
                       for shape, dtype in specs]
            self.scenario.family(kernel).batched_body(*parents)
        self._sync()

    def save_tuning(self, store: Optional[Any] = None) -> Optional[str]:
        """Write every tuned family's state into the tune store (the
        config's, or ``store``); the store file's path, or None (no store,
        or an executor-less strategy)."""
        if self._agg_exec is None:
            return None
        return self._agg_exec.save_tuning(store)

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
        with tracing.span("repro_torch.stage"):
            out = self._strategy.run_iteration(self.scenario, state,
                                               self.ctx)
        if self.agg.guard == "finite" and self._agg_exec is None:
            # executor-less strategies have no per-bucket containment: the
            # guard is a whole-iteration tripwire (one host read)
            if not all_finite(out):
                raise NonFiniteStateError(
                    f"non-finite rhs output under strategy "
                    f"{self.strategy!r} (iteration "
                    f"{self.stats['iterations']}); executor-less strategies "
                    f"cannot bisect — rerun under s3 to isolate the task")
        return out

    # -- RK3 (three iterations per time-step, as in the paper) -------------
    def rk3_step(self, state, dt):
        """Shu-Osher TVD-RK3 over a tensor or a tuple of levels, each level
        combined in the same expression order (``hydro.stepper``'s
        ``rk3_step`` and ``amr_rk3_step``), or through the fused stages.
        ``dt`` is a float or a 0-dim tensor (e.g. ``courant_dt``'s, which
        stays on the device)."""
        with tracing.span("repro_torch.rk3_step"):
            if self._fuse_epilogue:
                out = self._rk3_step_fused_stages(state, dt)
                if out is not None:
                    return out
            return self._finalize(shu_osher(self.rhs, state, dt))

    def _finalize(self, state):
        with tracing.span("repro_torch.scenario.assemble"):
            return self.scenario.finalize_step(state)

    def _rk3_step_fused_stages(self, state, dt):
        """RK3 through the epilogue-fused stage path: each Shu-Osher stage
        is one submission wave of the scenario's stage families, the body
        and the stage update in one launch per bucket.  Returns None (the
        generic path follows) when the strategy's ``run_stage`` declines."""
        self._check_state(state)
        sc = self.scenario

        def stage(v, c0, c1):
            with tracing.span("repro_torch.stage"):
                return self._strategy.run_stage(sc, state, v, dt, c0, c1,
                                                self.ctx)

        u1 = stage(state, 0.0, 1.0)
        if u1 is None:
            self._fuse_epilogue = False
            return None
        u2 = stage(u1, 0.75, 0.25)
        out = stage(u2, 1.0 / 3.0, 2.0 / 3.0)
        self.stats["iterations"] += 3
        return self._finalize(out)

    # -- whole trajectories ------------------------------------------------
    def _trajectory_impl(self, n_steps: int, state, dt):
        sc = self.scenario
        for _ in range(n_steps):
            state = sc.finalize_step(shu_osher(sc.reference_rhs, state, dt))
        return state

    def rk3_trajectory(self, state, dt, n_steps: int):
        """Run ``n_steps`` RK3 steps of one ``dt``.  Under ``fused`` every
        stage is the scenario's ``reference_rhs`` and the generic combine
        (whatever ``fuse_epilogue`` says), and the whole trajectory is ONE
        launch: on the card one CUDA graph for ``(n_steps, state shapes and
        dtypes, dt's dtype)``, captured at the first call
        (:class:`~repro_torch.core.graphs.CapturedCall`) and replayed once
        per call, the state and ``dt`` copied into its static inputs, so
        one graph serves any ``dt``; on the CPU the same steps eagerly.
        The result is a new state: the caller's stays as it was, and so
        does the result across later calls.  A step that cannot be
        captured raises :class:`~repro_torch.core.graphs.CaptureError`.

        Memory: the graph keeps every intermediate of its ``n_steps`` in
        a private pool for as long as it is cached (about one step's
        intermediates per step; Path B's reconstruction alone is 730.6 MB
        at 512 x 8^3).  The runner caches one graph: a call with another
        ``n_steps``, state shape or ``dt`` type captures anew and frees
        the previous graph.

        ``stats["kernel_launches"]`` counts the trajectory as one launch
        and ``stats["iterations"]`` its 3 x ``n_steps`` iterations; the
        kernel wrappers' counters advance at the warm step and the capture
        only, never at a replay.  Other strategies loop over
        ``rk3_step``."""
        if self.strategy != "fused":
            for _ in range(n_steps):
                state = self.rk3_step(state, dt)
            return state
        self._check_state(state)
        if self.device.type == "cuda":
            out = self._trajectory_graph(state, dt, n_steps)
        else:
            out = self._trajectory_impl(n_steps, state, dt)
        self.stats["kernel_launches"] += 1
        self.stats["iterations"] += 3 * n_steps
        return out

    def _trajectory_graph(self, state, dt, n_steps: int):
        tuple_state = isinstance(state, tuple)
        levels = state if tuple_state else (state,)
        key = (n_steps, tuple((tuple(u.shape), u.dtype) for u in levels),
               dt.dtype if isinstance(dt, torch.Tensor) else float)
        graph = self.trajectory_graphs.get(key)
        if graph is None:
            def steps(n):        # (*levels, dt) -> state after n steps
                return lambda *a: self._trajectory_impl(
                    n, tuple(a[:-1]) if tuple_state else a[0], a[-1])
            self.trajectory_graphs.clear()
            graph = CapturedCall(steps(n_steps), levels + (dt,),
                                 self.device, warm=steps(1))
            self.trajectory_graphs[key] = graph
        return graph(*levels, dt)

    # -- crash-consistent runs ---------------------------------------------
    def run(self, state, dt, n_steps: int, *, checkpoint_every: int = 0,
            ckpt_dir: Optional[str] = None, start_step: int = 0):
        """RK3 steps ``start_step .. n_steps - 1``, saving a checkpoint
        (``repro_torch.checkpoint``) after every ``checkpoint_every``-th
        completed step and after the last one, when ``ckpt_dir`` is given.
        A process killed mid-run loses at most ``checkpoint_every - 1``
        steps: :meth:`resume` continues from the latest checkpoint bit for
        bit."""
        cadence = max(0, int(checkpoint_every)) if ckpt_dir else 0
        for step in range(int(start_step), int(n_steps)):
            state = self.rk3_step(state, dt)
            done = step + 1
            if cadence and (done % cadence == 0 or done == n_steps):
                self._checkpoint(ckpt_dir, done, state, dt, n_steps, cadence)
        return state

    def _checkpoint(self, ckpt_dir: str, step: int, state, dt,
                    n_steps: int, checkpoint_every: int) -> None:
        """Synchronise, then save ``state`` with the run's meta, and the
        tuning (:meth:`save_tuning`), so a resumed process restores its
        ladders and cost tables instead of measuring them.  ``dt`` is read
        on the host here only (a 0-dim device tensor stays on the card
        between saves)."""
        self._sync()
        meta = {"dt": float(dt), "n_steps": int(n_steps),
                "checkpoint_every": int(checkpoint_every),
                "scenario": self.scenario.name, "strategy": self.strategy}
        save_checkpoint(ckpt_dir, step, state, {}, meta=meta)
        self.save_tuning()

    def resume(self, ckpt_dir: str, state_template, *,
               dt: Optional[float] = None, n_steps: Optional[int] = None,
               checkpoint_every: int = 0):
        """Continue a killed :meth:`run` from its latest checkpoint: restore
        the state against ``state_template`` (the initial state will do:
        only structure and dtypes matter) onto the runner's device, warm
        up, and run the remaining steps at the same cadence.  ``dt`` and
        ``n_steps`` default to the saved ones; a saved ``dt`` comes back as
        the Python float of the saved fp32 value, which gives the 0-dim
        fp32 tensor's bits in ``u + dt * l``.  Sets
        ``stats["resumed_from_step"]`` and ``stats["recovery_steps"]``."""
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint to resume under {ckpt_dir!r}")
        template = per_level(lambda u: u.to(self.device), state_template)
        state, _, meta = restore_checkpoint(ckpt_dir, step, template, {})
        dt = meta["dt"] if dt is None else dt
        n_steps = int(meta["n_steps"]) if n_steps is None else int(n_steps)
        cadence = int(checkpoint_every or meta.get("checkpoint_every", 0))
        self.warmup()
        self.stats["resumed_from_step"] = step
        self.stats["recovery_steps"] = max(0, n_steps - step)
        return self.run(state, dt, n_steps, checkpoint_every=cadence,
                        ckpt_dir=ckpt_dir, start_step=step)

    def time_step(self, state, dt, n_steps: int = 1,
                  use_scan: bool = False) -> float:
        """Average wall seconds per time-step (the Table III metric), the
        device synchronised before and after; ``use_scan`` under ``fused``
        times :meth:`rk3_trajectory` (its capture included at the first
        call)."""
        self._sync()
        t0 = time.perf_counter()
        if use_scan and self.strategy == "fused":
            out = self.rk3_trajectory(state, dt, n_steps)
        else:
            out = state
            for _ in range(n_steps):
                out = self.rk3_step(out, dt)
        self._sync()
        return (time.perf_counter() - t0) / n_steps


# ---------------------------------------------------------------------------
# deprecation shims over the facade (the AMR runner's state is (uc, uf))
# ---------------------------------------------------------------------------

def HydroStrategyRunner(cfg: HydroConfig, agg: AggregationConfig,
                        bc: str = "outflow", batched_body=None,
                        device: DeviceLike = None) -> StrategyRunner:
    """Deprecated: ``StrategyRunner(UniformSedovScenario(cfg), agg)``."""
    warnings.warn(
        "HydroStrategyRunner is deprecated — use "
        "StrategyRunner(UniformSedovScenario(cfg), agg)",
        DeprecationWarning, stacklevel=2)
    return StrategyRunner(UniformSedovScenario(
        cfg, bc=bc, batched_body=batched_body), agg, device=device)


def AMRStrategyRunner(cfg: AMRHydroConfig, agg: AggregationConfig,
                      bc: str = "outflow",
                      device: DeviceLike = None) -> StrategyRunner:
    """Deprecated: ``StrategyRunner(AMRSedovScenario(cfg), agg)``."""
    warnings.warn(
        "AMRStrategyRunner is deprecated — use "
        "StrategyRunner(AMRSedovScenario(cfg), agg)",
        DeprecationWarning, stacklevel=2)
    return StrategyRunner(AMRSedovScenario(cfg, bc=bc), agg, device=device)
