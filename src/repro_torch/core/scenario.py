"""Scenario protocol: declarative workload descriptions for StrategyRunner.

A **Scenario** declares WHAT one solver iteration computes — its kernel
families (id + batched body), the per-iteration task populations (parent
tensors with a leading task axis), the assembly around them, and the fused
reference every strategy must reproduce bit for bit.  A **Strategy**
(``repro_torch.core.strategies``) decides HOW the populations launch.

The port has the uniform Sedov scenario (the paper's Table II/III
workload), the self-gravitating Sedov scenario (two kernel families per
iteration) and the two-level AMR Sedov scenario (coarse and fine tasks in
one family, or two where the levels' sub-grid sizes differ).

Each scenario also declares epilogue-fused RK stages: a hydro family with
an ``epilogue`` (the Shu-Osher stage update) derives a ``stage_family``
twin whose body is the family's body followed by the epilogue, so one
launch per bucket produces the next stage's state per slot.
``stage_populations`` builds a stage's submission waves, ``assemble_stage``
the next state from their outputs, and ``reference_stage`` is the stage
path's oracle, as ``reference_rhs`` is the generic path's.

``populations(state, buffers=...)``: a strategy whose launches read fixed
tensors (``s3`` on the card: the aggregation executor's static parents)
passes ``buffers``, and the scenario writes its populations there, one
extraction straight into the tensors the launches read.  ``buffers``
takes one ``(kernel, parents)`` request per population, each parent a
``(shape, dtype)`` the scenario writes or a tensor that never changes
(the cell widths), and gives one tuple of tensors per request, or None
(the scenario makes its own).  Every ``populations`` takes the keyword:
a subclass that overrides it accepts ``buffers=None`` and passes it on
to the scenario it extends, or ignores it and returns tensors of its own
(their launches then copy them into the static parents).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import tracing
from repro_torch.configs.base import (
    AMRHydroConfig, GravityHydroConfig, HydroConfig,
)
from repro_torch.core.graphs import CapturedCall
from repro_torch.hydro.state import (
    assemble_global, extract_subgrids, extract_subgrids_multilevel,
    sync_coarse,
)
from repro_torch.hydro.stepper import rk_stage_epilogue, stage_coeff_vectors
from repro_torch.kernels.gravity import gravity_source_update
from repro_torch.kernels.ops import (
    gravity_batched_body, hydro_batched_body, level_batched_body,
)


@dataclass(frozen=True)
class KernelFamily:
    """One aggregable kernel family: the ``TaskSignature`` kernel id and its
    batched body ``(*stacked_args, out=None) -> stacked_out`` (leading slot
    axis on every arg and output).

    ``epilogue(body_out, *extras) -> out``, if given, is a batched
    elementwise stage update (``rk_stage_epilogue``) that
    :func:`stage_family` runs after the body in the same bucket."""

    kernel: str
    batched_body: Callable
    epilogue: Optional[Callable] = None


def stage_family(fam: KernelFamily, n_body_args: int) -> KernelFamily:
    """The epilogue-fused twin of a family, ``<kernel>+epi``: the first
    ``n_body_args`` arguments of a task feed the body, the rest (per-slot
    extras, the coefficient vectors included) the epilogue.  The epilogue
    is plain elementwise PyTorch over the body's output, as the reference
    composes it in XLA outside its Pallas kernel."""
    if fam.epilogue is None:
        raise ValueError(f"family {fam.kernel!r} declares no epilogue")

    def batched(*args, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        res = fam.epilogue(fam.batched_body(*args[:n_body_args]),
                           *args[n_body_args:])
        return res if out is None else out.copy_(res)

    return KernelFamily(fam.kernel + "+epi", batched)


def _cached_u0_interiors(scn, u0, v, v_int, extract):
    """``u0`` is the same in a step's three stages (and IS ``v`` in stage
    1): extract its interiors once per step, keyed on the ``u0`` object."""
    if v is u0:
        scn._u0_int_cache = (u0, v_int)
        return v_int
    cache = getattr(scn, "_u0_int_cache", None)
    if cache is None or cache[0] is not u0:
        cache = (u0, extract(u0))
        scn._u0_int_cache = cache
    return cache[1]


def _coeff_cache(scn) -> dict:
    cache = getattr(scn, "_stage_coeff_cache", None)
    if cache is None:
        cache = scn._stage_coeff_cache = {}
    return cache


# (kernel, parents) requests -> one tuple of tensors per request, or None
Buffers = Callable[[Sequence[Tuple[str, Sequence[Any]]]],
                   Optional[List[Tuple[torch.Tensor, ...]]]]


def _subgrid_spec(u: torch.Tensor, subgrid: int, ghost: int):
    """``(shape, dtype)`` of the padded sub-grids of the level ``u``."""
    grids, p = u.shape[-1] // subgrid, subgrid + 2 * ghost
    return (grids ** 3, u.shape[0], p, p, p), u.dtype


@dataclass(frozen=True)
class TaskPopulation:
    """One iteration's submission wave for one family: per-task parent
    tensors (leading task axis).  Task ``i`` consumes ``parents[j][i]``."""

    kernel: str
    parents: Tuple[torch.Tensor, ...]

    @property
    def n_tasks(self) -> int:
        return self.parents[0].shape[0]

    def submit_to(self, executor):
        """Bulk-submit the whole population as ONE range entry."""
        return executor.submit_range(self.parents, 0, self.n_tasks,
                                     kernel=self.kernel)


class Scenario:
    """Base class / protocol.  Subclasses implement ``families()``,
    ``populations(state, buffers=None)``, ``assemble(state, outs)`` and
    ``warmup_parent_specs()`` — ``(kernel, ((shape, dtype), ...))`` pairs
    describing the submission waves — and may override ``finalize_step``
    and the epilogue-fused stage protocol (``stage_families``,
    ``stage_populations``, ``assemble_stage``,
    ``stage_warmup_parent_specs``).  ``reference_rhs``, one launch per
    family through the same assemble path, is the oracle every strategy
    must match bit for bit; ``reference_stage`` is the stage path's."""

    name: str = "scenario"

    def families(self) -> Tuple[KernelFamily, ...]:
        raise NotImplementedError

    def populations(self, state, buffers: Optional[Buffers] = None
                    ) -> Tuple[TaskPopulation, ...]:
        """One iteration's submission waves, written into ``buffers``'
        tensors where it is given and the scenario takes it (module
        docstring); an override must accept the keyword."""
        raise NotImplementedError

    def assemble(self, state, outs: Sequence[Any]):
        raise NotImplementedError

    def warmup_parent_specs(self) -> Tuple[Tuple[str, Tuple[Any, ...]], ...]:
        return ()

    # -- optional: epilogue-fused RK stages ---------------------------------
    def stage_families(self) -> Tuple[KernelFamily, ...]:
        """The epilogue-fused twins of the families that declare one; empty
        when the scenario has no fused stages."""
        return ()

    def stage_populations(self, u0, v, dt, c0,
                          c1) -> Optional[Tuple[TaskPopulation, ...]]:
        """Submission waves whose launches give the NEXT RK stage state per
        slot, ``c0*u0 + c1*(v + dt*rhs(v))`` (Shu-Osher form; stage 1 is
        ``c0=0, c1=1``).  ``None``: not supported, and the runner takes the
        generic rhs + combine path."""
        return None

    def assemble_stage(self, state, outs: Sequence[Any], dt, c0, c1):
        """Per-population stage outputs (population order) -> the next
        stage's state.  Cross-family couplings (gravity's ``c1*dt`` source
        tail) enter here, after every launch of the wave."""
        raise NotImplementedError

    def stage_warmup_parent_specs(self):
        """Like ``warmup_parent_specs``, for the stage waves."""
        return ()

    def reference_stage(self, u0, v, dt, c0, c1):
        """The stage path's oracle: one launch of each stage population's
        family body over its whole population, through the same
        ``assemble_stage``."""
        pops = self.stage_populations(u0, v, dt, c0, c1)
        if pops is None:
            raise NotImplementedError(
                f"scenario {self.name!r} declares no stage populations")
        outs = [self.family(p.kernel).batched_body(*p.parents) for p in pops]
        return self.assemble_stage(v, outs, dt, c0, c1)

    # -- provided ----------------------------------------------------------
    def finalize_step(self, state):
        """Post-RK3-combine hook; identity unless levels need re-syncing."""
        return state

    def describe_task(self, kernel: str, index: int) -> str:
        """A readable name of one task of a family's wave (``index`` is its
        position in the wave)."""
        return f"task {index} of family {kernel!r}"

    def family(self, kernel: str) -> KernelFamily:
        for fam in self.families() + tuple(self.stage_families()):
            if fam.kernel == kernel:
                return fam
        raise KeyError(f"scenario {self.name!r} has no kernel family "
                       f"{kernel!r}")

    def reference_rhs(self, state):
        """Fused per-family reference: one launch of each family's body
        over its whole population."""
        outs = [self.family(p.kernel).batched_body(*p.parents)
                for p in self.populations(state)]
        return self.assemble(state, outs)


class UniformSedovScenario(Scenario):
    """AMR-off Sedov blast: one kernel family, one task per sub-grid.

    The cell width is uniform, so the body takes it as a float.  The default
    body is ``kernels.ops.hydro_rhs``: the CUDA kernel for tensors on the
    card, the plain PyTorch version on the CPU; ``batched_body`` swaps in
    another (e.g. ``hydro_rhs_plain`` on the card, as a reference).
    """

    def __init__(self, cfg: HydroConfig, bc: str = "outflow",
                 batched_body: Optional[Callable] = None):
        self.cfg = cfg
        self.bc = bc
        n = cfg.grids_per_edge * cfg.subgrid
        self.h = cfg.domain / n
        self.batched_body = batched_body or hydro_batched_body(cfg, self.h)
        self.name = cfg.name
        self._dtype = getattr(torch, cfg.dtype)
        self._families = (KernelFamily("hydro_rhs", self.batched_body,
                                       epilogue=rk_stage_epilogue),)
        self._stage_families = (stage_family(self._families[0], 1),)

    def families(self):
        return self._families

    def populations(self, state, buffers: Optional[Buffers] = None):
        cfg = self.cfg
        into = buffers and buffers(
            [("hydro_rhs", (_subgrid_spec(state, cfg.subgrid, cfg.ghost),))])
        subs = extract_subgrids(state, cfg.subgrid, cfg.ghost, self.bc,
                                out=into[0][0] if into else None)
        return (TaskPopulation("hydro_rhs", (subs,)),)

    def assemble(self, state, outs):
        return assemble_global(outs[0], self.cfg.subgrid)

    def warmup_parent_specs(self):
        cfg = self.cfg
        p = cfg.padded
        shape = (cfg.n_subgrids, cfg.n_fields, p, p, p)
        return (("hydro_rhs", ((shape, self._dtype),)),)

    # -- epilogue-fused RK stages ------------------------------------------
    def stage_families(self):
        return self._stage_families

    def _interiors(self, u):
        return extract_subgrids(u, self.cfg.subgrid, 0, self.bc)

    def stage_populations(self, u0, v, dt, c0, c1):
        cfg = self.cfg
        subs = extract_subgrids(v, cfg.subgrid, cfg.ghost, self.bc)
        v_int = self._interiors(v)
        u0_int = _cached_u0_interiors(self, u0, v, v_int, self._interiors)
        coeffs = stage_coeff_vectors(_coeff_cache(self), dt, c0, c1,
                                     subs.shape[0], self._dtype, v.device)
        return (TaskPopulation(self._stage_families[0].kernel,
                               (subs, v_int, u0_int) + coeffs),)

    def assemble_stage(self, state, outs, dt, c0, c1):
        return assemble_global(outs[0], self.cfg.subgrid)

    def stage_warmup_parent_specs(self):
        cfg = self.cfg
        n, s, p, f = cfg.n_subgrids, cfg.subgrid, cfg.padded, cfg.n_fields
        interior = ((n, f, s, s, s), self._dtype)
        scalar = ((n,), self._dtype)
        return ((self._stage_families[0].kernel, (
            ((n, f, p, p, p), self._dtype), interior, interior,
            scalar, scalar, scalar)),)


class GravityScenario(Scenario):
    """Sedov blast under self-gravity: TWO kernel families per iteration.

    Both families read the SAME ghost-exchanged sub-grids (one parent
    tensor) and the same per-task cell widths (one ``(n,)`` parent), so
    each takes h per task.  Under s3 / s2+s3 their tasks go interleaved
    into one ``AggregationExecutor``, which routes them by kernel id into
    two ``TaskSignature`` families with their own bucket ladders.  The
    gravity output enters the hydro RHS at ``assemble`` as the source
    ``gravity_source_update`` adds, on the caller's stream.

    The default bodies are ``kernels.ops``'s: the CUDA kernels for tensors
    on the card, the plain versions on the CPU; ``hydro_body`` and
    ``gravity_body`` swap in others (e.g. the plain versions on the card,
    as a reference).

    The epilogue-fused stage wave is two families: the hydro family's
    stage twin and the unchanged gravity family, submitted together.  The
    coupling, which no per-slot epilogue can see (gravity is another
    launch), enters at ``assemble_stage`` as the algebraically equal
    ``+ c1*dt * src(v, pg)`` tail.
    """

    def __init__(self, cfg: GravityHydroConfig, bc: str = "outflow",
                 hydro_body: Optional[Callable] = None,
                 gravity_body: Optional[Callable] = None):
        self.cfg = cfg
        self.bc = bc
        self.name = cfg.name
        hc = cfg.hydro
        self.h = hc.domain / (hc.grids_per_edge * hc.subgrid)
        self._dtype = getattr(torch, hc.dtype)
        self._h_vec: Dict[torch.device, torch.Tensor] = {}
        self._families = (
            KernelFamily("hydro_rhs", hydro_body or level_batched_body(
                hc.gamma, hc.ghost, hc.subgrid), epilogue=rk_stage_epilogue),
            KernelFamily("gravity", gravity_body or gravity_batched_body(cfg)),
        )
        # the hydro body takes (subs, h); gravity joins the stage wave as
        # itself
        self._stage_families = (stage_family(self._families[0], 2),)

    def families(self):
        return self._families

    def h_vec(self, device: torch.device) -> torch.Tensor:
        """The per-task widths ``(n,)`` on ``device``, made once."""
        h = self._h_vec.get(device)
        if h is None:
            h = torch.full((self.cfg.hydro.n_subgrids,), self.h,
                           dtype=self._dtype, device=device)
            self._h_vec[device] = h
        return h

    def populations(self, state, buffers: Optional[Buffers] = None):
        """Both families read one parent set: written in place for the
        hydro family's region, copied by the gravity family's."""
        hc = self.cfg.hydro
        h = self.h_vec(state.device)
        into = buffers and buffers(
            [("hydro_rhs", (_subgrid_spec(state, hc.subgrid, hc.ghost), h))])
        subs = extract_subgrids(state, hc.subgrid, hc.ghost, self.bc,
                                out=into[0][0] if into else None)
        if into:
            h = into[0][1]
        return (TaskPopulation("hydro_rhs", (subs, h)),
                TaskPopulation("gravity", (subs, h)))

    def assemble(self, state, outs):
        hc = self.cfg.hydro
        dudt = assemble_global(outs[0], hc.subgrid)
        pg = assemble_global(outs[1], hc.subgrid)
        return gravity_source_update(state, dudt, pg)

    def warmup_parent_specs(self):
        hc = self.cfg.hydro
        p = hc.padded
        subs = ((hc.n_subgrids, hc.n_fields, p, p, p), self._dtype)
        h = ((hc.n_subgrids,), self._dtype)
        return (("hydro_rhs", (subs, h)), ("gravity", (subs, h)))

    # -- two-family epilogue-fused RK stages -------------------------------
    def stage_families(self):
        return self._stage_families

    def _interiors(self, u):
        return extract_subgrids(u, self.cfg.hydro.subgrid, 0, self.bc)

    def stage_populations(self, u0, v, dt, c0, c1):
        hc = self.cfg.hydro
        subs = extract_subgrids(v, hc.subgrid, hc.ghost, self.bc)
        v_int = self._interiors(v)
        u0_int = _cached_u0_interiors(self, u0, v, v_int, self._interiors)
        h = self.h_vec(v.device)
        coeffs = stage_coeff_vectors(_coeff_cache(self), dt, c0, c1,
                                     hc.n_subgrids, self._dtype, v.device)
        return (TaskPopulation(self._stage_families[0].kernel,
                               (subs, h, v_int, u0_int) + coeffs),
                TaskPopulation("gravity", (subs, h)))

    def assemble_stage(self, state, outs, dt, c0, c1):
        hc = self.cfg.hydro
        staged = assemble_global(outs[0], hc.subgrid)
        pg = assemble_global(outs[1], hc.subgrid)
        return gravity_source_update(state, staged, pg, scale=c1 * dt)

    def stage_warmup_parent_specs(self):
        hc = self.cfg.hydro
        n, s, p, f = hc.n_subgrids, hc.subgrid, hc.padded, hc.n_fields
        subs = ((n, f, p, p, p), self._dtype)
        interior = ((n, f, s, s, s), self._dtype)
        scalar = ((n,), self._dtype)
        return ((self._stage_families[0].kernel,
                 (subs, scalar, interior, interior, scalar, scalar, scalar)),
                ("gravity", (subs, scalar)))


class AMRSedovScenario(Scenario):
    """Two-level refined Sedov: the state is ``(uc, uf)``; every iteration
    yields one population per level, each task with its level's cell width
    (an ``(n,)`` parent beside the sub-grids).  Levels whose sub-grid sizes
    agree share one kernel family, ``hydro_rhs_s<S>`` (one bucket ladder
    serves both levels); different sizes make two families that aggregate
    through one executor.  ``finalize_step`` re-syncs the covered coarse
    cells.

    ``hydro_body(subgrid)`` gives the family body of one sub-grid size,
    ``(k, F, P, P, P), (k,) -> (k, F, S, S, S)``; the default is
    ``kernels.ops.level_batched_body`` in the slot_grid layout (the kernel's
    ``h_slots`` mode on the card, the plain version on the CPU).  Pass
    ``functools.partial(level_batched_body, gamma, ghost,
    layout="slot_lane")`` for the lane kernel, or a plain factory for the
    card's reference.

    Each level's family derives a stage twin, ``hydro_rhs_s<S>+epi``, with
    the per-task width riding through the body; the stage update reads the
    raw (un-synced) level interiors, as the generic combine does.

    On the card the two-level exchange (:meth:`exchange`, dozens of small
    eager ops) is one CUDA graph per state shape.
    """

    LEVELS = ("coarse", "fine")

    def __init__(self, cfg: AMRHydroConfig, bc: str = "outflow",
                 hydro_body: Optional[Callable[[int], Callable]] = None):
        self.cfg = cfg
        self.bc = bc
        self.name = cfg.name
        self.exchange_graphs: Dict[Any, CapturedCall] = {}
        self._dtype = getattr(torch, cfg.dtype)
        self._subgrid = {"coarse": cfg.coarse_subgrid,
                         "fine": cfg.fine_subgrid}
        self._n_level = {"coarse": cfg.n_subgrids_coarse,
                         "fine": cfg.n_subgrids_fine}
        self._width = {"coarse": cfg.h_coarse, "fine": cfg.h_fine}
        self._h_vec: Dict[Tuple[str, torch.device], torch.Tensor] = {}
        # one family per DISTINCT sub-grid size; equal sizes share it
        self._kernel = {lvl: f"hydro_rhs_s{s}"
                        for lvl, s in self._subgrid.items()}
        if hydro_body is None:
            def hydro_body(s):
                return level_batched_body(cfg.gamma, cfg.ghost, s)
        self._families = tuple(
            KernelFamily(f"hydro_rhs_s{s}", hydro_body(s),
                         epilogue=rk_stage_epilogue)
            for s in dict.fromkeys(self._subgrid.values()))
        # the level body takes (subs, h); the rest feeds the epilogue
        self._stage_families = tuple(stage_family(f, 2)
                                     for f in self._families)
        self._stage_kernel = {lvl: k + "+epi"
                              for lvl, k in self._kernel.items()}

    def families(self):
        return self._families

    def h_vec(self, level: str, device: torch.device) -> torch.Tensor:
        """The level's per-task widths ``(n,)`` on ``device``, made once."""
        key = (level, device)
        h = self._h_vec.get(key)
        if h is None:
            h = torch.full((self._n_level[level],), self._width[level],
                           dtype=self._dtype, device=device)
            self._h_vec[key] = h
        return h

    def _exchange_eager(self, uc, uf, out=None):
        return extract_subgrids_multilevel(uc, uf, self.cfg, self.bc,
                                           out=out)

    def exchange(self, uc: torch.Tensor, uf: torch.Tensor,
                 out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        """The two-level ghost exchange, ``(subs_coarse, subs_fine)``
        (``extract_subgrids_multilevel``), written into ``out`` (a pair) if
        given.  On the card, one CUDA graph per state shape and ``out``,
        with static ``(uc, uf)`` inputs, bit-equal to the eager exchange
        (inside another capture, e.g. a trajectory's, the exchange is
        captured with it).  With ``out`` the graph writes the pair itself
        and a call returns it; without, the graph has static outputs and a
        call returns copies of them, so a launch that still reads one on
        an executor's stream is safe from the next call's replay, whatever
        the strategy orders: the copy is freed only after every stream that
        recorded it is done.  A ``repro_torch.scenario.exchange`` span
        counts the bytes the graph's call copies in and out."""
        with tracing.span("repro_torch.scenario.exchange"):
            if (uc.device.type != "cuda"
                    or torch.cuda.is_current_stream_capturing()):
                return self._exchange_eager(uc, uf, out=out)
            key = (uc.device, tuple(uc.shape), tuple(uf.shape), uc.dtype,
                   None if out is None else tuple(map(id, out)))
            graph = self.exchange_graphs.get(key)
            if graph is None:
                graph = CapturedCall(
                    functools.partial(self._exchange_eager, out=out),
                    (uc, uf), uc.device)
                self.exchange_graphs[key] = graph
            if out is not None:
                if tracing.on():
                    tracing.add("copy_bytes", tracing.nbytes(graph.inputs))
                return graph.replay_static(uc, uf)
            if tracing.on():
                # the levels copied in, the outputs' clones out
                tracing.add("copy_bytes", tracing.nbytes(graph.inputs)
                            + tracing.nbytes(graph.outputs))
            return graph(uc, uf)

    def populations(self, state, buffers: Optional[Buffers] = None):
        """One population per level; with ``buffers`` the exchange writes
        each level's sub-grids into its own static parent set, beside the
        level's widths."""
        uc, uf = state
        parents = [(self._kernel[lvl], (
            _subgrid_spec(u, self._subgrid[lvl], self.cfg.ghost),
            self.h_vec(lvl, uc.device)))
            for lvl, u in zip(self.LEVELS, state)]
        into = buffers and buffers(parents)
        if into:
            self.exchange(uc, uf, out=tuple(b[0] for b in into))
            return tuple(TaskPopulation(kernel, b)
                         for (kernel, _), b in zip(parents, into))
        subs = self.exchange(uc, uf)
        return tuple(TaskPopulation(kernel, (sub, h))
                     for (kernel, (_, h)), sub in zip(parents, subs))

    def assemble(self, state, outs):
        return tuple(assemble_global(out, self._subgrid[lvl])
                     for lvl, out in zip(self.LEVELS, outs))

    def finalize_step(self, state):
        uc, uf = state
        return sync_coarse(uc, uf, self.cfg), uf

    def warmup_parent_specs(self):
        cfg = self.cfg
        specs = []
        for lvl in self.LEVELS:
            n = self._n_level[lvl]
            p = self._subgrid[lvl] + 2 * cfg.ghost
            specs.append((self._kernel[lvl], (
                ((n, cfg.n_fields, p, p, p), self._dtype),
                ((n,), self._dtype))))
        return tuple(specs)

    # -- epilogue-fused RK stages ------------------------------------------
    def stage_families(self):
        return self._stage_families

    def _interiors(self, state):
        """Per-level interiors of the raw level states."""
        return {lvl: extract_subgrids(u, self._subgrid[lvl], 0, self.bc)
                for lvl, u in zip(self.LEVELS, state)}

    def stage_populations(self, u0, v, dt, c0, c1):
        uc, uf = v
        subs = dict(zip(self.LEVELS, self.exchange(uc, uf)))
        v_int = self._interiors(v)
        u0_int = _cached_u0_interiors(self, u0, v, v_int, self._interiors)
        cache = _coeff_cache(self)
        pops = []
        for lvl in self.LEVELS:
            coeffs = stage_coeff_vectors(cache, dt, c0, c1,
                                         self._n_level[lvl], self._dtype,
                                         uc.device)
            pops.append(TaskPopulation(
                self._stage_kernel[lvl],
                (subs[lvl], self.h_vec(lvl, uc.device), v_int[lvl],
                 u0_int[lvl]) + coeffs))
        return tuple(pops)

    def assemble_stage(self, state, outs, dt, c0, c1):
        return self.assemble(state, outs)

    def stage_warmup_parent_specs(self):
        cfg = self.cfg
        specs = []
        for lvl in self.LEVELS:
            n, s = self._n_level[lvl], self._subgrid[lvl]
            p = s + 2 * cfg.ghost
            interior = ((n, cfg.n_fields, s, s, s), self._dtype)
            scalar = ((n,), self._dtype)
            specs.append((self._stage_kernel[lvl], (
                ((n, cfg.n_fields, p, p, p), self._dtype), scalar, interior,
                interior, scalar, scalar, scalar)))
        return tuple(specs)
