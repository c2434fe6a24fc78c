"""TVD-RK3 time stepping over the sub-grid decomposition: the uniform grid
and the two-level AMR grid.

One time-step is three hydro-solver iterations (paper §VI-A), each a ghost
exchange followed by per-sub-grid Reconstruct + Flux and the conserved-
variable update.  ``courant_dt`` is the Courant condition (paper §IV-B).

``subgrid_rhs`` is THE task body, written on tensors with an optional
leading slot dimension: ``(n, F, P, P, P) -> (n, F, S, S, S)`` is the
aggregated body the reference gets with ``vmap``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch import tracing
from repro_torch.configs.base import AMRHydroConfig, HydroConfig
from repro_torch.hydro.euler import max_signal_speed
from repro_torch.hydro.flux import flux_divergence
from repro_torch.hydro.ppm import ppm_reconstruct_all
from repro_torch.hydro.state import (
    AMRState, HydroState, assemble_global, extract_subgrids,
    extract_subgrids_multilevel, sync_coarse,
)


def subgrid_rhs(u_padded: torch.Tensor, h, gamma: float, ghost: int,
                subgrid: int) -> torch.Tensor:
    """PPM reconstruct + central-upwind flux on padded sub-grids.

    u_padded: ([n,] F, P, P, P) -> dU/dt over the interior ([n,] F, S, S, S).
    ``h`` is a float, or one width per slot (n,).
    """
    recon = ppm_reconstruct_all(u_padded)
    return flux_divergence(recon, h, gamma, ghost, subgrid)


def _per_slot(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-slot ``(k,)`` vector shaped to broadcast over ``like``'s
    ``(k, ...)``."""
    return x.reshape((-1,) + (1,) * (like.dim() - 1))


def rk_stage_epilogue(dudt: torch.Tensor, v_int: torch.Tensor,
                      u0_int: torch.Tensor, c0: torch.Tensor,
                      c1: torch.Tensor, dt: torch.Tensor) -> torch.Tensor:
    """One Shu-Osher stage update per slot, ``out = c0*u0 + c1*(v +
    dt*dudt)`` over a bucket of task interiors ``(k, F, S, S, S)``, with
    the per-slot coefficients ``(k,)`` (stage 1 is ``c0=0, c1=1``; stages 2
    and 3 are ``0.75, 0.25`` and ``1/3, 2/3``).  Elementwise, so a slot's
    result does not depend on the bucket.  The reference composes it with
    the batched body in one XLA program; here it is plain PyTorch after the
    body's kernel."""
    return (_per_slot(c0, dudt) * u0_int
            + _per_slot(c1, dudt) * (v_int + _per_slot(dt, dudt) * dudt))


def stage_coeff_vectors(cache: dict, dt, c0: float, c1: float, n: int,
                        dtype: torch.dtype, device: torch.device):
    """Per-task ``(c0, c1, dt)`` vectors ``(n,)`` for one epilogue-fused RK
    stage, cached per ``(c0, c1, n, device)`` and rebuilt only when the
    ``dt`` object changes.  A 0-dim device ``dt`` (``courant_dt``'s) is
    broadcast on the device, never read on the host."""
    key = (c0, c1, n, device)
    hit = cache.get(key)
    if hit is None or hit[0] is not dt:
        if isinstance(dt, torch.Tensor):
            dt_vec = dt.to(device=device, dtype=dtype).reshape(1).expand(
                n).contiguous()
        else:
            dt_vec = torch.full((n,), dt, dtype=dtype, device=device)
        hit = (dt, tuple(torch.full((n,), c, dtype=dtype, device=device)
                         for c in (c0, c1)) + (dt_vec,))
        cache[key] = hit
    return hit[1]


def _rhs_global(u, cfg: HydroConfig, h: float, bc: str):
    subs = extract_subgrids(u, cfg.subgrid, cfg.ghost, bc)
    dudt = subgrid_rhs(subs, h, cfg.gamma, cfg.ghost, cfg.subgrid)
    return assemble_global(dudt, cfg.subgrid)


def rk3_step(u: torch.Tensor, dt, cfg: HydroConfig,
             bc: str = "outflow") -> torch.Tensor:
    """Shu-Osher TVD-RK3: three iterations of the hydro solver (plain
    whole-grid path, no aggregation)."""
    h = cfg.domain / u.shape[-1]
    l0 = _rhs_global(u, cfg, h, bc)
    u1 = u + dt * l0
    l1 = _rhs_global(u1, cfg, h, bc)
    u2 = 0.75 * u + 0.25 * (u1 + dt * l1)
    l2 = _rhs_global(u2, cfg, h, bc)
    return (1.0 / 3.0) * u + (2.0 / 3.0) * (u2 + dt * l2)


def rk3_trajectory(u: torch.Tensor, dt, cfg: HydroConfig, n_steps: int,
                   bc: str = "outflow") -> torch.Tensor:
    """``n_steps`` RK3 steps of one ``dt`` on the plain whole-grid path (the
    reference's ``lax.scan`` trajectory, here a loop of ``rk3_step``).
    Returns a new tensor; ``u`` is left as it was."""
    for _ in range(n_steps):
        u = rk3_step(u, dt, cfg, bc)
    return u


def courant_dt(u: torch.Tensor, cfg: HydroConfig) -> torch.Tensor:
    """Courant time step as a 0-dim tensor on ``u``'s device (no host
    sync)."""
    with tracing.span("repro_torch.courant_dt"):
        h = cfg.domain / u.shape[-1]
        speed = max_signal_speed(u, cfg.gamma)
        return torch.div(torch.full_like(speed, cfg.cfl * h), speed)


def total_conserved(u: torch.Tensor, h: float) -> torch.Tensor:
    """(mass, Sx, Sy, Sz, E) integrals — conservation invariants."""
    return torch.sum(u, dim=(1, 2, 3)) * h ** 3


def run(state: HydroState, cfg: HydroConfig, n_steps: int,
        bc: str = "outflow") -> HydroState:
    u, t = state.u, state.t
    for _ in range(n_steps):
        dt = courant_dt(u, cfg)
        u = rk3_step(u, dt, cfg, bc)
        t = t + float(dt)
    return HydroState(u=u, t=t, step=state.step + n_steps)


def shock_radius(u: torch.Tensor, cfg: HydroConfig) -> torch.Tensor:
    """Radius of the density peak — the Sedov shock front location."""
    n = u.shape[-1]
    h = cfg.domain / n
    x = (torch.arange(n, device=u.device) + 0.5) * h - 0.5 * cfg.domain
    X, Y, Z = torch.meshgrid(x, x, x, indexing="ij")
    r = torch.sqrt(X * X + Y * Y + Z * Z)
    # mass-weighted radius of the over-dense shell
    w = torch.clamp_min(u[0] - cfg.rho0, 0.0)
    return torch.sum(w * r) / torch.clamp_min(torch.sum(w), 1e-30)


# ---------------------------------------------------------------------------
# Two-level AMR stepping
# ---------------------------------------------------------------------------

LevelBody = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
LevelFactory = Callable[[int], LevelBody]     # sub-grid size -> level body


def plain_level_body(gamma: float, ghost: int, subgrid: int) -> LevelBody:
    """The plain PyTorch level body ``(k, F, P, P, P), (k,) -> (k, F, S, S,
    S)``, one width per task: ``subgrid_rhs`` on any device."""
    def body(subs: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        return subgrid_rhs(subs, h, gamma, ghost, subgrid)
    return body


def amr_rk3_step(rhs_fn, uc: torch.Tensor, uf: torch.Tensor, dt,
                 cfg: AMRHydroConfig):
    """TVD-RK3 over both levels in lockstep (shared dt).

    ``rhs_fn(uc, uf) -> (duc, duf)`` is a strategy runner's rhs or the
    reference below; the combine is written per level in the expression
    order ``StrategyRunner.rk3_step`` uses, so runner-vs-reference
    equivalence reduces to rhs equivalence.  The covered coarse cells are
    re-synced from the fine solution at the end of the step.
    """
    dc0, df0 = rhs_fn(uc, uf)
    uc1, uf1 = uc + dt * dc0, uf + dt * df0
    dc1, df1 = rhs_fn(uc1, uf1)
    uc2 = 0.75 * uc + 0.25 * (uc1 + dt * dc1)
    uf2 = 0.75 * uf + 0.25 * (uf1 + dt * df1)
    dc2, df2 = rhs_fn(uc2, uf2)
    uc_new = (1.0 / 3.0) * uc + (2.0 / 3.0) * (uc2 + dt * dc2)
    uf_new = (1.0 / 3.0) * uf + (2.0 / 3.0) * (uf2 + dt * df2)
    return sync_coarse(uc_new, uf_new, cfg), uf_new


def amr_reference_rhs(uc: torch.Tensor, uf: torch.Tensor,
                      cfg: AMRHydroConfig, bc: str = "outflow",
                      level_body: Optional[LevelFactory] = None):
    """Per-level FUSED reference: each level's whole task batch as one call
    of the level body with per-task widths.  ``level_body(subgrid)`` gives
    the body of one sub-grid size (default: the plain PyTorch version,
    ``plain_level_body``); pass the scenario's own factory to get the
    reference every aggregation strategy must match bit for bit."""
    if level_body is None:
        def level_body(s):
            return plain_level_body(cfg.gamma, cfg.ghost, s)
    subs_c, subs_f = extract_subgrids_multilevel(uc, uf, cfg, bc)
    hc = torch.full((subs_c.shape[0],), cfg.h_coarse, dtype=subs_c.dtype,
                    device=subs_c.device)
    hf = torch.full((subs_f.shape[0],), cfg.h_fine, dtype=subs_f.dtype,
                    device=subs_f.device)
    duc = level_body(cfg.coarse_subgrid)(subs_c, hc)
    duf = level_body(cfg.fine_subgrid)(subs_f, hf)
    return (assemble_global(duc, cfg.coarse_subgrid),
            assemble_global(duf, cfg.fine_subgrid))


def amr_reference_step(uc: torch.Tensor, uf: torch.Tensor, dt,
                       cfg: AMRHydroConfig, bc: str = "outflow",
                       level_body: Optional[LevelFactory] = None):
    """One RK3 step of the per-level fused reference."""
    return amr_rk3_step(
        lambda a, b: amr_reference_rhs(a, b, cfg, bc, level_body),
        uc, uf, dt, cfg)


def amr_courant_dt(uc: torch.Tensor, uf: torch.Tensor,
                   cfg: AMRHydroConfig) -> torch.Tensor:
    """Shared two-level Courant dt (the fine level is the binding one), as
    a 0-dim tensor on the levels' device (no host sync)."""
    with tracing.span("repro_torch.courant_dt"):
        sc = max_signal_speed(uc, cfg.gamma)
        sf = max_signal_speed(uf, cfg.gamma)
        return cfg.cfl * torch.minimum(
            torch.div(torch.full_like(sc, cfg.h_coarse), sc),
            torch.div(torch.full_like(sf, cfg.h_fine), sf))


def amr_run(state: AMRState, cfg: AMRHydroConfig, n_steps: int,
            bc: str = "outflow", level_body: Optional[LevelFactory] = None
            ) -> AMRState:
    uc, uf, t = state.uc, state.uf, state.t
    for _ in range(n_steps):
        dt = amr_courant_dt(uc, uf, cfg)
        uc, uf = amr_reference_step(uc, uf, dt, cfg, bc, level_body)
        t = t + float(dt)
    return AMRState(uc=uc, uf=uf, t=t, step=state.step + n_steps)
