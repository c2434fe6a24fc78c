"""TVD-RK3 time stepping over the sub-grid decomposition (uniform grid).

One time-step is three hydro-solver iterations (paper §VI-A), each a ghost
exchange followed by per-sub-grid Reconstruct + Flux and the conserved-
variable update.  ``courant_dt`` is the Courant condition (paper §IV-B).

``subgrid_rhs`` is THE task body, written on tensors with an optional
leading slot dimension: ``(n, F, P, P, P) -> (n, F, S, S, S)`` is the
aggregated body the reference gets with ``vmap``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import HydroConfig
from repro_torch.hydro.euler import max_signal_speed
from repro_torch.hydro.flux import flux_divergence
from repro_torch.hydro.ppm import ppm_reconstruct_all
from repro_torch.hydro.state import (
    HydroState, assemble_global, extract_subgrids,
)


def subgrid_rhs(u_padded: torch.Tensor, h, gamma: float, ghost: int,
                subgrid: int) -> torch.Tensor:
    """PPM reconstruct + central-upwind flux on padded sub-grids.

    u_padded: ([n,] F, P, P, P) -> dU/dt over the interior ([n,] F, S, S, S).
    ``h`` is a float, or one width per slot (n,).
    """
    recon = ppm_reconstruct_all(u_padded)
    return flux_divergence(recon, h, gamma, ghost, subgrid)


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


def courant_dt(u: torch.Tensor, cfg: HydroConfig) -> torch.Tensor:
    """Courant time step as a 0-dim tensor on ``u``'s device (no host
    sync)."""
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
