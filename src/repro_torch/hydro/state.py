"""Global grid <-> sub-grid decomposition, Sedov IC, ghost-cell exchange
(uniform grid, AMR off).

The octree leaves form a uniform ``G^3`` array of ``S^3`` sub-grids.  The
per-sub-grid view ``(n_subgrids, F, P, P, P)`` with ``P = S + 2*ghost`` is
the unit of work of the aggregation strategies; ``extract_subgrids`` (pad +
gather, the one-device ghost exchange) and ``assemble_global`` convert
between it and the assembled ``(F, N, N, N)`` grid.

``state_from_numpy`` / ``state_to_numpy`` carry a conserved state across
from (and back to) the JAX reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import HydroConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.hydro.euler import prim_to_cons


@dataclass
class HydroState:
    u: torch.Tensor       # (F, N, N, N) conserved, assembled global grid
    t: float
    step: int


def state_from_numpy(u: np.ndarray, device: DeviceLike = None) -> torch.Tensor:
    """A conserved ``(F, N, N, N)`` array (e.g. a JAX state) as an fp32
    tensor on ``device``."""
    return torch.tensor(np.asarray(u, dtype=np.float32),
                        device=resolve_device(device))


def state_to_numpy(u: torch.Tensor) -> np.ndarray:
    return u.detach().cpu().numpy()


def grid_coords(cfg: HydroConfig, device: DeviceLike = None):
    dev = resolve_device(device)
    n = cfg.grids_per_edge * cfg.subgrid
    h = cfg.domain / n
    x = (torch.arange(n, device=dev) + 0.5) * h - 0.5 * cfg.domain
    return torch.meshgrid(x, x, x, indexing="ij"), h


def sedov_init(cfg: HydroConfig, dtype=torch.float32,
               device: DeviceLike = None) -> HydroState:
    """Sedov-Taylor blast wave: cold uniform medium, energy E dumped into a
    small sphere around the origin (paper ref [43])."""
    (X, Y, Z), h = grid_coords(cfg, device)
    r = torch.sqrt(X * X + Y * Y + Z * Z)
    r0 = 3.5 * h
    in_blast = r < r0
    n_blast = torch.clamp_min(in_blast.sum(), 1).to(r.dtype)
    cell_vol = h ** 3
    # deposit E uniformly over the blast cells as internal energy
    e_dens = torch.div(torch.full_like(n_blast, cfg.blast_energy),
                       n_blast * cell_vol)
    p_blast = (cfg.gamma - 1.0) * e_dens
    p_ambient = 1e-8
    rho = torch.full_like(r, cfg.rho0)
    p = torch.where(in_blast, p_blast, p_ambient)
    zeros = torch.zeros_like(rho)
    u = prim_to_cons(rho, zeros, zeros, zeros, p, cfg.gamma).to(dtype)
    return HydroState(u=u, t=0.0, step=0)


# ---------------------------------------------------------------------------
# decomposition
# ---------------------------------------------------------------------------

def fill_ghosts(u: torch.Tensor, ghost: int, bc: str = "outflow"):
    """(F, N, N, N) -> (F, N+2g, N+2g, N+2g) with boundary condition."""
    mode = {"outflow": "replicate", "periodic": "circular"}.get(bc)
    if mode is None:
        raise ValueError(f"unknown boundary condition {bc!r}")
    return F.pad(u, (ghost,) * 6, mode=mode)


def extract_subgrids(u: torch.Tensor, subgrid: int, ghost: int,
                     bc: str = "outflow") -> torch.Tensor:
    """Assembled (F, N, N, N) -> per-task (G^3, F, P, P, P) padded
    sub-grids, contiguous."""
    f, n = u.shape[0], u.shape[-1]
    grids, p = n // subgrid, subgrid + 2 * ghost
    up = fill_ghosts(u, ghost, bc)
    blocks = up.unfold(1, p, subgrid).unfold(2, p, subgrid).unfold(
        3, p, subgrid)                                # (F, G, G, G, P, P, P)
    return blocks.permute(1, 2, 3, 0, 4, 5, 6).reshape(grids ** 3, f, p, p, p)


def assemble_global(sub_interior: torch.Tensor, subgrid: int) -> torch.Tensor:
    """Per-task interiors (G^3, F, S, S, S) -> assembled (F, N, N, N)."""
    nsub, f, s = sub_interior.shape[0], sub_interior.shape[1], subgrid
    grids = round(nsub ** (1.0 / 3.0))
    x = sub_interior.reshape(grids, grids, grids, f, s, s, s)
    x = x.permute(3, 0, 4, 1, 5, 2, 6)
    return x.reshape(f, grids * s, grids * s, grids * s)
