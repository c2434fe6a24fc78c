"""Global grid <-> sub-grid decomposition, Sedov IC, ghost-cell exchange:
the uniform grid and the two-level AMR grid.

The octree leaves form a uniform ``G^3`` array of ``S^3`` sub-grids.  The
per-sub-grid view ``(n_subgrids, F, P, P, P)`` with ``P = S + 2*ghost`` is
the unit of work of the aggregation strategies; ``extract_subgrids`` (the
one-device ghost exchange: ``kernels.extract``'s kernel on the card, pad +
gather on the CPU) and ``assemble_global`` convert between it and the
assembled ``(F, N, N, N)`` grid.  The extractions take ``out=``: a
contiguous tensor of the result's shape that they write into (an
aggregation executor's static parent).

Two-level AMR (``AMRState``): a coarse grid over the whole domain and one
centred fine patch.  ``extract_subgrids_multilevel`` is the two-level ghost
exchange: the coarse level sees the restricted fine solution under the
patch, the fine level's ghost band is prolongated from the coarse level.
Every function returns new tensors (or writes the ``out=`` it is given);
no level aliases another.

``state_from_numpy`` / ``state_to_numpy`` carry a conserved state across
from (and back to) the JAX reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import AMRHydroConfig, HydroConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.hydro.euler import prim_to_cons
from repro_torch.kernels.extract import PAD_MODES, extract


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

def extract_padded(up: torch.Tensor, subgrid: int, ghost: int,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Already padded (F, N+2g, N+2g, N+2g), any strides -> per-task (G^3,
    F, P, P, P) padded sub-grids, contiguous (into ``out`` if given)."""
    return extract(up, subgrid, ghost, "padded", out=out)


def extract_subgrids(u: torch.Tensor, subgrid: int, ghost: int,
                     bc: str = "outflow",
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Assembled (F, N, N, N) -> per-task (G^3, F, P, P, P) padded
    sub-grids, contiguous (into ``out`` if given); the ghost cells follow
    ``bc``: clamped (``outflow``) or wrapped (``periodic``)."""
    if bc not in PAD_MODES:
        raise ValueError(f"unknown boundary condition {bc!r}")
    return extract(u, subgrid, ghost, bc, out=out)


def assemble_global(sub_interior: torch.Tensor, subgrid: int) -> torch.Tensor:
    """Per-task interiors (G^3, F, S, S, S) -> assembled (F, N, N, N)."""
    nsub, f, s = sub_interior.shape[0], sub_interior.shape[1], subgrid
    grids = round(nsub ** (1.0 / 3.0))
    x = sub_interior.reshape(grids, grids, grids, f, s, s, s)
    x = x.permute(3, 0, 4, 1, 5, 2, 6)
    return x.reshape(f, grids * s, grids * s, grids * s)


# ---------------------------------------------------------------------------
# Two-level AMR: coarse grid + one centred fine patch (refine_ratio x)
# ---------------------------------------------------------------------------

@dataclass
class AMRState:
    """Two-level refined state: assembled per-level conserved grids."""
    uc: torch.Tensor      # (F, Nc, Nc, Nc) coarse level, whole domain
    uf: torch.Tensor      # (F, Nf, Nf, Nf) fine level, centred patch
    t: float
    step: int


def restrict_fine(uf: torch.Tensor, ratio: int = 2) -> torch.Tensor:
    """Fine -> coarse: average each ratio^3 block (conservative for equal
    cell volumes within a block)."""
    f, n = uf.shape[0], uf.shape[-1]
    m = n // ratio
    return uf.reshape(f, m, ratio, m, ratio, m, ratio).mean(dim=(2, 4, 6))


def prolong_coarse(uc: torch.Tensor, ratio: int = 2) -> torch.Tensor:
    """Coarse -> fine: piecewise-constant injection (each coarse cell fills
    its ratio^3 children)."""
    for axis in (1, 2, 3):
        uc = torch.repeat_interleave(uc, ratio, dim=axis)
    return uc


def sync_coarse(uc: torch.Tensor, uf: torch.Tensor,
                cfg: AMRHydroConfig) -> torch.Tensor:
    """A copy of ``uc`` whose covered cells hold the restricted fine
    solution (the coarse level never free-runs under the patch)."""
    o, c = cfg.offset, cfg.cover
    out = uc.clone()
    out[:, o:o + c, o:o + c, o:o + c] = restrict_fine(uf, cfg.refine_ratio)
    return out


def _fine_fill_ghosts(uc_synced: torch.Tensor, uf: torch.Tensor,
                      cfg: AMRHydroConfig) -> torch.Tensor:
    """Fine (F, Nf, Nf, Nf) -> padded (F, Nf+2g, ...): the ghost band is
    prolongated from the surrounding (already fine-synced) coarse cells —
    the coarse-fine boundary exchange."""
    g, r = cfg.ghost, cfg.refine_ratio
    gc = cfg.coarse_ghost_pad
    o, c, nf = cfg.offset, cfg.cover, cfg.n_fine
    slab = uc_synced[:, o - gc:o + c + gc, o - gc:o + c + gc,
                     o - gc:o + c + gc]
    fp = prolong_coarse(slab, r)       # a new tensor: nothing is aliased
    lo = gc * r - g                   # trim the prolongation to exactly g
    n = nf + 2 * g
    fp = fp[:, lo:lo + n, lo:lo + n, lo:lo + n]
    fp[:, g:g + nf, g:g + nf, g:g + nf] = uf
    return fp


def extract_subgrids_multilevel(
        uc: torch.Tensor, uf: torch.Tensor, cfg: AMRHydroConfig,
        bc: str = "outflow",
        out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
    """Two-level ghost exchange + decomposition: ``(subs_coarse,
    subs_fine)`` padded per-task tensors, contiguous (written into ``out``,
    a pair, if given).  The coarse level sees the restricted fine solution
    under the patch; the fine level's boundary ghosts are prolongated from
    the coarse level."""
    out_c, out_f = (None, None) if out is None else out
    ucs = sync_coarse(uc, uf, cfg)
    subs_c = extract_subgrids(ucs, cfg.coarse_subgrid, cfg.ghost, bc,
                              out=out_c)
    subs_f = extract_padded(_fine_fill_ghosts(ucs, uf, cfg),
                            cfg.fine_subgrid, cfg.ghost, out=out_f)
    return subs_c, subs_f


def amr_sedov_init(cfg: AMRHydroConfig, dtype=None,
                   device: DeviceLike = None) -> AMRState:
    """Sedov blast centred in the fine patch: the energy deposit lives
    entirely at fine resolution (r0 = 3.5 fine cells, well inside the
    patch); the coarse level starts ambient and is synced from the fine.
    The state's dtype follows ``cfg.dtype`` unless given."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype) if dtype is None else dtype
    hc, hf = cfg.h_coarse, cfg.h_fine
    nf = cfg.n_fine
    x0 = cfg.offset * hc - 0.5 * cfg.domain
    xf = x0 + (torch.arange(nf, device=dev) + 0.5) * hf
    Xf, Yf, Zf = torch.meshgrid(xf, xf, xf, indexing="ij")
    r = torch.sqrt(Xf * Xf + Yf * Yf + Zf * Zf)
    r0 = 3.5 * hf
    in_blast = r < r0
    n_blast = torch.clamp_min(in_blast.sum(), 1).to(r.dtype)
    e_dens = torch.div(torch.full_like(n_blast, cfg.blast_energy),
                       n_blast * hf ** 3)
    p_blast = (cfg.gamma - 1.0) * e_dens
    p_ambient = 1e-8
    rho_f = torch.full_like(r, cfg.rho0)
    p_f = torch.where(in_blast, p_blast, p_ambient)
    zeros_f = torch.zeros_like(rho_f)
    uf = prim_to_cons(rho_f, zeros_f, zeros_f, zeros_f, p_f,
                      cfg.gamma).to(dtype)

    nc = cfg.n_coarse
    rho_c = torch.full((nc, nc, nc), cfg.rho0, device=dev)
    zeros_c = torch.zeros_like(rho_c)
    p_c = torch.full((nc, nc, nc), p_ambient, device=dev)
    uc = prim_to_cons(rho_c, zeros_c, zeros_c, zeros_c, p_c,
                      cfg.gamma).to(dtype)
    return AMRState(uc=sync_coarse(uc, uf, cfg), uf=uf, t=0.0, step=0)
