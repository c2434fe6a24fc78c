"""Central-upwind fluxes at 9 quadrature points per face + Simpson quadrature.

A frozen copy of the plain formulas the benchmark holds the program to.

For each face (axis a, between cells i and i+e_a) the flux is evaluated at
the 3x3 quadrature points (face centre, 4 edge midpoints, 4 vertices) with
the central-upwind scheme of Kurganov et al. (paper ref [40]) and integrated
with Simpson weights (1,4,1)x(1,4,1)/36.

The left state at quadrature point ``(+e_a, t)`` of cell ``i`` is the PPM
surface value of cell ``i`` toward ``d = e_a + t``; the right state is the
surface value of cell ``i+e_a`` toward ``-d' = -(e_a - t)``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .euler import (
    FIELD_DIM, cons_to_prim, euler_flux, sound_speed,
)
from .ppm import PAIR_INDEX, _shift

# (weight, transverse offset) for the 3-point Simpson rule
_W1D = {-1: 1.0 / 6.0, 0: 4.0 / 6.0, 1: 1.0 / 6.0}
AXIS_VECS = ((1, 0, 0), (0, 1, 0), (0, 0, 1))

# FACE_QUAD[axis] = list of (weight, pair_L, plus_side_L, pair_R, plus_side_R):
# the L value is recon[pair_L][plus_side_L] of cell i, the R value
# recon[pair_R][plus_side_R] of cell i+e_a.
FACE_QUAD = {}


def _canon(d: Tuple[int, int, int]):
    """Canonical pair representative and whether d is the + member."""
    for c in d:
        if c != 0:
            return (d, True) if c > 0 else (tuple(-x for x in d), False)
    raise ValueError(d)


def _build_face_quad():
    for a, e in enumerate(AXIS_VECS):
        entries = []
        for t1 in (-1, 0, 1):
            for t2 in (-1, 0, 1):
                t = [0, 0, 0]
                dims = [i for i in range(3) if i != a]
                t[dims[0]], t[dims[1]] = t1, t2
                dL = tuple(e[i] + t[i] for i in range(3))
                dR = tuple(-e[i] + t[i] for i in range(3))
                cL, plusL = _canon(dL)
                cR, plusR = _canon(dR)
                w = _W1D[t1] * _W1D[t2]
                entries.append((w, PAIR_INDEX[cL], int(plusL),
                                PAIR_INDEX[cR], int(plusR)))
        FACE_QUAD[a] = entries


_build_face_quad()


def central_upwind(uL: torch.Tensor, uR: torch.Tensor, axis: int,
                   gamma: float, dim: int = FIELD_DIM) -> torch.Tensor:
    """Kurganov-Noelle-Petrova central-upwind flux.  u*: (..., F, X, Y, Z),
    or any layout whose field axis is ``dim``."""
    rhoL, vxL, vyL, vzL, pL = cons_to_prim(uL, gamma, dim)
    rhoR, vxR, vyR, vzR, pR = cons_to_prim(uR, gamma, dim)
    vL = (vxL, vyL, vzL)[axis]
    vR = (vxR, vyR, vzR)[axis]
    cL = sound_speed(rhoL, pL, gamma)
    cR = sound_speed(rhoR, pR, gamma)
    ap = torch.clamp_min(torch.maximum(vL + cL, vR + cR), 0.0)
    am = torch.clamp_max(torch.minimum(vL - cL, vR - cR), 0.0)
    fL = euler_flux(uL, axis, gamma, dim)
    fR = euler_flux(uR, axis, gamma, dim)
    span = ap - am
    # guard the degenerate (vacuum-like) case
    ok = span > 1e-12
    inv = torch.where(ok, 1.0 / torch.clamp_min(span, 1e-12), 0.0)
    ap, am, inv, ok = (x.unsqueeze(dim) for x in (ap, am, inv, ok))
    flux = (ap * fL - am * fR) * inv + (ap * am) * inv * (uR - uL)
    return torch.where(ok, flux, 0.5 * (fL + fR))


def face_flux(recon: torch.Tensor, axis: int, gamma: float) -> torch.Tensor:
    """Simpson-integrated flux through the +axis face of every cell.

    recon: (..., N_PAIRS, 2, F, X, Y, Z).  Returns (..., F, X, Y, Z).
    """
    e = AXIS_VECS[axis]
    total = None
    for (w, pL, sL, pR, sR) in FACE_QUAD[axis]:
        uL = recon[..., pL, sL, :, :, :, :]
        uR = _shift(recon[..., pR, sR, :, :, :, :], e, 1)  # cell i+e_a
        f = central_upwind(uL, uR, axis, gamma)
        total = w * f if total is None else total + w * f
    return total


def as_width(h, like: torch.Tensor):
    """A scalar width stays a float; per-slot widths (n,) broadcast over
    (n, F, S, S, S)."""
    if isinstance(h, torch.Tensor) and h.dim() > 0:
        return h.reshape(h.shape + (1,) * (like.dim() - h.dim()))
    return h


def flux_divergence(recon: torch.Tensor, h, gamma: float, ghost: int,
                    subgrid: int) -> torch.Tensor:
    """-div(F) over the interior of padded sub-grids.

    recon: (..., N_PAIRS, 2, F, P, P, P).  Returns dU/dt: (..., F, S, S, S).
    ``h`` is a float or one width per leading slot, shape (n,).
    """
    g, s = ghost, subgrid
    out = None
    for axis in range(3):
        fp = face_flux(recon, axis, gamma)             # flux at +face of cell i
        lo = [g, g, g]
        hi = [g + s, g + s, g + s]
        f_hi = fp[..., lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        # F_{i-1/2} = +face flux of cell i-e_a
        lo[axis] -= 1
        hi[axis] -= 1
        f_lo = fp[..., lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
        d = (f_hi - f_lo) / as_width(h, f_hi)
        out = -d if out is None else out - d
    return out
