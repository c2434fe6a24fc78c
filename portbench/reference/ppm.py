"""Piecewise-parabolic (PPM) reconstruction at 26 quadrature points per cell.

A frozen copy of the plain formulas the benchmark holds the program to.

For each of the 13 direction pairs ``{d, -d}`` (canonical member has its
first nonzero component positive) a 1D CW84 limited parabola is built along
``u(i + k*d), k = -2..2`` and evaluated at +-1/2 step, giving the surface
values toward ``-d`` and ``+d`` (paper §IV-B).

Shifts use ``torch.roll`` as the reference's ``jnp.roll``; wrap-around only
touches cells within 2 of the array edge, which are ghost cells whose
reconstructions are never consumed.  Every function takes ``(..., X, Y, Z)``
tensors, so a leading slot dimension is just a batch dimension.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

SPATIAL_DIMS = (-3, -2, -1)


def _canonical(d: Tuple[int, int, int]) -> bool:
    for c in d:
        if c != 0:
            return c > 0
    return False


# all 26 offsets; 13 canonical pair representatives, faces first then edges
# then vertices (sorted by |d|^2 = 1, 2, 3) — the reference's order.
DIRECTIONS: List[Tuple[int, int, int]] = [
    (dx, dy, dz)
    for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
    if (dx, dy, dz) != (0, 0, 0)
]
DIR_PAIRS: List[Tuple[int, int, int]] = sorted(
    [d for d in DIRECTIONS if _canonical(d)],
    key=lambda d: (d[0] ** 2 + d[1] ** 2 + d[2] ** 2, d),
)
PAIR_INDEX = {d: i for i, d in enumerate(DIR_PAIRS)}
N_PAIRS = len(DIR_PAIRS)  # 13


def _shift(u: torch.Tensor, d: Tuple[int, int, int], k: int,
           dims: Tuple[int, int, int] = SPATIAL_DIMS) -> torch.Tensor:
    """u(i + k*d) over the spatial dims ``dims``, by default the three
    trailing ones (roll)."""
    if k == 0:
        return u
    return torch.roll(u, shifts=(-k * d[0], -k * d[1], -k * d[2]),
                      dims=dims)


def ppm_pair(u: torch.Tensor, d: Tuple[int, int, int],
             dims: Tuple[int, int, int] = SPATIAL_DIMS):
    """Limited-parabola surface values of every cell toward -d and +d.

    u: (..., X, Y, Z), or any layout whose spatial dims are ``dims``.
    Returns (u_minus, u_plus), same shape as u.  Colella & Woodward (1984):
    4th-order interface interpolation followed by monotonicity limiting of
    the per-cell parabola.
    """
    um2 = _shift(u, d, -2, dims)
    um1 = _shift(u, d, -1, dims)
    up1 = _shift(u, d, 1, dims)
    up2 = _shift(u, d, 2, dims)

    # interface values u_{i-1/2}, u_{i+1/2} along the d-line
    ul = (7.0 / 12.0) * (um1 + u) - (1.0 / 12.0) * (um2 + up1)
    ur = (7.0 / 12.0) * (u + up1) - (1.0 / 12.0) * (um1 + up2)

    # 1) local extremum -> flatten to piecewise constant
    extremum = (ur - u) * (u - ul) <= 0.0
    # 2) parabola overshoot -> move the far endpoint
    du = ur - ul
    u6 = 6.0 * (u - 0.5 * (ul + ur))
    ul_new = torch.where(du * u6 > du * du, 3.0 * u - 2.0 * ur, ul)
    ur_new = torch.where(-(du * du) > du * u6, 3.0 * u - 2.0 * ul, ur)
    ul = torch.where(extremum, u, ul_new)
    ur = torch.where(extremum, u, ur_new)
    return ul, ur


def ppm_reconstruct_all(u: torch.Tensor) -> torch.Tensor:
    """Reconstruct all 13 direction pairs.

    u: (..., F, X, Y, Z).  Returns (..., N_PAIRS, 2, F, X, Y, Z): index
    [p, 0] is the surface value toward ``-DIR_PAIRS[p]``, [p, 1] toward
    ``+``.
    """
    outs = [torch.stack(ppm_pair(u, d), dim=-5) for d in DIR_PAIRS]
    return torch.stack(outs, dim=-6)
