"""Operation counts of the hydro and gravity kernels: the fp32 operations
each function needs for ``n`` slots.

``chip_smoke.py`` divides them by the card's fp32 rate for each kernel's
bound, and the warm-start prior
(:class:`~repro_torch.core.tunestore.RooflinePrior`) charges them per task
of a family whose body carries ``ops_per_task`` (the ``kernels.ops``
bodies do), so both read one count.  Each count is memoised per shape.
"""
from __future__ import annotations

import itertools
from functools import lru_cache


@lru_cache(maxsize=None)
def _hydro_rhs_per_slot(subgrid: int, ghost: int) -> int:
    from repro_torch.hydro.flux import FACE_QUAD
    from repro_torch.hydro.ppm import DIR_PAIRS

    states, face_points = set(), 0
    for a in range(3):
        span = [range(ghost - 1, ghost + subgrid) if d == a
                else range(ghost, ghost + subgrid) for d in range(3)]
        for (_, pl, sl, pr, sr) in FACE_QUAD[a]:
            for c in itertools.product(*span):
                right = tuple(c[d] + (d == a) for d in range(3))
                states.add((pl, sl, c))
                states.add((pr, sr, right))
            face_points += (subgrid + 1) * subgrid * subgrid
    recon = {(pair, c) for (pair, _, c) in states}
    faces = set()
    for pair, c in recon:
        d = DIR_PAIRS[pair]
        faces.add((pair, c))
        faces.add((pair, tuple(c[k] - d[k] for k in range(3))))
    plus = sum(1 for (_, side, _) in states if side)
    per_field = (5 * len(faces) + 11 * len(recon) + 5 * plus
                 + 4 * (len(states) - plus))
    return (5 * per_field + 17 * len(states) + 63 * face_points
            + 85 * 3 * (subgrid + 1) * subgrid * subgrid
            + 3 * 3 * 5 * subgrid ** 3)


def hydro_rhs_ops(n: int, subgrid: int, ghost: int = 3) -> int:
    """fp32 operations the function needs for n slots: the reference's
    branch-free formulas with every distinct value computed once (add,
    sub, mul, div, sqrt, min, max, compare each one; selects and index
    arithmetic not counted).  Per field:

    * each PPM interface value once, shared by the two cells beside it: 5;
    * each (pair, cell) the consumed faces read: extremum test 4, du 1,
      u6 4, du*du and du*u6 2; then each side used, 5 toward +d, 4
      toward -d;

    per reconstructed state, primitives 14 and sound speed 3; per face
    point, signal speeds 8, physical fluxes 14, span and test 2, KNP flux
    39 (the span > 1e-12 branch: the pressure floor keeps the sound speed,
    and so the span, above it for any density below 1e12); per face, 9
    weights and 8 accumulating adds per field; per cell, field and axis,
    3 for the divergence.
    """
    return n * _hydro_rhs_per_slot(subgrid, ghost)


def gravity_ops(n: int, subgrid: int, ghost: int, n_iter: int) -> int:
    """fp32 operations the gravity function needs for n slots: the
    right-hand side (2 per cell off the frame, and h*h and 0.5/h once); the
    first sweep from phi = 0 (1 per cell: -rhs / 6); each later sweep 7 per
    cell (5 adds, a subtract, a divide), but the last only on the cells the
    gradient reads (the interior and one layer beyond each face, S^3 +
    6 S^2); the gradient 2 per cell and axis."""
    m = subgrid + 2 * ghost - 2
    last = subgrid ** 3 + 6 * subgrid ** 2
    per_slot = (2 * m ** 3 + 2 + m ** 3 + 7 * m ** 3 * max(n_iter - 2, 0)
                + 7 * last * (n_iter >= 2) + 6 * subgrid ** 3)
    return n * per_slot


def reconstruct_ops(n: int, p: int) -> int:
    """fp32 operations of Reconstruct for n slots: per (pair, field, cell)
    of the padded block, one interface value (5; each is shared by the two
    cells beside it), the limiter's extremum test, du, u6 and tests (11),
    and both sides (5 toward +d, 4 toward -d)."""
    return n * 13 * 5 * p ** 3 * (5 + 11 + 9)


@lru_cache(maxsize=None)
def _flux_per_slot(subgrid: int, ghost: int) -> int:
    from repro_torch.kernels.hydro_split import flux_read_states

    faces = (subgrid + 1) * subgrid * subgrid
    return (17 * len(flux_read_states(subgrid, ghost))
            + 63 * 3 * 9 * faces + 85 * 3 * faces
            + 3 * 3 * 5 * subgrid ** 3)


def flux_ops(n: int, subgrid: int, ghost: int = 3) -> int:
    """fp32 operations of Flux for n slots: ``hydro_rhs_ops`` without the
    reconstruction, i.e. per staged state read, primitives and sound speed
    (17); per face point, signal speeds, physical fluxes, span, test and
    KNP flux (63); per face, weights and accumulation (85); per cell, field
    and axis, the divergence (3)."""
    return n * _flux_per_slot(subgrid, ghost)
