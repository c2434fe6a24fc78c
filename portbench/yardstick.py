"""The benchmark's yardstick: the operations and bytes of the hydro
right-hand side, and the card's published peaks.

A frozen copy: the program's own counts (``kernels/counts.py``) may move,
these do not (a CPU test holds them equal today).  Operations are the
branch-free formulas' fp32 operations with every distinct value computed
once (``hydro_rhs_ops``'s docstring in the program says which); bytes are
each input byte read once and each output byte written once.
"""
from __future__ import annotations

import itertools
from functools import lru_cache


def _canon(d):
    """A direction's pair representative (first nonzero component
    positive) and whether ``d`` is its + member."""
    first = next(c for c in d if c != 0)
    return (d, True) if first > 0 else (tuple(-c for c in d), False)


# the 13 direction pairs of the PPM reconstruction, faces, then edges,
# then vertices; and per axis each face quadrature point's (pair of the
# left state, its side, pair of the right state, its side)
DIR_PAIRS = sorted({_canon(d)[0] for d in itertools.product((-1, 0, 1),
                                                            repeat=3)
                    if d != (0, 0, 0)},
                   key=lambda d: (sum(c * c for c in d), d))
_PAIR = {d: i for i, d in enumerate(DIR_PAIRS)}
FACE_QUAD = {}
for _a in range(3):
    _quad = []
    for _t in itertools.product((-1, 0, 1), repeat=2):
        _t3 = list(_t)
        _t3.insert(_a, 0)
        (_pl, _sl), (_pr, _sr) = (
            _canon(tuple(_t3[i] + s * (i == _a) for i in range(3)))
            for s in (1, -1))
        _quad.append((_PAIR[_pl], int(_sl), _PAIR[_pr], int(_sr)))
    FACE_QUAD[_a] = _quad

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAKS = {"fp32_flop_per_s": 67e12, "bf16_flop_per_s": 989e12,
         "hbm_bytes_per_s": 3.35e12}


@lru_cache(maxsize=None)
def _hydro_rhs_per_slot(subgrid: int, ghost: int) -> int:
    states, face_points = set(), 0
    for a in range(3):
        span = [range(ghost - 1, ghost + subgrid) if d == a
                else range(ghost, ghost + subgrid) for d in range(3)]
        for (pl, sl, pr, sr) in FACE_QUAD[a]:
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
    """fp32 operations of the hydro right-hand side over ``n`` sub-grids."""
    return n * _hydro_rhs_per_slot(subgrid, ghost)


def hydro_rhs_bytes(n: int, subgrid: int, ghost: int = 3,
                    n_fields: int = 5) -> int:
    """fp32 bytes: each padded input read once, each interior written
    once."""
    p = subgrid + 2 * ghost
    return 4 * n * n_fields * (p ** 3 + subgrid ** 3)


def roofline_s(ops: float, n_bytes: float,
               flop_per_s: float = PEAKS["fp32_flop_per_s"]) -> float:
    """The least time the card can take: the larger of operations over
    the peak rate and bytes over the memory bandwidth."""
    return max(ops / flop_per_s, n_bytes / PEAKS["hbm_bytes_per_s"])
