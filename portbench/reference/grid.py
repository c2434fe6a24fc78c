"""Grid <-> padded sub-grids, and the two-level ghost exchange, in plain
PyTorch.

The uniform grid is a ``G^3`` array of ``S^3`` sub-grids with outflow
(replicating) boundaries.  The two-level grid is a coarse level over the
whole domain and one centred fine patch refined ``ratio`` times: the
coarse level sees the restricted fine solution under the patch, and the
fine level's ghost band is the coarse level prolongated by injection.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class Uniform:
    """A uniform grid of ``(2^levels)^3`` sub-grids of ``subgrid^3``."""
    subgrid: int
    ghost: int
    levels: int
    gamma: float
    cfl: float
    domain: float = 1.0

    @property
    def n(self) -> int:
        return 2 ** self.levels * self.subgrid

    @property
    def h(self) -> float:
        return self.domain / self.n


@dataclass(frozen=True)
class TwoLevel:
    """A coarse grid of ``coarse_grids_per_edge^3`` sub-grids and a centred
    fine patch over ``cover^3`` coarse cells, both of ``subgrid^3``."""
    subgrid: int
    ghost: int
    coarse_grids_per_edge: int
    cover: int
    refine_ratio: int
    gamma: float
    cfl: float
    domain: float = 1.0

    @property
    def n_coarse(self) -> int:
        return self.coarse_grids_per_edge * self.subgrid

    @property
    def n_fine(self) -> int:
        return self.cover * self.refine_ratio

    @property
    def offset(self) -> int:
        return (self.n_coarse - self.cover) // 2

    @property
    def h_coarse(self) -> float:
        return self.domain / self.n_coarse

    @property
    def h_fine(self) -> float:
        return self.h_coarse / self.refine_ratio

    @property
    def coarse_ghost_pad(self) -> int:
        return -(-self.ghost // self.refine_ratio)


def extract(u: torch.Tensor, subgrid: int, ghost: int) -> torch.Tensor:
    """Assembled ``(F, N, N, N)`` -> padded sub-grids ``(G^3, F, P, P,
    P)`` with outflow boundaries."""
    return extract_padded(F.pad(u, (ghost,) * 6, mode="replicate"),
                          subgrid, ghost)


def extract_padded(up: torch.Tensor, subgrid: int,
                   ghost: int) -> torch.Tensor:
    f, n = up.shape[0], up.shape[-1] - 2 * ghost
    grids, p = n // subgrid, subgrid + 2 * ghost
    blocks = up.unfold(1, p, subgrid).unfold(2, p, subgrid).unfold(
        3, p, subgrid)
    return blocks.permute(1, 2, 3, 0, 4, 5, 6).reshape(grids ** 3, f, p, p, p)


def assemble(sub: torch.Tensor, subgrid: int) -> torch.Tensor:
    """Sub-grid interiors ``(G^3, F, S, S, S)`` -> ``(F, N, N, N)``."""
    n_sub, f, s = sub.shape[0], sub.shape[1], subgrid
    grids = round(n_sub ** (1.0 / 3.0))
    x = sub.reshape(grids, grids, grids, f, s, s, s).permute(
        3, 0, 4, 1, 5, 2, 6)
    return x.reshape(f, grids * s, grids * s, grids * s)


def restrict(uf: torch.Tensor, ratio: int) -> torch.Tensor:
    f, n = uf.shape[0], uf.shape[-1]
    m = n // ratio
    return uf.reshape(f, m, ratio, m, ratio, m, ratio).mean(dim=(2, 4, 6))


def prolong(uc: torch.Tensor, ratio: int) -> torch.Tensor:
    for axis in (1, 2, 3):
        uc = torch.repeat_interleave(uc, ratio, dim=axis)
    return uc


def sync_coarse(uc: torch.Tensor, uf: torch.Tensor,
                g: TwoLevel) -> torch.Tensor:
    """A copy of ``uc`` whose covered cells hold the restricted fine
    level."""
    o, c = g.offset, g.cover
    out = uc.clone()
    out[:, o:o + c, o:o + c, o:o + c] = restrict(uf, g.refine_ratio)
    return out


def exchange(uc: torch.Tensor, uf: torch.Tensor, g: TwoLevel):
    """The two-level ghost exchange: padded ``(coarse, fine)`` sub-grids."""
    ucs = sync_coarse(uc, uf, g)
    subs_c = extract(ucs, g.subgrid, g.ghost)
    gh, r, gc = g.ghost, g.refine_ratio, g.coarse_ghost_pad
    o, c, nf = g.offset, g.cover, g.n_fine
    slab = ucs[:, o - gc:o + c + gc, o - gc:o + c + gc, o - gc:o + c + gc]
    fp = prolong(slab, r)
    lo, n = gc * r - gh, nf + 2 * gh
    fp = fp[:, lo:lo + n, lo:lo + n, lo:lo + n]
    fp[:, gh:gh + nf, gh:gh + nf, gh:gh + nf] = uf
    return subs_c, extract_padded(fp, g.subgrid, gh)
