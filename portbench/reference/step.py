"""The Courant dt and one TVD-RK3 step of the uniform and the two-level
grid, in plain PyTorch, in any floating dtype.

The right-hand side is PPM reconstruction plus the central-upwind flux
divergence over padded sub-grids, evaluated ``block`` sub-grids at a time
(each block's reconstruction holds 26 surface values per cell and field).
The Shu-Osher combine keeps one expression order, ``u + dt*l``, ``0.75*u
+ 0.25*(u1 + dt*l1)``, ``(1/3)*u + (2/3)*(u2 + dt*l2)``.  Nothing here
reads a table, a weight or a state that another program made: it works
everything out from the state it is given.
"""
from __future__ import annotations

import torch

from .euler import max_signal_speed
from .flux import flux_divergence
from .grid import TwoLevel, Uniform, assemble, exchange, extract, sync_coarse
from .ppm import ppm_reconstruct_all

BLOCK = 2048         # sub-grids per right-hand-side evaluation


def subgrid_rhs(subs: torch.Tensor, h, gamma: float, ghost: int,
                subgrid: int, block: int = BLOCK) -> torch.Tensor:
    """``(n, F, P, P, P)`` -> ``dU/dt`` over the interiors ``(n, F, S, S,
    S)``; ``h`` a float or one width per sub-grid ``(n,)``."""
    out = []
    for i in range(0, subs.shape[0], block):
        part = subs[i:i + block]
        width = h[i:i + block] if isinstance(h, torch.Tensor) else h
        out.append(flux_divergence(ppm_reconstruct_all(part), width, gamma,
                                   ghost, subgrid))
    return torch.cat(out)


def shu_osher(rhs, state, dt):
    """One Shu-Osher TVD-RK3 combine over ``rhs``; a state is a tuple of
    levels, combined level by level."""
    def each(fn, *states):
        return tuple(fn(*levels) for levels in zip(*states))

    l0 = rhs(state)
    u1 = each(lambda u, l: u + dt * l, state, l0)
    l1 = rhs(u1)
    u2 = each(lambda u, a, l: 0.75 * u + 0.25 * (a + dt * l), state, u1, l1)
    l2 = rhs(u2)
    return each(lambda u, a, l: (1.0 / 3.0) * u + (2.0 / 3.0) * (a + dt * l),
                state, u2, l2)


def uniform_courant_dt(u: torch.Tensor, g: Uniform) -> torch.Tensor:
    speed = max_signal_speed(u, g.gamma)
    return torch.div(torch.full_like(speed, g.cfl * g.h), speed)


def uniform_step(u: torch.Tensor, dt, g: Uniform,
                 block: int = BLOCK) -> torch.Tensor:
    def rhs(state):
        subs = extract(state[0], g.subgrid, g.ghost)
        return (assemble(subgrid_rhs(subs, g.h, g.gamma, g.ghost, g.subgrid,
                                     block), g.subgrid),)
    return shu_osher(rhs, (u,), dt)[0]


def two_level_courant_dt(uc: torch.Tensor, uf: torch.Tensor,
                         g: TwoLevel) -> torch.Tensor:
    sc = max_signal_speed(uc, g.gamma)
    sf = max_signal_speed(uf, g.gamma)
    return g.cfl * torch.minimum(
        torch.div(torch.full_like(sc, g.h_coarse), sc),
        torch.div(torch.full_like(sf, g.h_fine), sf))


def two_level_step(uc: torch.Tensor, uf: torch.Tensor, dt, g: TwoLevel,
                   block: int = BLOCK):
    """Both levels in lockstep under one dt; the covered coarse cells take
    the restricted fine level at the end of the step."""
    def rhs(state):
        subs_c, subs_f = exchange(state[0], state[1], g)
        return tuple(
            assemble(subgrid_rhs(subs, torch.full(
                (subs.shape[0],), h, dtype=subs.dtype, device=subs.device),
                g.gamma, g.ghost, g.subgrid, block), g.subgrid)
            for subs, h in ((subs_c, g.h_coarse), (subs_f, g.h_fine)))
    uc_new, uf_new = shu_osher(rhs, (uc, uf), dt)
    return sync_coarse(uc_new, uf_new, g), uf_new
