"""Inviscid Euler equations: conserved <-> primitive maps and point fluxes.

A frozen copy of the plain formulas the benchmark holds the program to.

Field layout matches the reference: ``U = (rho, Sx, Sy, Sz, E)`` with
momentum ``S = rho*v`` and total energy ``E = rho*e + 0.5*rho*|v|^2``.  The
field axis is dim -4 of every state tensor, ``(..., F, X, Y, Z)``, so a
leading batch (slot) dimension passes straight through.
"""
from __future__ import annotations

import torch

N_FIELDS = 5
RHO, SX, SY, SZ, EN = range(N_FIELDS)

# Density/pressure floors, as in the reference (the Sedov IC has
# near-zero pressure outside the blast).
RHO_FLOOR = 1e-10
P_FLOOR = 1e-12

FIELD_DIM = -4


def cons_to_prim(u: torch.Tensor, gamma: float, dim: int = FIELD_DIM):
    """(..., 5, X, Y, Z) conserved -> (rho, vx, vy, vz, p); ``dim`` is the
    field axis (0 in the lane-major layout)."""
    rho_raw, sx, sy, sz, en = u.unbind(dim)
    rho = torch.clamp_min(rho_raw, RHO_FLOOR)
    vx, vy, vz = sx / rho, sy / rho, sz / rho
    ke = 0.5 * rho * (vx * vx + vy * vy + vz * vz)
    p = torch.clamp_min((gamma - 1.0) * (en - ke), P_FLOOR)
    return rho, vx, vy, vz, p


def prim_to_cons(rho, vx, vy, vz, p, gamma: float) -> torch.Tensor:
    e = p / (gamma - 1.0) + 0.5 * rho * (vx * vx + vy * vy + vz * vz)
    return torch.stack([rho, rho * vx, rho * vy, rho * vz, e], dim=FIELD_DIM)


def sound_speed(rho, p, gamma: float):
    return torch.sqrt(gamma * p / rho)


def euler_flux(u: torch.Tensor, axis: int, gamma: float,
               dim: int = FIELD_DIM) -> torch.Tensor:
    """Physical flux F_axis(U): (..., 5, X, Y, Z) -> same shape; ``dim``
    is the field axis."""
    rho, vx, vy, vz, p = cons_to_prim(u, gamma, dim)
    v = (vx, vy, vz)[axis]
    _, sx, sy, sz, en = u.unbind(dim)
    f = [rho * v, sx * v, sy * v, sz * v, (en + p) * v]
    # pressure contribution to the momentum component along `axis`
    f[SX + axis] = f[SX + axis] + p
    return torch.stack(f, dim=dim)


def max_signal_speed(u: torch.Tensor, gamma: float) -> torch.Tensor:
    """max over cells of (|v| + c) — the Courant-condition signal speed."""
    rho, vx, vy, vz, p = cons_to_prim(u, gamma)
    c = sound_speed(rho, p, gamma)
    vmag = torch.sqrt(vx * vx + vy * vy + vz * vz)
    return torch.max(vmag + c)
