"""The initial state of a cell, made from ``--seed`` on the run's device.

A Sedov-Taylor blast (the energy deposited as pressure over the cells
within 3.5 cell widths of the origin, on the finest level) in an ambient
medium that moves: its mean pressure is ``pressure_ratio`` of the
blast's, its velocity ``mach`` times its mean sound speed, and its
density and pressure carry relative perturbations of ``rho_amplitude``
and ``p_amplitude``.  Each of the five fields (density, pressure, three
velocity components) is the mean of ``modes`` plane waves with random
directions and phases and wavelengths between ``wavelength_subgrids``
sub-grid widths of the coarsest level.  So every sub-grid's first steps
change each of its fields by far more than fp32 rounds (about a percent
over three steps), while the blast's pressure stays ``1/pressure_ratio``
times the ambient one; the ambient is fixed in cells and steps at every
size, since it is set relative to the blast.  The sizes and the work are
the same for every seed.  On the two-level grid the blast lives on the
fine patch and the coarse level takes the restricted fine solution under
it.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.euler import prim_to_cons
from portbench.reference.grid import TwoLevel, Uniform, sync_coarse

BLAST_CELLS = 3.5     # blast radius in cell widths of the finest level
N_WAVE_FIELDS = 5     # density, pressure, vx, vy, vz


def _modes(seed: int, spec: dict, subgrid_width: float,
           device: torch.device):
    """Wavevectors ``(5, M, 3)`` and phases ``(5, M)``, drawn by a
    generator on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2 ** 63 - 1))
    m = int(spec["modes"])
    lo, hi = spec["wavelength_subgrids"]
    shape = (N_WAVE_FIELDS, m)
    direction = torch.randn(shape + (3,), generator=gen, device=device)
    direction = direction / direction.norm(dim=-1, keepdim=True)
    wavelength = subgrid_width * (
        lo + (hi - lo) * torch.rand(shape, generator=gen, device=device))
    phase = torch.rand(shape, generator=gen, device=device) * (2 * math.pi)
    return direction * (2 * math.pi / wavelength)[..., None], phase


def _waves(coords, k, phase):
    """``(5, X, Y, Z)``: each field's mean of its plane waves
    ``sin(k.x + phi)`` at the cell centres ``coords`` (three axes)."""
    x, y, z = coords
    out = torch.zeros(N_WAVE_FIELDS, x.shape[0], y.shape[0], z.shape[0],
                      device=x.device)
    for j in range(N_WAVE_FIELDS):
        for m in range(k.shape[1]):
            kx, ky, kz = k[j, m]
            out[j] += torch.sin(kx * x[:, None, None] + ky * y[None, :, None]
                                + kz * z[None, None, :] + phase[j, m])
    return out / k.shape[1]


def _centres(n: int, h: float, lo: float, device) -> torch.Tensor:
    return lo + (torch.arange(n, device=device, dtype=torch.float32)
                 + 0.5) * h


def _blast_pressure(h: float, energy: float, gamma: float) -> float:
    """The blast's pressure: ``energy`` spread over the cells of width
    ``h`` within ``BLAST_CELLS`` widths of the origin."""
    axis = torch.arange(-8, 8, dtype=torch.float64) + 0.5
    r = torch.sqrt(axis[:, None, None] ** 2 + axis[None, :, None] ** 2
                   + axis[None, None, :] ** 2)
    n_blast = int((r < BLAST_CELLS).sum())
    return (gamma - 1.0) * energy / (n_blast * h ** 3)


def _state(coords, h_blast: float, waves, cfg: dict, gamma: float,
           with_blast: bool):
    """Conserved ``(5, X, Y, Z)`` fp32 state at ``coords``: the ambient
    from ``waves``, and the blast's pressure within its radius."""
    amb = cfg["ambient"]
    p_blast = _blast_pressure(h_blast, cfg["blast_energy"], gamma)
    p_amb = amb["pressure_ratio"] * p_blast
    c_amb = math.sqrt(gamma * p_amb / cfg["rho0"])
    rho = cfg["rho0"] * (1.0 + amb["rho_amplitude"] * waves[0])
    p = p_amb * (1.0 + amb["p_amplitude"] * waves[1])
    v = amb["mach"] * c_amb * waves[2:]
    if with_blast:
        x, y, z = coords
        r = torch.sqrt(x[:, None, None] ** 2 + y[None, :, None] ** 2
                       + z[None, None, :] ** 2)
        p = torch.where(r < BLAST_CELLS * h_blast, p_blast, p)
    return prim_to_cons(rho, v[0], v[1], v[2], p, gamma)


def uniform_state(g: Uniform, cfg: dict, seed: int,
                  device: torch.device) -> torch.Tensor:
    """``(5, N, N, N)`` conserved fp32 state of the uniform grid."""
    k, phase = _modes(seed, cfg["ambient"], g.subgrid * g.h, device)
    axis = _centres(g.n, g.h, -0.5 * g.domain, device)
    coords = (axis,) * 3
    return _state(coords, g.h, _waves(coords, k, phase), cfg, g.gamma,
                  with_blast=True)


def two_level_state(g: TwoLevel, cfg: dict, seed: int,
                    device: torch.device):
    """``(uc, uf)``: the coarse level (ambient, synced from the fine) and
    the fine patch holding the blast."""
    k, phase = _modes(seed, cfg["ambient"], g.subgrid * g.h_coarse, device)
    lo_f = g.offset * g.h_coarse - 0.5 * g.domain
    fine = (_centres(g.n_fine, g.h_fine, lo_f, device),) * 3
    uf = _state(fine, g.h_fine, _waves(fine, k, phase), cfg, g.gamma,
                with_blast=True)
    coarse = (_centres(g.n_coarse, g.h_coarse, -0.5 * g.domain, device),) * 3
    uc = _state(coarse, g.h_fine, _waves(coarse, k, phase), cfg, g.gamma,
                with_blast=False)
    return sync_coarse(uc, uf, g), uf
