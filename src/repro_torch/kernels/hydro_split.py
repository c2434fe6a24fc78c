"""The paper's two-kernel hydro structure, Reconstruct then Flux, as CUDA
kernels for Hopper beside their plain PyTorch versions.

``hydro_reconstruct_cuda`` writes every PPM surface value of a bucket,
``(n, F, P, P, P) -> (n, 13, 2, F, P, P, P)``; ``hydro_flux_cuda`` reads
them back for the KNP flux and its divergence, ``-> (n, F, S, S, S)``.
Both launch ``csrc/hydro_split.cu`` on the current stream and raise for
anything the kernels do not take, with no fallback.  The composition
computes the function of the fused ``hydro_rhs`` kernel.  The plain
versions are the counterparts of ``repro.kernels.ref.hydro_reconstruct_ref``
and ``hydro_flux_ref``.
"""
from __future__ import annotations

import ctypes
import itertools
from functools import lru_cache
from typing import FrozenSet, Optional, Tuple

import torch

from repro_torch.hydro.euler import N_FIELDS
from repro_torch.hydro.flux import FACE_QUAD, flux_divergence
from repro_torch.hydro.ppm import DIR_PAIRS, N_PAIRS, ppm_reconstruct_all
from repro_torch.kernels import _build
from repro_torch.kernels._build import SMEM_PER_BLOCK
from repro_torch.kernels.hydro_rhs import (
    CTA_THREADS, KERNEL_GHOST, _quad_table,
)


def hydro_reconstruct_plain(u_slots: torch.Tensor) -> torch.Tensor:
    """(n, F, P, P, P) -> (n, 13, 2, F, P, P, P) in plain PyTorch, any
    device; shifts wrap mod P as ``torch.roll`` does."""
    return ppm_reconstruct_all(u_slots)


def hydro_flux_plain(recon: torch.Tensor, *, h: float, gamma: float,
                     ghost: int, subgrid: int) -> torch.Tensor:
    """(n, 13, 2, F, P, P, P) -> (n, F, S, S, S) in plain PyTorch."""
    return flux_divergence(recon, h, gamma, ghost, subgrid)


def flux_read_states(subgrid: int, ghost: int = KERNEL_GHOST
                     ) -> FrozenSet[Tuple[int, int, Tuple[int, int, int]]]:
    """The distinct (pair, side, cell) reconstructed values the Flux kernel
    reads: for each axis and ``FACE_QUAD`` entry, the left state at every
    consumed face cell and the right state one cell along the axis.  Times
    F fields and 4 bytes, it is the least the function must read."""
    states = set()
    for a in range(3):
        span = [range(ghost - 1, ghost + subgrid) if d == a
                else range(ghost, ghost + subgrid) for d in range(3)]
        for (_, pl, sl, pr, sr) in FACE_QUAD[a]:
            for c in itertools.product(*span):
                right = tuple(c[d] + (d == a) for d in range(3))
                states.add((pl, sl, c))
                states.add((pr, sr, right))
    return frozenset(states)


def flux_read_bytes(n: int, subgrid: int, ghost: int = KERNEL_GHOST) -> int:
    """Bytes of reconstruction the Flux function must read for n slots."""
    return n * len(flux_read_states(subgrid, ghost)) * N_FIELDS * 4


# the largest padded width P Reconstruct takes: one field of a CTA's x-slab
# (ceil(P / 7) planes, csrc/hydro_split.cu), widened by 2 cells on every
# side, fits an sm_90 block's shared memory up to P = 62
RECON_MAX_PADDED = 62


FLUX_STAGES = 2      # quadrature entries in Flux's ring, fixed in the .cu


def flux_smem_bytes(subgrid: int) -> int:
    """Flux's dynamic shared memory per CTA: each thread's ring of
    ``FLUX_STAGES`` quadrature entries (10 staged values each), then one
    axis' face fluxes."""
    return 4 * (FLUX_STAGES * 2 * N_FIELDS * CTA_THREADS
                + N_FIELDS * (subgrid + 1) * subgrid ** 2)


def _check_tensor(x: torch.Tensor, shape: Tuple[int, ...], what: str,
                  smem: int = 0) -> None:
    if smem > SMEM_PER_BLOCK:
        raise NotImplementedError(
            f"{what} kernel: {shape} needs {smem} B of shared memory per "
            f"block, above the {SMEM_PER_BLOCK} B an sm_90 block may use")
    if x.dtype != torch.float32:
        raise TypeError(f"{what} kernel takes float32, got {x.dtype}")
    if x.dim() != len(shape) + 1 or tuple(x.shape[1:]) != shape:
        raise ValueError(f"{what} kernel expected (n, "
                         f"{', '.join(map(str, shape))}), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what} kernel needs a contiguous input")


def check_reconstruct_args(u_slots: torch.Tensor) -> None:
    """Raise for anything the Reconstruct kernel does not take (device
    aside): (n, F, P, P, P) float32, contiguous, 3 <= P (the five-point
    stencil wraps once at most) and P <= ``RECON_MAX_PADDED``."""
    p = u_slots.shape[-1] if u_slots.dim() == 5 else 0
    if u_slots.dim() == 5 and p < 3:
        raise ValueError(f"reconstruct kernel needs P >= 3, got {p}")
    if p > RECON_MAX_PADDED:
        raise NotImplementedError(
            f"reconstruct kernel takes P <= {RECON_MAX_PADDED} (one field of "
            f"a slab, widened by 2 cells, in shared memory), got P={p}")
    _check_tensor(u_slots, (N_FIELDS, p, p, p), "reconstruct")


def check_flux_args(recon: torch.Tensor, ghost: int, subgrid: int) -> None:
    """Raise for anything the Flux kernel does not take (device aside)."""
    if ghost != KERNEL_GHOST:
        raise NotImplementedError(
            f"the flux kernel takes ghost={KERNEL_GHOST} only, got {ghost}")
    p = subgrid + 2 * ghost
    _check_tensor(recon, (N_PAIRS, 2, N_FIELDS, p, p, p), "flux",
                  flux_smem_bytes(subgrid))


@lru_cache(maxsize=None)
def _split_tables() -> Tuple[ctypes.Array, ctypes.Array]:
    """Each FACE_QUAD entry's pair indices (3 x 9 x 2 ints: left, right)
    and DIR_PAIRS (13 x 3 ints), beside ``_quad_table``'s weights and
    directions."""
    nq = len(FACE_QUAD[0])
    pairs = (ctypes.c_int * (3 * nq * 2))()
    for a in range(3):
        for q, (_, pl, _, pr, _) in enumerate(FACE_QUAD[a]):
            pairs[2 * (a * nq + q):2 * (a * nq + q) + 2] = [pl, pr]
    dirs = (ctypes.c_int * (3 * N_PAIRS))(*[c for d in DIR_PAIRS for c in d])
    return pairs, dirs


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    pi = ctypes.POINTER(ci)
    lib.hydro_split_init.argtypes = [ctypes.POINTER(cf), pi, pi, pi]
    lib.hydro_split_init.restype = ci
    lib.hydro_reconstruct_launch.argtypes = [vp, vp, ci, ci, vp]
    lib.hydro_reconstruct_launch.restype = ci
    lib.hydro_flux_launch.argtypes = [vp, vp, ci, ci, cf, cf, cf,
                                      ctypes.c_size_t, vp]
    lib.hydro_flux_launch.restype = ci
    lib.hydro_flux_occupancy.argtypes = [ctypes.c_size_t, pi, pi]
    lib.hydro_flux_occupancy.restype = ci
    lib.hydro_split_error_string.argtypes = [ci]
    lib.hydro_split_error_string.restype = ctypes.c_char_p


_READY_DEVICES: set = set()     # devices whose constant tables are uploaded


def build() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    return _build.load("hydro_split", _declare)


def _ready(lib: ctypes.CDLL, device: torch.device) -> None:
    if device.index not in _READY_DEVICES:
        err = lib.hydro_split_init(*_quad_table(), *_split_tables())
        _build.raise_on(err, lib.hydro_split_error_string,
                        "hydro_split set-up")
        _READY_DEVICES.add(device.index)


def _need_cuda(x: torch.Tensor, fn: str, plain: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{fn} needs a CUDA tensor, got one on {x.device}; "
                         f"{plain} is the CPU path")


def hydro_reconstruct_cuda(u_slots: torch.Tensor) -> torch.Tensor:
    """Launch Reconstruct on the current stream: (n, F, P, P, P) -> (n, 13,
    2, F, P, P, P).  Counts each launch in
    ``hydro_reconstruct_cuda.launches``."""
    _build.refuse_grad("hydro_reconstruct", u_slots)
    _need_cuda(u_slots, "hydro_reconstruct_cuda", "hydro_reconstruct_plain")
    check_reconstruct_args(u_slots)
    lib = build()
    n, p = u_slots.shape[0], u_slots.shape[-1]
    out = torch.empty((n, N_PAIRS, 2, N_FIELDS, p, p, p),
                      dtype=torch.float32, device=u_slots.device)
    if n == 0:
        return out
    with torch.cuda.device(u_slots.device):
        _ready(lib, u_slots.device)
        stream = torch.cuda.current_stream(u_slots.device).cuda_stream
        err = lib.hydro_reconstruct_launch(
            u_slots.data_ptr(), out.data_ptr(), n, p, stream)
    _build.raise_on(err, lib.hydro_split_error_string,
                    "hydro_split reconstruct launch")
    hydro_reconstruct_cuda.launches += 1
    return out


def hydro_flux_cuda(recon: torch.Tensor, *, h: float, gamma: float,
                    ghost: int, subgrid: int,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch Flux on the current stream: (n, 13, 2, F, P, P, P) -> (n, F,
    S, S, S) with a scalar width ``h``, one cluster of 3 CTAs per slot,
    into ``out`` if given (a contiguous float32 tensor of that shape;
    checked).  Counts each launch in ``hydro_flux_cuda.launches``."""
    _build.refuse_grad("hydro_flux", recon)
    _need_cuda(recon, "hydro_flux_cuda", "hydro_flux_plain")
    check_flux_args(recon, ghost, subgrid)
    n, s = recon.shape[0], subgrid
    out = _build.output(out, (n, N_FIELDS, s, s, s), recon,
                        "hydro_flux_cuda")
    lib = build()
    if n == 0:
        return out
    with torch.cuda.device(recon.device):
        _ready(lib, recon.device)
        stream = torch.cuda.current_stream(recon.device).cuda_stream
        err = lib.hydro_flux_launch(
            recon.data_ptr(), out.data_ptr(), n, s, float(h), gamma,
            gamma - 1.0, flux_smem_bytes(s), stream)
    _build.raise_on(err, lib.hydro_split_error_string,
                    "hydro_split flux launch")
    hydro_flux_cuda.launches += 1
    return out


def flux_occupancy(device: torch.device, subgrid: int) -> Tuple[int, int]:
    """(resident CTAs per SM, clusters resident on the card) for the Flux
    kernel at ``subgrid``."""
    lib = build()
    per_sm, clusters = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        _ready(lib, device)
        _build.raise_on(lib.hydro_flux_occupancy(
            flux_smem_bytes(subgrid), ctypes.byref(per_sm),
            ctypes.byref(clusters)),
            lib.hydro_split_error_string, "hydro_flux occupancy query")
    return per_sm.value, clusters.value


hydro_reconstruct_cuda.launches = 0
hydro_flux_cuda.launches = 0
