"""Aggregated hydro RHS (Reconstruct + Flux + divergence, fused) as a CUDA
kernel for Hopper, beside its plain PyTorch version.

``hydro_rhs_cuda`` launches ``csrc/hydro_rhs.cu`` on the current stream for
a CUDA tensor ``(n, F, P, P, P)`` and returns ``(n, F, S, S, S)``; it
raises for anything the kernel does not take and never falls back.  The
cell width is a float ``h`` (uniform grid) or one width per slot,
``h_slots`` (n,): one kernel serves both of the reference's slot_grid
Pallas kernels.  ``hydro_rhs_plain`` is the same function in PyTorch, the
counterpart of ``repro.kernels.ref.hydro_rhs_ref``.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Tuple

import torch

from repro_torch.hydro.euler import N_FIELDS
from repro_torch.hydro.flux import FACE_QUAD
from repro_torch.hydro.ppm import DIR_PAIRS
from repro_torch.hydro.stepper import subgrid_rhs
from repro_torch.kernels import _build
from repro_torch.kernels._build import SMEM_PER_BLOCK

KERNEL_GHOST = 3                  # the kernel's index bounds assume g = 3


def hydro_rhs_plain(u_slots: torch.Tensor, *, h: Optional[float] = None,
                    h_slots: Optional[torch.Tensor] = None, gamma: float,
                    ghost: int, subgrid: int) -> torch.Tensor:
    """(n, F, P, P, P) -> (n, F, S, S, S) in plain PyTorch, any device."""
    if (h is None) == (h_slots is None):
        raise ValueError("pass exactly one of h / h_slots")
    return subgrid_rhs(u_slots, h if h_slots is None else h_slots, gamma,
                       ghost, subgrid)


def smem_bytes(subgrid: int, ghost: int = KERNEL_GHOST) -> int:
    """Dynamic shared memory of one block: the padded slot, then one axis'
    face fluxes (the layout ``csrc/hydro_rhs.cu`` reads)."""
    p = subgrid + 2 * ghost
    return 4 * N_FIELDS * (p ** 3 + (subgrid + 1) * subgrid ** 2)


def check_kernel_args(u_slots: torch.Tensor, h: Optional[float],
                      h_slots: Optional[torch.Tensor], ghost: int,
                      subgrid: int) -> None:
    """Raise for anything the kernel does not take (device aside)."""
    if (h is None) == (h_slots is None):
        raise ValueError("pass exactly one of h / h_slots")
    if ghost != KERNEL_GHOST:
        raise NotImplementedError(
            f"the hydro_rhs kernel takes ghost={KERNEL_GHOST} only, got "
            f"{ghost} (see ROADMAP.md)")
    need = smem_bytes(subgrid, ghost)
    if need > SMEM_PER_BLOCK:
        raise NotImplementedError(
            f"subgrid={subgrid} needs {need} B of shared memory per block, "
            f"above the {SMEM_PER_BLOCK} B an sm_90 block may use; larger "
            f"sub-grids need a tiled kernel (see ROADMAP.md)")
    p = subgrid + 2 * ghost
    if u_slots.dtype != torch.float32:
        raise TypeError(f"hydro_rhs kernel takes float32, got "
                        f"{u_slots.dtype}")
    if u_slots.dim() != 5 or tuple(u_slots.shape[1:]) != (N_FIELDS, p, p, p):
        raise ValueError(f"expected (n, {N_FIELDS}, {p}, {p}, {p}), got "
                         f"{tuple(u_slots.shape)}")
    if not u_slots.is_contiguous():
        raise ValueError("hydro_rhs kernel needs a contiguous input")
    if h_slots is not None:
        if (h_slots.dtype != torch.float32 or h_slots.dim() != 1
                or h_slots.shape[0] != u_slots.shape[0]
                or not h_slots.is_contiguous()
                or h_slots.device != u_slots.device):
            raise ValueError(
                f"h_slots must be a contiguous float32 ({u_slots.shape[0]},) "
                f"tensor on {u_slots.device}")


@lru_cache(maxsize=None)
def _quad_table() -> Tuple[ctypes.Array, ctypes.Array]:
    """FACE_QUAD as the kernel keeps it: 3 x 9 weights, and 3 x 9 x 8 ints,
    each entry (left pair's direction x, y, z, its side, right pair's
    direction x, y, z, its side)."""
    n = 3 * len(FACE_QUAD[0])
    weights = (ctypes.c_float * n)()
    table = (ctypes.c_int * (8 * n))()
    for a in range(3):
        for q, (w, pl, sl, pr, sr) in enumerate(FACE_QUAD[a]):
            k = a * len(FACE_QUAD[a]) + q
            weights[k] = w
            table[8 * k:8 * k + 8] = [*DIR_PAIRS[pl], sl, *DIR_PAIRS[pr], sr]
    return weights, table


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hydro_rhs_init.argtypes = [ctypes.POINTER(cf), ctypes.POINTER(ci)]
    lib.hydro_rhs_init.restype = ci
    lib.hydro_rhs_launch.argtypes = [
        vp, vp, vp, ci, ci, cf, cf, cf, ctypes.c_size_t, vp]
    lib.hydro_rhs_launch.restype = ci
    lib.hydro_rhs_error_string.argtypes = [ci]
    lib.hydro_rhs_error_string.restype = ctypes.c_char_p


_READY_DEVICES: set = set()     # devices whose constant table is uploaded


def build() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    return _build.load("hydro_rhs", _declare)


def hydro_rhs_cuda(u_slots: torch.Tensor, *, h: Optional[float] = None,
                   h_slots: Optional[torch.Tensor] = None, gamma: float,
                   ghost: int, subgrid: int) -> torch.Tensor:
    """Launch the fused kernel on the current stream: (n, F, P, P, P) ->
    (n, F, S, S, S).  Counts each launch in ``hydro_rhs_cuda.launches``."""
    if u_slots.device.type != "cuda":
        raise ValueError(
            f"hydro_rhs_cuda needs a CUDA tensor, got one on "
            f"{u_slots.device}; hydro_rhs_plain is the CPU path")
    check_kernel_args(u_slots, h, h_slots, ghost, subgrid)
    lib = build()
    n, s = u_slots.shape[0], subgrid
    out = torch.empty((n, N_FIELDS, s, s, s), dtype=torch.float32,
                      device=u_slots.device)
    if n == 0:
        return out
    with torch.cuda.device(u_slots.device):
        if u_slots.device.index not in _READY_DEVICES:
            _build.raise_on(lib.hydro_rhs_init(*_quad_table()),
                            lib.hydro_rhs_error_string,
                            "hydro_rhs kernel set-up")
            _READY_DEVICES.add(u_slots.device.index)
        stream = torch.cuda.current_stream(u_slots.device).cuda_stream
        err = lib.hydro_rhs_launch(
            u_slots.data_ptr(),
            None if h_slots is None else h_slots.data_ptr(),
            out.data_ptr(), n, s, 0.0 if h is None else float(h), gamma,
            gamma - 1.0, smem_bytes(s, ghost), stream)
    _build.raise_on(err, lib.hydro_rhs_error_string, "hydro_rhs kernel launch")
    hydro_rhs_cuda.launches += 1
    return out


hydro_rhs_cuda.launches = 0
