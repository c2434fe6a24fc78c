"""Per-sub-grid gravity solve (the gravity kernel family): its plain PyTorch
version and the CUDA kernel for Hopper.

Octo-Tiger aggregates two kernel families through one runtime: the hydro
solver and the gravity (FMM) solver.  Here the gravity family is a compact
per-sub-grid Poisson solve: ``n_iter`` Jacobi sweeps of ``laplace(phi) =
4 pi G rho`` on one padded sub-grid, zero on its one-cell frame, then the
central-difference field ``g = -grad(phi)``.  Like the hydro RHS it is one
fine-grained task body that every strategy re-granularizes; the cell width
is a per-task argument ``h_slots`` (n,).

``gravity_cuda`` launches ``csrc/gravity.cu`` on the current stream for a
CUDA tensor and raises for anything the kernel does not take, with no
fallback; ``gravity_plain`` is the same function in PyTorch, the
counterpart of ``repro.kernels.gravity.gravity_batched_body``.
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from typing import Optional

import torch

from repro_torch.hydro.euler import N_FIELDS
from repro_torch.hydro.flux import as_width
from repro_torch.kernels import _build

GRAVITY_FIELDS = 4                # phi, gx, gy, gz


@lru_cache(maxsize=None)
def _interior_mask(p: int) -> torch.Tensor:
    """(p, p, p) bool on the CPU: True off the one-cell frame."""
    inner = torch.zeros(p, dtype=torch.bool)
    inner[1:p - 1] = True
    return inner[:, None, None] & inner[None, :, None] & inner[None, None, :]


def _roll(x: torch.Tensor, shift: int, dim: int) -> torch.Tensor:
    return torch.roll(x, shifts=shift, dims=dim)


def gravity_block(rho: torch.Tensor, h, *, ghost: int, subgrid: int,
                  g_const: float, n_iter: int) -> torch.Tensor:
    """Density ([n,] P, P, P) and width (float, 0-dim or (n,)) -> ([n,] 4,
    S, S, S): [phi, gx, gy, gz] over the interior, in the reference's
    arithmetic order (``_gravity_block``)."""
    p = rho.shape[-1]
    mask = _interior_mask(p).to(rho.device)
    h = as_width(h, rho)
    rhs = (4.0 * math.pi * g_const) * rho * (h * h)
    # a device tensor, not a Python scalar: CUDA's torch.div by a host
    # scalar multiplies by its reciprocal, the reference divides
    six = torch.full((), 6.0, dtype=rho.dtype, device=rho.device)
    phi = torch.zeros_like(rho)
    for _ in range(n_iter):
        nb = (_roll(phi, 1, -3) + _roll(phi, -1, -3)
              + _roll(phi, 1, -2) + _roll(phi, -1, -2)
              + _roll(phi, 1, -1) + _roll(phi, -1, -1))
        phi = torch.where(mask, (nb - rhs) / six, 0.0)
    inv2h = 0.5 / h
    gx = (_roll(phi, 1, -3) - _roll(phi, -1, -3)) * inv2h
    gy = (_roll(phi, 1, -2) - _roll(phi, -1, -2)) * inv2h
    gz = (_roll(phi, 1, -1) - _roll(phi, -1, -1)) * inv2h
    g, s = ghost, subgrid
    sl = (Ellipsis,) + (slice(g, g + s),) * 3
    return torch.stack([phi[sl], gx[sl], gy[sl], gz[sl]], dim=-4)


def subgrid_gravity(u_padded: torch.Tensor, h, *, ghost: int, subgrid: int,
                    g_const: float = 1.0, n_iter: int = 8) -> torch.Tensor:
    """Gravity tasks: ([n,] F, P, P, P) conserved sub-grids -> ([n,] 4, S,
    S, S).  Only density feeds the solve; the body takes the whole padded
    sub-grid so hydro and gravity tasks read the SAME parent tensor."""
    return gravity_block(u_padded[..., 0, :, :, :], h, ghost=ghost,
                         subgrid=subgrid, g_const=g_const, n_iter=n_iter)


def gravity_plain(u_slots: torch.Tensor, h_slots: torch.Tensor, *,
                  ghost: int, subgrid: int, g_const: float = 1.0,
                  n_iter: int = 8) -> torch.Tensor:
    """(n, F, P, P, P), (n,) -> (n, 4, S, S, S) in plain PyTorch, any
    device."""
    return subgrid_gravity(u_slots, h_slots, ghost=ghost, subgrid=subgrid,
                           g_const=g_const, n_iter=n_iter)


@lru_cache(maxsize=None)
def gravity_batched_body(ghost: int, subgrid: int, g_const: float = 1.0,
                         n_iter: int = 8):
    """The plain aggregation-region body ``(k, F, P, P, P), (k,) -> (k, 4,
    S, S, S)``, cached so every caller with the same parameters gets the
    same callable."""
    def body(u_slots, h_slots):
        return gravity_plain(u_slots, h_slots, ghost=ghost, subgrid=subgrid,
                             g_const=g_const, n_iter=n_iter)
    return body


def gravity_source_update(u: torch.Tensor, dudt: torch.Tensor,
                          pg: torch.Tensor, scale=None) -> torch.Tensor:
    """Add the gravity source to a hydro update: momentum gains ``rho * g``
    and energy gains ``S . g``.  Pointwise over (F, ...) fields, so it
    serves global grids and per-slot interiors alike.  ``scale=None`` adds
    the raw source; a scalar scales every term (the epilogue-fused stage's
    ``c1 * dt``).  Returns a new tensor."""
    rho = u[0]
    gx, gy, gz = pg[1], pg[2], pg[3]
    terms = (rho * gx, rho * gy, rho * gz,
             u[1] * gx + u[2] * gy + u[3] * gz)
    if scale is not None:
        terms = tuple(scale * t for t in terms)
    return torch.stack([dudt[0]] + [dudt[1 + i] + t
                                    for i, t in enumerate(terms)])


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

# the largest padded width P the kernel takes: csrc/gravity.cu's 1,024
# threads of at most 16 cells each hold the (P - 2)^3 cells off the frame
# (two phi arrays of P^3 floats then fit shared memory too)
KERNEL_MAX_PADDED = 27


def check_kernel_args(u_slots: torch.Tensor, h_slots: torch.Tensor,
                      ghost: int, subgrid: int, n_iter: int) -> None:
    """Raise for anything the kernel does not take (device aside)."""
    if ghost < 1:
        raise NotImplementedError(
            f"the gravity kernel needs ghost >= 1 (the zero frame and the "
            f"gradient's stencil), got {ghost}")
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    p = subgrid + 2 * ghost
    if p > KERNEL_MAX_PADDED:
        raise NotImplementedError(
            f"the gravity kernel takes P <= {KERNEL_MAX_PADDED} (1,024 "
            f"threads hold the (P - 2)^3 cells in registers, 16 each at "
            f"most, and two P^3 phi arrays fit shared memory), got P={p}")
    if u_slots.dtype != torch.float32:
        raise TypeError(f"gravity kernel takes float32, got {u_slots.dtype}")
    if u_slots.dim() != 5 or tuple(u_slots.shape[1:]) != (N_FIELDS, p, p, p):
        raise ValueError(f"expected (n, {N_FIELDS}, {p}, {p}, {p}), got "
                         f"{tuple(u_slots.shape)}")
    if not u_slots.is_contiguous():
        raise ValueError("gravity kernel needs a contiguous input")
    if (not isinstance(h_slots, torch.Tensor)
            or h_slots.dtype != torch.float32 or h_slots.dim() != 1
            or h_slots.shape[0] != u_slots.shape[0]
            or not h_slots.is_contiguous()
            or h_slots.device != u_slots.device):
        raise ValueError(
            f"h_slots must be a contiguous float32 ({u_slots.shape[0]},) "
            f"tensor on {u_slots.device}")


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gravity_init.argtypes = []
    lib.gravity_init.restype = ci
    lib.gravity_launch.argtypes = [
        vp, vp, vp, ci, ci, ci, cf, ci, vp]
    lib.gravity_launch.restype = ci
    lib.gravity_error_string.argtypes = [ci]
    lib.gravity_error_string.restype = ctypes.c_char_p


_READY_DEVICES: set = set()     # devices whose shared-memory limit is raised


def build() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    return _build.load("gravity", _declare)


def gravity_cuda(u_slots: torch.Tensor, h_slots: torch.Tensor, *,
                 ghost: int, subgrid: int, g_const: float = 1.0,
                 n_iter: int = 8,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the gravity kernel on the current stream, one block per slot:
    (n, F, P, P, P), (n,) -> (n, 4, S, S, S), into ``out`` if given (a
    contiguous float32 tensor of that shape; checked).  Counts each launch
    in ``gravity_cuda.launches``."""
    _build.refuse_grad("gravity", u_slots, h_slots)
    if u_slots.device.type != "cuda":
        raise ValueError(
            f"gravity_cuda needs a CUDA tensor, got one on {u_slots.device};"
            f" gravity_plain is the CPU path")
    check_kernel_args(u_slots, h_slots, ghost, subgrid, n_iter)
    n, s = u_slots.shape[0], subgrid
    out = _build.output(out, (n, GRAVITY_FIELDS, s, s, s), u_slots,
                        "gravity_cuda")
    lib = build()
    if n == 0:
        return out
    with torch.cuda.device(u_slots.device):
        if u_slots.device.index not in _READY_DEVICES:
            _build.raise_on(lib.gravity_init(), lib.gravity_error_string,
                            "gravity kernel set-up")
            _READY_DEVICES.add(u_slots.device.index)
        stream = torch.cuda.current_stream(u_slots.device).cuda_stream
        # 4 pi g_const in double, rounded once to fp32 (as the reference's
        # weak-typed Python float is)
        err = lib.gravity_launch(
            u_slots.data_ptr(), h_slots.data_ptr(), out.data_ptr(), n, s,
            ghost, 4.0 * math.pi * g_const, n_iter, stream)
    _build.raise_on(err, lib.gravity_error_string, "gravity kernel launch")
    gravity_cuda.launches += 1
    return out


gravity_cuda.launches = 0
