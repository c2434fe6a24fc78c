"""Grouped (expert-aggregated) GEMM: its plain PyTorch version and the CUDA
kernel for Hopper.

The paper's strategy 3 inside a MoE layer: each expert's GEMM over its
routed tokens is a fine-grained task; one launch covers all E of them over
the static capacity layout, the expert id playing the part of the slot
index the paper adds to its aggregated kernels.

x (E, C, K) @ w (E, K, N) -> (E, C, N) in x's dtype with fp32
accumulation; rows at or beyond ``group_len[e]`` are exactly 0.

``grouped_gemm_cuda`` launches ``csrc/grouped_gemm.cu`` (replacing
``src/repro/kernels/grouped_gemm.py:30``, ``_gg_kernel``) on the current
stream for CUDA tensors and raises for anything the kernel does not take,
with no fallback; ``grouped_gemm_plain`` is the same function in PyTorch
(``repro.kernels.ref.grouped_gemm_ref``'s counterpart).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
COLS_PER_LOAD = 8          # N must be a multiple of it
MAX_EXPERTS = 65_535       # the grid's y extent


def grouped_gemm_plain(x: torch.Tensor, w: torch.Tensor,
                       group_len: torch.Tensor) -> torch.Tensor:
    """x (E, C, K) @ w (E, K, N) -> (E, C, N) in plain PyTorch, any
    device."""
    y = torch.einsum("eck,ekn->ecn", x.float(), w.float())
    c = x.shape[1]
    mask = (torch.arange(c, device=x.device)[None, :]
            < group_len.to(x.device)[:, None])
    return torch.where(mask[..., None], y,
                       torch.zeros((), device=x.device)).to(x.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

def check_kernel_args(x: torch.Tensor, w: torch.Tensor,
                      group_len: torch.Tensor) -> None:
    """Raise for anything the kernel does not take (device aside)."""
    if x.dtype not in DTYPES:
        raise TypeError(f"grouped_gemm kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if w.dtype != x.dtype:
        raise TypeError(f"x and w must share one dtype, got {x.dtype} and "
                        f"{w.dtype}")
    if (x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0]
            or w.shape[1] != x.shape[2]):
        raise ValueError(f"expected x (E, C, K) and w (E, K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    e, n = x.shape[0], w.shape[2]
    if n % COLS_PER_LOAD:
        raise NotImplementedError(
            f"the grouped_gemm kernel takes N a multiple of {COLS_PER_LOAD}, "
            f"got {n}")
    if e > MAX_EXPERTS:
        raise NotImplementedError(f"the grouped_gemm kernel takes up to "
                                  f"{MAX_EXPERTS} experts, got {e}")
    if not x.is_contiguous() or not w.is_contiguous():
        raise ValueError("grouped_gemm kernel needs contiguous x and w")
    if (not isinstance(group_len, torch.Tensor)
            or group_len.dtype != torch.int32 or group_len.shape != (e,)
            or not group_len.is_contiguous()
            or group_len.device != x.device or w.device != x.device):
        raise ValueError(f"group_len must be a contiguous int32 ({e},) "
                         f"tensor on {x.device}, beside w")


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.grouped_gemm_launch.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                        vp]
    lib.grouped_gemm_launch.restype = ci
    lib.grouped_gemm_error_string.argtypes = [ci]
    lib.grouped_gemm_error_string.restype = ctypes.c_char_p


def build() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    return _build.load("grouped_gemm", _declare)


def grouped_gemm_cuda(x: torch.Tensor, w: torch.Tensor,
                      group_len: torch.Tensor) -> torch.Tensor:
    """Launch the grouped-GEMM kernel on the current stream: (E, C, K),
    (E, K, N), (E,) -> (E, C, N).  Counts each launch in
    ``grouped_gemm_cuda.launches``."""
    _build.refuse_grad("grouped_gemm", x, w)
    if x.device.type != "cuda":
        raise ValueError(
            f"grouped_gemm_cuda needs a CUDA tensor, got one on {x.device}; "
            f"grouped_gemm_plain is the CPU path")
    check_kernel_args(x, w, group_len)
    lib = build()
    e, c, k = x.shape
    n = w.shape[2]
    out = torch.empty((e, c, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.grouped_gemm_launch(
            x.data_ptr(), w.data_ptr(), group_len.data_ptr(), out.data_ptr(),
            e, c, k, n, DTYPES[x.dtype], stream)
    _build.raise_on(err, lib.grouped_gemm_error_string,
                    "grouped_gemm kernel launch")
    grouped_gemm_cuda.launches += 1
    return out


grouped_gemm_cuda.launches = 0
