"""Padded sub-grid extraction: the per-task ``(G^3, F, P, P, P)`` view of an
assembled ``(F, M, M, M)`` level, ``P = S + 2*ghost``, with its plain
PyTorch version and the CUDA kernel for Hopper.

``boundary`` names where the ghost cells come from: ``"outflow"`` and
``"periodic"`` take the unpadded level and its ghosts by index (clamped,
wrapped), as ``F.pad``'s ``replicate`` and ``circular`` pad it;
``"padded"`` takes a level that carries its ghost band already (the AMR
fine level after the coarse-fine exchange).  ``ghost = 0`` gives the
sub-grids' interiors.

``extract_plain`` is the torch path (``F.pad``, then ``unfold`` /
``permute`` / ``reshape``), any device; ``extract_cuda`` launches
``csrc/extract.cu`` on the current stream, one pass that writes each slot
straight from the level, with no padded copy of it; ``extract`` takes the
kernel for a CUDA tensor and the plain version otherwise.  All three take
``out=``, a contiguous tensor of the result's shape and dtype that the
result is written into (the aggregation executor's static parent), and
the kernel is bit-equal to the plain version: it moves bits, it computes
nothing.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

# F.pad's mode for each boundary condition
PAD_MODES = {"outflow": "replicate", "periodic": "circular"}
BOUNDARIES = {"padded": 0, "outflow": 1, "periodic": 2}


def extract_shape(src: torch.Tensor, subgrid: int, ghost: int,
                  boundary: str):
    """``(G, (G^3, F, P, P, P))``: the sub-grids a side and the shape of
    ``src``'s extraction; raises for a boundary, a level or a ghost width
    the extraction does not take."""
    if boundary not in BOUNDARIES:
        raise ValueError(f"unknown boundary {boundary!r} — valid: "
                         f"{', '.join(BOUNDARIES)}")
    if src.dim() != 4 or len(set(src.shape[1:])) != 1:
        raise ValueError(f"expected a cubic (F, M, M, M) level, got "
                         f"{tuple(src.shape)}")
    if subgrid < 1 or ghost < 0:
        raise ValueError(f"need subgrid >= 1 and ghost >= 0, got "
                         f"{subgrid}, {ghost}")
    m = src.shape[-1]
    n = m - 2 * ghost if boundary == "padded" else m
    if n <= 0 or n % subgrid:
        raise ValueError(f"a level of {n} cells a side is no whole number "
                         f"of {subgrid}-cell sub-grids")
    if boundary == "periodic" and ghost > n:
        raise ValueError(f"a periodic ghost band of {ghost} cells wraps "
                         f"more than the level's {n}")
    p, grids = subgrid + 2 * ghost, n // subgrid
    return grids, (grids ** 3, src.shape[0], p, p, p)


def extract_plain(src: torch.Tensor, subgrid: int, ghost: int,
                  boundary: str,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The torch path, any device: ``F.pad`` (unless ``padded``), then one
    gather of the windows into the slots, contiguous (into ``out`` if
    given)."""
    grids, shape = extract_shape(src, subgrid, ghost, boundary)
    up = src if boundary == "padded" else F.pad(
        src, (ghost,) * 6, mode=PAD_MODES[boundary])
    p = shape[-1]
    blocks = up.unfold(1, p, subgrid).unfold(2, p, subgrid).unfold(
        3, p, subgrid)                                # (F, G, G, G, P, P, P)
    blocks = blocks.permute(1, 2, 3, 0, 4, 5, 6)
    if out is None:
        return blocks.reshape(shape)
    if (tuple(out.shape) != shape or out.dtype != src.dtype
            or not out.is_contiguous()):
        raise ValueError(f"extract: out= must be a contiguous {src.dtype} "
                         f"{shape} tensor, got {out.dtype} "
                         f"{tuple(out.shape)}")
    out.view(grids, grids, grids, *shape[1:]).copy_(blocks)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.extract_launch.argtypes = [vp, vp, ci, ci, ci, ci, ci, ci, ci,
                                   cl, cl, cl, cl, vp]
    lib.extract_launch.restype = ci
    lib.extract_error_string.argtypes = [ci]
    lib.extract_error_string.restype = ctypes.c_char_p


def build() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    return _build.load("extract", _declare)


def extract_cuda(src: torch.Tensor, subgrid: int, ghost: int, boundary: str,
                 out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the extraction kernel on the current stream, one block per
    slot, into ``out`` if given (a contiguous tensor of the result's shape
    and ``src``'s dtype; checked).  ``src`` may have any strides; its
    elements are 2, 4 or 8 bytes.  Counts each launch in
    ``extract_cuda.launches``."""
    _build.refuse_grad("extract", src)
    if src.device.type != "cuda":
        raise ValueError(f"extract_cuda needs a CUDA tensor, got one on "
                         f"{src.device}; extract_plain is the CPU path")
    if src.element_size() not in (2, 4, 8):
        raise TypeError(f"the extraction kernel moves elements of 2, 4 or "
                        f"8 bytes, got {src.dtype}")
    grids, shape = extract_shape(src, subgrid, ghost, boundary)
    out = _build.output(out, shape, src, "extract_cuda", dtype=src.dtype)
    if out.numel() == 0:
        return out
    lib = build()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream(src.device).cuda_stream
        err = lib.extract_launch(
            src.data_ptr(), out.data_ptr(), src.element_size(), grids,
            subgrid, ghost, shape[1], BOUNDARIES[boundary], src.shape[-1],
            *src.stride(), stream)
    _build.raise_on(err, lib.extract_error_string, "extraction kernel launch")
    extract_cuda.launches += 1
    return out


extract_cuda.launches = 0


def extract(src: torch.Tensor, subgrid: int, ghost: int, boundary: str,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version otherwise."""
    if src.device.type == "cuda":
        return extract_cuda(src, subgrid, ghost, boundary, out=out)
    return extract_plain(src, subgrid, ghost, boundary, out=out)
