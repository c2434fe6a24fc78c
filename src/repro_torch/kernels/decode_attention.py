"""Bucketed flash-decode GQA attention: its plain PyTorch version and the
CUDA kernel for Hopper.

The serving engine's aggregated launch: B decode requests (each one new
token against its own KV cache) in one kernel with a request axis, the
serving-level instance of the paper's strategy 3.  Positions at or beyond
a request's ``cache_len`` are masked, and the kernel never loads their
tiles, so aggregated requests of different lengths do not pay for the
longest one.

q: (B, Hq, D); k/v cache: (B, S, Hkv, D); cache_len: (B,) int32 -> (B, Hq,
D) in q's dtype, with fp32 scores, softmax and accumulation.  A request
with ``cache_len == 0`` gets 0 (the TPU kernel's result: nothing
accumulated over a denominator clamped to 1e-30).

``decode_attention_cuda`` launches ``csrc/decode_attention.cu`` (replacing
``src/repro/kernels/decode_attention.py:28``, ``_decode_kernel``) on the
current stream for CUDA tensors and raises for anything the kernel does not
take, with no fallback; ``decode_attention_plain`` is the same function in
PyTorch (``repro.kernels.ref.decode_attention_ref``'s counterpart, with the
``cache_len == 0`` rows defined as 0).

The kernel splits each request's cache into chunks of ``launch_plan(S,
D)`` positions, one block per (kv head, request, chunk), and a second
kernel merges the chunks in chunk order; the plan depends on the cache
capacity S and the head dimension D alone, never on B or on the lengths.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
MAX_GROUP = 16            # query heads per kv head the kernel holds
MAX_HEAD_DIM = 256
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 32                 # cache positions per staged tile (csrc kTile)
MAX_CHUNKS = 64           # chunks per (kv head, request) (csrc kMaxChunks)
CHUNK_ELEMS = 8_192       # a chunk's K row elements: 64 positions at D 128


def launch_plan(s: int, d: int) -> Tuple[int, int]:
    """(positions per chunk, number of chunks) for a cache of capacity
    ``s`` and head dimension ``d``: CHUNK_ELEMS / d positions rounded down
    to whole tiles, at least one tile, and enough that at most MAX_CHUNKS
    chunks cover ``s``.  A pure function of (S, D), so a request's chunks,
    and so its bits, are the same in any bucket."""
    chunk = max(TILE, CHUNK_ELEMS // d // TILE * TILE)
    least = -(-s // MAX_CHUNKS)                 # ceil(s / MAX_CHUNKS)
    chunk = max(chunk, -(-least // TILE) * TILE)
    return chunk, -(-s // chunk)


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           cache_len: torch.Tensor) -> torch.Tensor:
    """(B, Hq, D) x (B, S, Hkv, D) caches -> (B, Hq, D) in plain PyTorch,
    any device.  The einsums contract against the cache layout directly."""
    b, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).float()
    scale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * scale
    valid = (torch.arange(s, device=q.device)[None, :]
             < cache_len.to(q.device)[:, None])                  # (B, S)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full((), NEG_INF, device=q.device))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float()) / denom
    # nothing cached: 0, as the kernel (the masked softmax alone would
    # average every row of V)
    live = (cache_len.to(q.device) > 0)[:, None, None, None]
    out = torch.where(live, out, torch.zeros((), device=q.device))
    return out.reshape(b, hq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

def check_kernel_args(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, cache_len: torch.Tensor) -> int:
    """Raise for anything the kernel does not take (device aside); returns
    the group size G = Hq / Hkv."""
    if q.dtype not in DTYPES:
        raise TypeError(f"decode_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one dtype, got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"expected q (B, Hq, D) and caches (B, S, Hkv, D), "
                         f"got {tuple(q.shape)} and {tuple(k_cache.shape)}")
    b, hq, d = q.shape
    if (k_cache.shape[0] != b or k_cache.shape[3] != d
            or v_cache.shape != k_cache.shape):
        raise ValueError(f"caches {tuple(k_cache.shape)} and "
                         f"{tuple(v_cache.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    hkv = k_cache.shape[2]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if d % 8 or d > MAX_HEAD_DIM:
        raise NotImplementedError(
            f"the decode_attention kernel takes a head dimension that is a "
            f"multiple of 8 up to {MAX_HEAD_DIM}, got {d}")
    if hq // hkv > MAX_GROUP:
        raise NotImplementedError(
            f"the decode_attention kernel holds up to {MAX_GROUP} query heads "
            f"per kv head, got {hq // hkv}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous():
            raise ValueError(f"decode_attention kernel needs a contiguous "
                             f"{name}")
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention kernel needs {name} to "
                             f"start 16-byte aligned (its rows are copied "
                             f"16 bytes at a time)")
    if (not isinstance(cache_len, torch.Tensor)
            or cache_len.dtype != torch.int32 or cache_len.shape != (b,)
            or not cache_len.is_contiguous()
            or cache_len.device != q.device):
        raise ValueError(f"cache_len must be a contiguous int32 ({b},) "
                         f"tensor on {q.device}")
    return hq // hkv


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_init.argtypes = []
    lib.decode_attention_init.restype = ci
    lib.decode_attention_launch.argtypes = [
        vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ctypes.c_float,
        ci, vp]
    lib.decode_attention_launch.restype = ci
    lib.decode_attention_error_string.argtypes = [ci]
    lib.decode_attention_error_string.restype = ctypes.c_char_p


def build() -> ctypes.CDLL:
    """Build (first use) and load the kernel library."""
    return _build.load("decode_attention", _declare)


_READY_DEVICES: set = set()     # devices whose shared-memory limit is raised


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor,
                          cache_len: torch.Tensor) -> torch.Tensor:
    """Launch the chunk and combine kernels on the current stream: (B, Hq,
    D), (B, S, Hkv, D) x 2, (B,) -> (B, Hq, D), the chunk size from
    ``launch_plan(S, D)`` and the scratch of per-chunk partials allocated
    here.  Counts each launch in ``decode_attention_cuda.launches`` (an
    empty bucket or cache launches nothing)."""
    _build.refuse_grad("decode_attention", q, k_cache, v_cache)
    if q.device.type != "cuda":
        raise ValueError(
            f"decode_attention_cuda needs a CUDA tensor, got one on "
            f"{q.device}; decode_attention_plain is the CPU path")
    g = check_kernel_args(q, k_cache, v_cache, cache_len)
    lib = build()
    b, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q)
    if b == 0:
        return out
    if s == 0:                  # nothing can be cached: every row is 0
        return out.zero_()
    chunk, n_chunks = launch_plan(s, d)
    part_acc = torch.empty((b, hkv, n_chunks, g, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, hkv, n_chunks, g, 2), dtype=torch.float32,
                          device=q.device)
    with torch.cuda.device(q.device):
        if q.device.index not in _READY_DEVICES:
            _build.raise_on(lib.decode_attention_init(),
                            lib.decode_attention_error_string,
                            "decode_attention kernel set-up")
            _READY_DEVICES.add(q.device.index)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            cache_len.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
            part_ml.data_ptr(), b, s, hkv, g, d, chunk, 1.0 / math.sqrt(d),
            DTYPES[q.dtype], stream)
    _build.raise_on(err, lib.decode_attention_error_string,
                    "decode_attention kernel launch")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
