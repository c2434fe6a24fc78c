"""Shared building blocks of the served models: initialisation, RMSNorm,
RoPE, the attention projections and the gated MLP, as plain functions on
tensors (``repro.models.common``'s counterparts, decode path only).

Weights keep the reference's ``x @ W`` orientation, ``W`` of shape
``(d_in, d_out)``, so a JAX parameter carries across without a transpose.
Every helper works in the activation's dtype (fp32 in the CPU tests, bf16
on the card) and upcasts to fp32 exactly where the reference does.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# Init: normal draws from an explicit generator, in fp32, cast once
# ---------------------------------------------------------------------------

def normal_init(gen: torch.Generator, shape: Sequence[int], scale: float,
                dtype: torch.dtype) -> torch.Tensor:
    """N(0, 1) * scale of ``shape`` on the generator's device, drawn in
    fp32 and cast to ``dtype``."""
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * scale).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype, scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal_init(gen, (d_in, d_out), scale, dtype)


def stacked_init(gen: torch.Generator, n: int, d_in: int, d_out: int,
                 dtype: torch.dtype, scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal_init(gen, (n, d_in, d_out), scale, dtype)


def frozen(t: torch.Tensor) -> nn.Parameter:
    """A weight of a served model (no gradient: the port serves, it does
    not train)."""
    return nn.Parameter(t, requires_grad=False)


class Init:
    """How a model's weights come to be: drawn from ``gen`` (on the
    generator's device, in fp32 and cast one tensor at a time, so a layer
    of bf16 experts never exists in fp32 at once), or, with ``gen=None``,
    allocated uninitialised on ``device`` for ``convert`` to fill."""

    def __init__(self, gen: Optional[torch.Generator],
                 device: torch.device):
        self.gen = gen
        self.device = device if gen is None else gen.device

    def __call__(self, fn, *args):
        """``fn(gen, *dims, dtype)``: ``dense_init`` or ``stacked_init``."""
        if self.gen is not None:
            return fn(self.gen, *args)
        *dims, dtype = args
        return torch.empty(tuple(dims), dtype=dtype, device=self.device)

    def ones(self, shape, dtype: torch.dtype) -> torch.Tensor:
        return torch.ones(shape, dtype=dtype, device=self.device)

    def zeros(self, shape, dtype: torch.dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)


class Attention(nn.Module):
    """Self-attention weights (``attn_init``): ``wq (d, Hq hd)``, ``wk, wv
    (d, Hkv hd)``, ``wo (Hq hd, d)``, and the QKV biases where the config
    has them."""

    def __init__(self, cfg, init: Init, dtype: torch.dtype):
        super().__init__()
        d, hd = cfg.d_model, cfg.resolved_head_dim
        nq, nkv = cfg.n_heads, cfg.n_kv_heads
        self.wq = frozen(init(dense_init, d, nq * hd, dtype))
        self.wk = frozen(init(dense_init, d, nkv * hd, dtype))
        self.wv = frozen(init(dense_init, d, nkv * hd, dtype))
        self.wo = frozen(init(dense_init, nq * hd, d, dtype))
        if cfg.qkv_bias:
            self.bq = frozen(init.zeros((nq * hd,), dtype))
            self.bk = frozen(init.zeros((nkv * hd,), dtype))
            self.bv = frozen(init.zeros((nkv * hd,), dtype))


class SwiGLU(nn.Module):
    """The gated MLP's weights (``mlp_init``): ``w_gate, w_up (d, ff)``,
    ``w_down (ff, d)``."""

    def __init__(self, init: Init, d_model: int, d_ff: int,
                 dtype: torch.dtype):
        super().__init__()
        self.w_gate = frozen(init(dense_init, d_model, d_ff, dtype))
        self.w_up = frozen(init(dense_init, d_model, d_ff, dtype))
        self.w_down = frozen(init(dense_init, d_ff, d_model, dtype))


# ---------------------------------------------------------------------------
# Norm, RoPE
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


@lru_cache(maxsize=None)
def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    """(head_dim/2,) fp32 inverse frequencies, computed once per (head_dim,
    theta, device): every layer of every decode step reuses them, and a
    fresh host-to-device copy of theta per call would stall the host on
    the card each time."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    freqs = 1.0 / (torch.tensor(theta, dtype=torch.float32) ** exps)
    return freqs.to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, n_heads, head_dim); positions: (..., S) int.  Rotates
    the two halves of the head dimension (not interleaved pairs)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                      # (hd/2,)
    angles = positions[..., None].float() * freqs               # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]                       # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention projections, MLP
# ---------------------------------------------------------------------------

def qkv_proj(p, x: torch.Tensor, cfg):
    """x (B, S, d) -> q (B, S, Hq, hd), k, v (B, S, Hkv, hd); ``p`` holds
    ``wq, wk, wv`` and, with ``cfg.qkv_bias``, ``bq, bk, bv``."""
    hd = cfg.resolved_head_dim
    b, s, _ = x.shape
    q = x @ p.wq
    k = x @ p.wk
    v = x @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    return (q.reshape(b, s, cfg.n_heads, hd),
            k.reshape(b, s, cfg.n_kv_heads, hd),
            v.reshape(b, s, cfg.n_kv_heads, hd))


def out_proj(p, o: torch.Tensor) -> torch.Tensor:
    b, s, h, hd = o.shape
    return o.reshape(b, s, h * hd) @ p.wo


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    """The gated (SwiGLU) MLP; ``p`` holds ``w_gate, w_up, w_down``."""
    return swiglu(x, p.w_gate, p.w_up, p.w_down)
