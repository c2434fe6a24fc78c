"""Shared building blocks of the models: initialisation, RMSNorm and
LayerNorm, RoPE, the attention projections, the full-sequence attention
(training, and the audio encoder), the gated and plain MLPs, and the
cross-entropy, as plain functions on tensors (``repro.models.common``'s
counterparts).

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
from torch.utils.checkpoint import checkpoint


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
    """A model weight, created without a gradient: serving never needs
    one; training turns gradients on for its own model
    (``model.requires_grad_(True)``)."""
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
    """Attention weights (``attn_init``): ``wq (d, Hq hd)``, ``wk, wv (d,
    Hkv hd)``, ``wo (Hq hd, d)``, the QKV biases where the config has them,
    and, for a cross-attention layer, the 0-d ``gate`` (llama-vision's
    tanh gate, 0 at init)."""

    def __init__(self, cfg, init: Init, dtype: torch.dtype,
                 cross: bool = False):
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
        if cross:
            self.gate = frozen(init.zeros((), dtype))


class SwiGLU(nn.Module):
    """The gated MLP's weights (``mlp_init``): ``w_gate, w_up (d, ff)``,
    ``w_down (ff, d)``."""

    def __init__(self, init: Init, d_model: int, d_ff: int,
                 dtype: torch.dtype):
        super().__init__()
        self.w_gate = frozen(init(dense_init, d_model, d_ff, dtype))
        self.w_up = frozen(init(dense_init, d_model, d_ff, dtype))
        self.w_down = frozen(init(dense_init, d_ff, d_model, dtype))


class GeluMLP(nn.Module):
    """The plain MLP's weights (``mlp_init`` with ``gated=False``): ``w_up
    (d, ff)``, ``b_up (ff,)``, ``w_down (ff, d)``, ``b_down (d,)``."""

    def __init__(self, init: Init, d_model: int, d_ff: int,
                 dtype: torch.dtype):
        super().__init__()
        self.w_up = frozen(init(dense_init, d_model, d_ff, dtype))
        self.b_up = frozen(init.zeros((d_ff,), dtype))
        self.w_down = frozen(init(dense_init, d_ff, d_model, dtype))
        self.b_down = frozen(init.zeros((d_model,), dtype))


class LayerNorm(nn.Module):
    """LayerNorm weights ``w`` (ones) and ``b`` (zeros), the reference's
    ``{"w", "b"}`` norm of a non-gated (GPT-style) stack."""

    def __init__(self, init: Init, d_model: int, dtype: torch.dtype):
        super().__init__()
        self.w = frozen(init.ones((d_model,), dtype))
        self.b = frozen(init.zeros((d_model,), dtype))


# ---------------------------------------------------------------------------
# Norms, RoPE
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5):
    """The reference's formula in fp32 (mean, then the mean of squared
    deviations, then rsqrt), not ``F.layer_norm``, whose reduction order
    differs."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(dt)


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
# Full-sequence attention (training and the audio encoder; plain PyTorch,
# as the reference's is plain jnp)
# ---------------------------------------------------------------------------

DEFAULT_Q_CHUNK = 512      # the reference's query-chunk length
NEG_INF = -1e30            # the reference's mask value


def _attend_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: Optional[torch.Tensor], scale: float) -> torch.Tensor:
    """q (B, Hq, Qc, hd), k, v (B, Hkv, S, hd), mask (1, 1, Qc, S) or None:
    the kv heads repeated to the query heads, fp32 scores, the masked
    softmax and P.V, in v's dtype."""
    g = q.shape[1] // k.shape[1]
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=1)
        v = torch.repeat_interleave(v, g, dim=1)
    scores = torch.einsum("bhqd,bhsd->bhqs", q.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask, scores,
                             torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqs,bhsd->bhqd", probs, v.float())
    return out.to(v.dtype)


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward instead of
    saved (``jax.checkpoint`` with ``nothing_saveable``) when autograd
    records; a plain call otherwise."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, q_positions: torch.Tensor,
              kv_positions: torch.Tensor, sliding_window: int = 0,
              q_chunk: int = DEFAULT_Q_CHUNK) -> torch.Tensor:
    """q (B, Sq, Hq, hd), k, v (B, Skv, Hkv, hd) -> (B, Sq, Hq, hd), masked
    by the absolute positions (causal and/or a sliding window).  A query
    length that is a multiple of ``q_chunk`` above it runs chunk by chunk,
    as the reference's scan does.  Under autograd the whole attention and
    each query chunk are rematerialised, as the reference's are (its
    default ``save_residuals=False``): no chunk's fp32 scores or
    probabilities are kept for the backward."""
    sq, hd = q.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(hd)

    def mask_for(qpos):
        m = None
        if causal:
            m = qpos[:, None] >= kv_positions[None, :]
        if sliding_window:
            w = qpos[:, None] - kv_positions[None, :] < sliding_window
            m = w if m is None else (m & w)
        return None if m is None else m[None, None]

    def chunk(qi, kt, vt, qpos):
        return _attend_chunk(qi, kt, vt, mask_for(qpos), scale)

    def whole(q, k, v):
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        if sq <= q_chunk or sq % q_chunk != 0:
            out = chunk(qt, kt, vt, q_positions)
        else:
            out = torch.cat([
                remat(chunk, qt[:, :, i:i + q_chunk], kt, vt,
                      q_positions[i:i + q_chunk])
                for i in range(0, sq, q_chunk)], dim=2)
        return out.transpose(1, 2)

    return remat(whole, q, k, v)


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


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, b_up: torch.Tensor,
             w_down: torch.Tensor, b_down: torch.Tensor) -> torch.Tensor:
    """The plain MLP, with the tanh GELU of ``jax.nn.gelu(approximate=
    True)``."""
    h = F.gelu((x @ w_up) + b_up, approximate="tanh")
    return (h @ w_down) + b_down


def mlp_apply(p, x: torch.Tensor, gated: bool) -> torch.Tensor:
    """The gated (SwiGLU: ``p`` holds ``w_gate, w_up, w_down``) or plain
    (GELU: ``w_up, b_up, w_down, b_down``) MLP."""
    if gated:
        return swiglu(x, p.w_gate, p.w_up, p.w_down)
    return gelu_mlp(x, p.w_up, p.b_up, p.w_down, p.b_down)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (B, S, V) of any float dtype, labels (B, S) int: the mean
    cross-entropy in nats, in fp32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)
