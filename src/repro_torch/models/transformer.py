"""Pre-norm decoder blocks (``repro.models.transformer``'s counterpart):
the full-sequence forms training runs (``self_block_apply``, which the
audio encoder also runs once per admission, llama-vision's gated
``cross_block_apply`` and the enc-dec ``encdec_decoder_apply``), and the
serving forms: one new token per request against a KV cache written at
each request's own position, and the cross-attention blocks that read a
fixed memory (llama-vision's gated image layers, the enc-dec decoder's
cross-attention sub-layer).  The full-sequence forms take the MoE layer's
einsum branch, as the reference's do (``use_pallas_moe=False``), and reach
no kernel.

A layer's KV cache is ``k, v (B, S, Hkv, hd)``; ``cache_len`` is a (B,)
vector, so ragged aggregated batches work -- each request owns its slot of
the shared buffers.  Sliding-window layers keep rolling caches of window
size.  A cross-attention layer reads ``k, v (B, Sm, Hkv, hd)`` computed
once from the memory (``cross_kv_precompute``, ``xattn_kv_precompute``).
Unlike the reference, which returns a new cache, the port writes each
layer's cache in place.

Every attention read of a decode step goes through ``kernels``
(``kernels.ops`` by default: the decode-attention kernel on the card),
cross attention with ``cache_len`` the full memory length.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops as default_kernels
from repro_torch.models.common import (
    Attention, GeluMLP, Init, LayerNorm, SwiGLU, apply_rope, attention,
    frozen, layernorm, mlp_apply, out_proj, qkv_proj, rmsnorm,
)
from repro_torch.models.moe import MoE, moe_ffn

BLOCK_KINDS = ("self", "moe", "cross")


def _norm(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """LayerNorm for a ``LayerNorm`` module's ``{w, b}``, else RMSNorm."""
    if isinstance(p, LayerNorm):
        return layernorm(x, p.w, p.b, cfg.norm_eps)
    return rmsnorm(x, p, cfg.norm_eps)


def _norm_init(cfg, init: Init, dtype: torch.dtype):
    """A non-gated (GPT-style) stack's LayerNorm, else an RMSNorm
    weight."""
    if not cfg.mlp_gated:
        return LayerNorm(init, cfg.d_model, dtype)
    return frozen(init.ones((cfg.d_model,), dtype))


class Block(nn.Module):
    """One decoder layer (``block_init``, kind ``self``, ``moe`` or
    ``cross``): norms ``ln1, ln2``, ``attn`` (with its gate for ``cross``),
    and ``moe`` or ``mlp`` (gated or plain, as the config says)."""

    def __init__(self, cfg, init: Init, dtype: torch.dtype, kind: str):
        super().__init__()
        if kind not in BLOCK_KINDS:
            raise ValueError(f"block kind {kind!r}: expected one of "
                             f"{BLOCK_KINDS}")
        self.ln1 = _norm_init(cfg, init, dtype)
        self.attn = Attention(cfg, init, dtype, cross=kind == "cross")
        self.ln2 = _norm_init(cfg, init, dtype)
        if kind == "moe":
            self.moe = MoE(cfg, init, dtype)
        elif cfg.mlp_gated:
            self.mlp = SwiGLU(init, cfg.d_model, cfg.d_ff, dtype)
        else:
            self.mlp = GeluMLP(init, cfg.d_model, cfg.d_ff, dtype)


class DecoderLayer(Block):
    """An enc-dec decoder layer (``decoder_layer_init``): a ``self`` block
    plus the cross-attention sub-layer's norm ``ln_x`` and weights
    ``xattn`` (which carry the reference's unused gate)."""

    def __init__(self, cfg, init: Init, dtype: torch.dtype):
        super().__init__(cfg, init, dtype, "self")
        self.ln_x = _norm_init(cfg, init, dtype)
        self.xattn = Attention(cfg, init, dtype, cross=True)


# ---------------------------------------------------------------------------
# full sequence (training, the audio encoder)
# ---------------------------------------------------------------------------

def _ffn(p: Block, x: torch.Tensor, cfg, *,
         kernels=default_kernels) -> torch.Tensor:
    h = _norm(p.ln2, x, cfg)
    if hasattr(p, "moe"):
        out = moe_ffn(p.moe, h, cfg, kernels=kernels)
    else:
        out = mlp_apply(p.mlp, h, cfg.mlp_gated)
    return x + out


def self_block_apply(p: Block, x: torch.Tensor, cfg,
                     positions: torch.Tensor, *,
                     causal: bool = True) -> torch.Tensor:
    """x (B, S, d) at ``positions`` (S,) -> (B, S, d): the whole sequence
    through one block (RoPE, the full-sequence attention, the FFN)."""
    h = _norm(p.ln1, x, cfg)
    q, k, v = qkv_proj(p.attn, h, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, causal=causal, q_positions=positions,
                  kv_positions=positions, sliding_window=cfg.sliding_window)
    x = x + out_proj(p.attn, o)
    return _ffn(p, x, cfg, kernels=None)


def _memory_attend(attn: Attention, h: torch.Tensor, memory: torch.Tensor,
                   cfg, bias: bool) -> torch.Tensor:
    """Queries from h (B, S, d), keys and values from memory (B, Sm, d),
    every position visible, no RoPE; the QKV biases where ``bias`` and the
    config has them; the output projection."""
    b, s, _ = h.shape
    sm, hd = memory.shape[1], cfg.resolved_head_dim
    q = (h @ attn.wq).reshape(b, s, cfg.n_heads, hd)
    k = (memory @ attn.wk).reshape(b, sm, cfg.n_kv_heads, hd)
    v = (memory @ attn.wv).reshape(b, sm, cfg.n_kv_heads, hd)
    if bias and cfg.qkv_bias:
        q = q + attn.bq.reshape(cfg.n_heads, hd)
        k = k + attn.bk.reshape(cfg.n_kv_heads, hd)
        v = v + attn.bv.reshape(cfg.n_kv_heads, hd)
    zeros = torch.zeros((s,), dtype=torch.int32, device=h.device)
    o = attention(q, k, v, causal=False, q_positions=zeros,
                  kv_positions=torch.zeros((sm,), dtype=torch.int32,
                                           device=h.device))
    return out_proj(attn, o)


def cross_block_apply(p: Block, x: torch.Tensor, memory: torch.Tensor,
                      cfg) -> torch.Tensor:
    """llama-vision's gated cross-attention block over the whole sequence:
    x (B, S, d) attends to memory (B, Sm, d), the output scaled by
    ``tanh(gate)``, then the FFN."""
    o = _memory_attend(p.attn, _norm(p.ln1, x, cfg), memory, cfg, bias=True)
    x = x + torch.tanh(p.attn.gate).to(o.dtype) * o
    return _ffn(p, x, cfg, kernels=None)


def encdec_decoder_apply(p: DecoderLayer, x: torch.Tensor,
                         memory: torch.Tensor, cfg,
                         positions: torch.Tensor) -> torch.Tensor:
    """An enc-dec decoder layer over the whole sequence: causal
    self-attention (RoPE, no window), ungated cross-attention over the
    encoder's memory (no bias), the FFN."""
    h = _norm(p.ln1, x, cfg)
    q, k, v = qkv_proj(p.attn, h, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = attention(q, k, v, causal=True, q_positions=positions,
                  kv_positions=positions)
    x = x + out_proj(p.attn, o)
    x = x + _memory_attend(p.xattn, _norm(p.ln_x, x, cfg), memory, cfg,
                           bias=False)
    return _ffn(p, x, cfg, kernels=None)


# ---------------------------------------------------------------------------
# decode (one token, KV cache)
# ---------------------------------------------------------------------------

def kv_cache_init(cfg, batch: int, max_len: int, dtype: torch.dtype,
                  device, n_layers: int) -> Dict[str, torch.Tensor]:
    """Zeroed caches of ``n_layers`` layers, stacked: ``k, v (n_layers,
    batch, S, Hkv, hd)``, S the window for sliding-window configs."""
    hd = cfg.resolved_head_dim
    s = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    shape = (n_layers, batch, s, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _cache_write(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 cache_len: torch.Tensor, sliding_window: int) -> None:
    """Write one token per request at its own position (rolling for SWA),
    in place."""
    b = k_new.shape[0]
    s = k_cache.shape[1]
    clen = cache_len.long()
    pos = clen % s if sliding_window else torch.clamp(clen, max=s - 1)
    rows = torch.arange(b, device=k_cache.device)
    k_cache[rows, pos] = k_new[:, 0]
    v_cache[rows, pos] = v_new[:, 0]


def _self_attend(attn: Attention, h: torch.Tensor, cfg,
                 k_cache: torch.Tensor, v_cache: torch.Tensor,
                 cache_len: torch.Tensor, sliding_window: int,
                 kernels) -> torch.Tensor:
    """The self-attention read of one decode step: RoPE at each request's
    position, this token's K and V written into the cache, the attention
    over the valid positions, the output projection."""
    q, k, v = qkv_proj(attn, h, cfg)
    pos = cache_len[:, None]                          # (B, 1) absolute
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    _cache_write(k_cache, v_cache, k, v, cache_len, sliding_window)
    valid_len = cache_len + 1
    if sliding_window:
        # rolling cache: every written slot is valid
        valid_len = torch.clamp(valid_len, max=k_cache.shape[1])
    o = kernels.decode_attention(q[:, 0], k_cache, v_cache,
                                 valid_len)[:, None]
    return out_proj(attn, o)


def _cross_attend(attn: Attention, h: torch.Tensor, cfg,
                  cross_k: torch.Tensor, cross_v: torch.Tensor,
                  kernels) -> torch.Tensor:
    """One token's queries (no bias, no RoPE, as the reference's decode
    path) against the fixed memory's K and V, every position valid."""
    b = h.shape[0]
    q = (h @ attn.wq).reshape(b, cfg.n_heads, cfg.resolved_head_dim)
    full = torch.full((b,), cross_k.shape[1], dtype=torch.int32,
                      device=h.device)
    o = kernels.decode_attention(q, cross_k, cross_v, full)[:, None]
    return out_proj(attn, o)


def self_block_decode(p: Block, x: torch.Tensor, cfg, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                      kernels=default_kernels) -> torch.Tensor:
    """x: (B, 1, d); cache_len: (B,) int32 tokens already in the cache.
    Writes this token's K and V into the layer's cache; returns the new x."""
    h = _norm(p.ln1, x, cfg)
    x = x + _self_attend(p.attn, h, cfg, k_cache, v_cache, cache_len,
                         cfg.sliding_window, kernels)
    return _ffn(p, x, cfg, kernels=kernels)


def cross_block_decode(p: Block, x: torch.Tensor, cfg,
                       cross_k: torch.Tensor, cross_v: torch.Tensor, *,
                       kernels=default_kernels) -> torch.Tensor:
    """A gated cross-attention block against precomputed (fixed) memory
    K and V: the attention output scaled by ``tanh(gate)``, then the
    FFN."""
    h = _norm(p.ln1, x, cfg)
    o = _cross_attend(p.attn, h, cfg, cross_k, cross_v, kernels)
    o = torch.tanh(p.attn.gate).to(o.dtype) * o
    return _ffn(p, x + o, cfg, kernels=kernels)


def cross_kv_precompute(p: Block, memory: torch.Tensor,
                        cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """memory (B, Sm, d) -> the cross block's K, V (B, Sm, Hkv, hd)."""
    return _memory_kv(p.attn, memory, cfg)


def encdec_decoder_decode(p: DecoderLayer, x: torch.Tensor, cfg,
                          k_cache: torch.Tensor, v_cache: torch.Tensor,
                          cache_len: torch.Tensor, cross_k: torch.Tensor,
                          cross_v: torch.Tensor, *,
                          kernels=default_kernels) -> torch.Tensor:
    """An enc-dec decoder layer: causal self-attention over the cache (no
    window), cross-attention over the encoder's memory (ungated), FFN."""
    h = _norm(p.ln1, x, cfg)
    x = x + _self_attend(p.attn, h, cfg, k_cache, v_cache, cache_len, 0,
                         kernels)
    h = _norm(p.ln_x, x, cfg)
    x = x + _cross_attend(p.xattn, h, cfg, cross_k, cross_v, kernels)
    return _ffn(p, x, cfg, kernels=kernels)


def xattn_kv_precompute(p: DecoderLayer, memory: torch.Tensor,
                        cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """memory (B, Sm, d) -> the decoder layer's cross K, V (B, Sm, Hkv,
    hd)."""
    return _memory_kv(p.xattn, memory, cfg)


def _memory_kv(attn: Attention, memory: torch.Tensor,
               cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    b, sm, _ = memory.shape
    shape = (b, sm, cfg.n_kv_heads, cfg.resolved_head_dim)
    return (memory @ attn.wk).reshape(shape), (memory @ attn.wv).reshape(shape)
