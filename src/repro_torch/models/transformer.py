"""Pre-norm decoder blocks, decode path (``repro.models.transformer``'s
counterpart for the dense and moe families): one new token per request
against a KV cache written at each request's own position.

A layer's KV cache is ``k, v (B, S, Hkv, hd)``; ``cache_len`` is a (B,)
vector, so ragged aggregated batches work -- each request owns its slot of
the shared buffers.  Sliding-window layers keep rolling caches of window
size.  Unlike the reference, which returns a new cache, the port writes
each layer's cache in place.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from repro_torch.kernels import ops as default_kernels
from repro_torch.models.common import (
    Attention, Init, SwiGLU, apply_rope, frozen, mlp_apply, out_proj,
    qkv_proj, rmsnorm,
)
from repro_torch.models.moe import MoE, moe_ffn


class Block(nn.Module):
    """One decoder layer (``block_init`` with kind ``self`` or ``moe``):
    RMSNorm weights ``ln1, ln2``, ``attn``, and ``mlp`` or ``moe``."""

    def __init__(self, cfg, init: Init, dtype: torch.dtype, kind: str):
        super().__init__()
        if kind not in ("self", "moe"):
            raise NotImplementedError(
                f"block kind {kind!r} is not ported yet (see ROADMAP.md); "
                f"the port serves 'self' and 'moe' blocks")
        if not cfg.mlp_gated:
            raise NotImplementedError(
                "LayerNorm / plain-MLP blocks are not ported yet (see "
                "ROADMAP.md); the port serves gated (SwiGLU) stacks")
        self.ln1 = frozen(init.ones((cfg.d_model,), dtype))
        self.attn = Attention(cfg, init, dtype)
        self.ln2 = frozen(init.ones((cfg.d_model,), dtype))
        if kind == "moe":
            self.moe = MoE(cfg, init, dtype)
        else:
            self.mlp = SwiGLU(init, cfg.d_model, cfg.d_ff, dtype)


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


def self_block_decode(p: Block, x: torch.Tensor, cfg, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                      kernels=default_kernels) -> torch.Tensor:
    """x: (B, 1, d); cache_len: (B,) int32 tokens already in the cache.
    Writes this token's K and V into the layer's cache; returns the new x."""
    h = rmsnorm(x, p.ln1, cfg.norm_eps)
    q, k, v = qkv_proj(p.attn, h, cfg)
    pos = cache_len[:, None]                          # (B, 1) absolute
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    _cache_write(k_cache, v_cache, k, v, cache_len, cfg.sliding_window)
    s = k_cache.shape[1]
    valid_len = cache_len + 1
    if cfg.sliding_window:
        # rolling cache: every written slot is valid
        valid_len = torch.clamp(valid_len, max=s)
    o = kernels.decode_attention(q[:, 0], k_cache, v_cache,
                                 valid_len)[:, None]
    x = x + out_proj(p.attn, o)
    h = rmsnorm(x, p.ln2, cfg.norm_eps)
    if hasattr(p, "moe"):
        out = moe_ffn(p.moe, h, cfg, kernels=kernels)
    else:
        out = mlp_apply(p.mlp, h)
    return x + out
