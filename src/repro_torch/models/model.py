"""Model assembly for serving: init, cache and one decode step, for the
dense and moe families (``repro.models.model``'s counterpart, decode path
only; training and the other families wait in ROADMAP.md).

``Model`` holds the weights (an ``nn.Module`` of frozen parameters, one
``Block`` per layer).  ``init_params(cfg, seed, device)`` draws them from a
seeded ``torch.Generator`` on the device, layer by layer; ``init_cache``
and ``decode_step`` are functions of the model, as in the reference.  The
reference's scan over stacked layers becomes a Python loop that writes each
layer's cache in place.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as default_kernels
from repro_torch.models import transformer as tfm
from repro_torch.models.common import Init, dense_init, dtype_of, frozen, rmsnorm

PORTED_FAMILIES = ("dense", "moe")


class Model(nn.Module):
    """Embedding (``emb (V, d)``), final norm ``ln_f``, an untied ``head
    (d, V)`` unless the config ties it to ``emb``, and ``layers``."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        if cfg.family not in PORTED_FAMILIES:
            raise NotImplementedError(
                f"model family {cfg.family!r} ({cfg.name}) is not ported yet "
                f"(see ROADMAP.md); the port serves {PORTED_FAMILIES}")
        self.cfg = cfg
        dtype = dtype_of(cfg)
        self.emb = frozen(init(_emb_init, cfg.vocab_size, cfg.d_model, dtype))
        self.ln_f = frozen(init.ones((cfg.d_model,), dtype))
        if not cfg.tie_embeddings:
            self.head = frozen(init(dense_init, cfg.d_model, cfg.vocab_size,
                                    dtype))
        kind = "moe" if cfg.n_experts else "self"
        self.layers = nn.ModuleList(tfm.Block(cfg, init, dtype, kind)
                                    for _ in range(cfg.n_layers))

    @property
    def device(self) -> torch.device:
        return self.emb.device


def _emb_init(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype):
    x = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * 0.02).to(dtype)


def init_params(cfg, seed: int = 0, device: DeviceLike = None) -> Model:
    """The model's weights drawn from ``torch.Generator(device)`` seeded
    with ``seed``, on the device (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return Model(cfg, Init(gen, dev))


def empty_model(cfg, device: DeviceLike = None) -> Model:
    """The model's weights allocated uninitialised on the device, for
    ``convert.params_from_reference`` to fill."""
    return Model(cfg, Init(None, resolve_device(device)))


def _logits_head(model: Model, h: torch.Tensor) -> torch.Tensor:
    w = model.emb.T if model.cfg.tie_embeddings else model.head
    return h @ w


def init_cache(model: Model, batch_size: int,
               max_len: int) -> Dict[str, torch.Tensor]:
    """The decode cache on the model's device: ``len (B,)`` int32 and the
    stacked layer caches ``k, v (L, B, S, Hkv, hd)``."""
    cfg = model.cfg
    cache = {"len": torch.zeros((batch_size,), dtype=torch.int32,
                                device=model.device)}
    cache.update(tfm.kv_cache_init(cfg, batch_size, max_len, dtype_of(cfg),
                                   model.device, cfg.n_layers))
    return cache


def decode_step(model: Model, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor, *, kernels=default_kernels
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens: (B, 1) -> (logits (B, V), cache).  ``cache["len"]`` holds
    each request's current length (ragged aggregated batches).  Each
    layer's K and V are written into ``cache`` in place and ``len`` is
    advanced by one; the same dict is returned.  ``kernels`` supplies
    ``decode_attention`` and ``grouped_gemm`` (``kernels.ops`` by default;
    ``ops.PLAIN_LM`` for the plain versions)."""
    cfg = model.cfg
    clen = cache["len"]
    x = model.emb[tokens].to(dtype_of(cfg))
    for i, layer in enumerate(model.layers):
        x = tfm.self_block_decode(layer, x, cfg, cache["k"][i],
                                  cache["v"][i], clen, kernels=kernels)
    h = rmsnorm(x[:, 0], model.ln_f, cfg.norm_eps)
    logits = _logits_head(model, h)
    cache["len"] = clen + 1
    return logits, cache
