"""Model assembly: init, the full-sequence forward and loss that training
runs, and the cache and decode step that serving runs, for every family of
the reference (``repro.models.model``'s counterpart).

``Model`` holds the weights (an ``nn.Module`` of frozen parameters):

  dense/moe : ``layers``, one ``Block`` per layer
  ssm       : ``mlstm`` (G groups of ``slstm_every - 1`` mLSTM blocks),
              ``slstm`` (G sLSTM blocks) and the pre-norms ``norms (G,
              every, d)``, G = n_layers / slstm_every (xlstm)
  hybrid    : ``mamba`` (G groups of ``shared_attn_every`` Mamba2 layers),
              their pre-norms ``norms (G, every, d)`` and ONE ``shared``
              self-attention block applied before each group, G =
              n_layers / shared_attn_every (zamba2)
  vlm       : ``selfs`` (G groups of ``cross_attn_every - 1`` self blocks)
              and ``crosses`` (G gated cross-attention blocks), G =
              n_layers / cross_attn_every (llama-3.2-vision)
  audio     : ``encoder`` (``n_encoder_layers`` self blocks), ``decoder``
              (``DecoderLayer``s) and the encoder's final norm ``enc_ln``

``init_params(cfg, seed, device)`` draws them from a seeded
``torch.Generator`` on the device, layer by layer; ``forward_hidden``,
``forward``, ``loss_fn``, ``init_cache`` and ``decode_step`` are functions
of the model, as in the reference.  The reference's scans over stacked
layers become Python loops (decode writes each layer's cache in place).

Training: ``loss_fn`` is the mean cross-entropy of ``forward_hidden``'s
states, taken by ``chunked_xent`` in 512-position chunks so the fp32 (B,
S, V) logits never exist at once.  With ``cfg.remat`` each layer (each
group for vlm, ssm and hybrid) is rematerialised in the backward, as the
reference's ``_maybe_remat`` does; the full-sequence attention always is.
The forward reaches no kernel, as the reference's does not: attention is
plain PyTorch and the MoE layer takes its einsum branch.  The weights are
created without gradients (``frozen``); a training run turns them on
(``model.requires_grad_(True)``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops as default_kernels
from repro_torch.models import ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (
    Init, dense_init, dtype_of, frozen, remat, rmsnorm, softmax_xent,
)

Batch = Dict[str, torch.Tensor]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
STUB_FRAMES = 8           # audio frames of the engine's stub input
# cache leaves written once by ``init_cache`` and only read by decode
CROSS_LEAVES = ("cross_k", "cross_v")


class Model(nn.Module):
    """Embedding (``emb (V, d)``), final norm ``ln_f``, an untied ``head
    (d, V)`` unless the config ties it to ``emb``, and the family's
    stacks (module docstring)."""

    def __init__(self, cfg, init: Init):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"model family {cfg.family!r} ({cfg.name}): "
                             f"expected one of {FAMILIES}")
        self.cfg = cfg
        dtype = dtype_of(cfg)
        self.emb = frozen(init(_emb_init, cfg.vocab_size, cfg.d_model, dtype))
        self.ln_f = frozen(init.ones((cfg.d_model,), dtype))
        if not cfg.tie_embeddings:
            self.head = frozen(init(dense_init, cfg.d_model, cfg.vocab_size,
                                    dtype))

        def blocks(n, kind):
            return nn.ModuleList(tfm.Block(cfg, init, dtype, kind)
                                 for _ in range(n))

        def mixers(n, cls):
            return nn.ModuleList(cls(cfg, init, dtype) for _ in range(n))

        if cfg.family in ("dense", "moe"):
            self.layers = blocks(cfg.n_layers,
                                 "moe" if cfg.n_experts else "self")
        elif cfg.family == "ssm":
            every = cfg.slstm_every
            groups = cfg.n_layers // every
            self.mlstm = nn.ModuleList(mixers(every - 1, ssm.MLSTM)
                                       for _ in range(groups))
            self.slstm = mixers(groups, ssm.SLSTM)
            self.norms = frozen(init.ones((groups, every, cfg.d_model),
                                          dtype))
        elif cfg.family == "hybrid":
            every = cfg.shared_attn_every
            groups = cfg.n_layers // every
            self.mamba = nn.ModuleList(mixers(every, ssm.Mamba2)
                                       for _ in range(groups))
            self.norms = frozen(init.ones((groups, every, cfg.d_model),
                                          dtype))
            self.shared = tfm.Block(cfg, init, dtype, "self")
        elif cfg.family == "vlm":
            every = cfg.cross_attn_every
            groups = cfg.n_layers // every
            self.selfs = nn.ModuleList(blocks(every - 1, "self")
                                       for _ in range(groups))
            self.crosses = blocks(groups, "cross")
        else:                                               # audio
            self.encoder = blocks(cfg.n_encoder_layers, "self")
            self.decoder = nn.ModuleList(tfm.DecoderLayer(cfg, init, dtype)
                                         for _ in range(cfg.n_layers))
            self.enc_ln = frozen(init.ones((cfg.d_model,), dtype))

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


# ---------------------------------------------------------------------------
# forward (training / prefill)
# ---------------------------------------------------------------------------

def _maybe_remat(fn, cfg):
    """``fn`` with its activations recomputed in the backward when
    ``cfg.remat`` (the reference's ``nothing_saveable`` policy)."""
    if not cfg.remat:
        return fn
    return lambda *args: remat(fn, *args)


def _mixer_apply(apply, layer, x: torch.Tensor, norm_w: torch.Tensor,
                 cfg) -> torch.Tensor:
    """A pre-norm residual mixer layer over the whole sequence."""
    y, _ = apply(layer, rmsnorm(x, norm_w, cfg.norm_eps), cfg)
    return x + y


def forward_hidden(model: Model, batch: Batch) -> torch.Tensor:
    """The final hidden states (B, S, d) before the LM head, from
    ``batch["tokens"] (B, S)`` (and ``vision`` for vlm, ``frames`` for
    audio, cast to the model's dtype)."""
    cfg = model.cfg
    dtype = dtype_of(cfg)
    tokens = batch["tokens"]
    x = model.emb[tokens.long()].to(dtype)
    positions = torch.arange(tokens.shape[1], device=x.device)

    if cfg.family in ("dense", "moe"):
        def body(h, layer):
            return tfm.self_block_apply(layer, h, cfg, positions)
        body = _maybe_remat(body, cfg)
        for layer in model.layers:
            x = body(x, layer)

    elif cfg.family == "vlm":
        memory = batch["vision"].to(dtype)

        def group(h, selfs, cross):
            for layer in selfs:
                h = tfm.self_block_apply(layer, h, cfg, positions)
            return tfm.cross_block_apply(cross, h, memory, cfg)
        group = _maybe_remat(group, cfg)
        for selfs, cross in zip(model.selfs, model.crosses):
            x = group(x, selfs, cross)

    elif cfg.family == "ssm":
        def group(h, mlstms, slstm, norms):
            for j, layer in enumerate(mlstms):
                h = _mixer_apply(ssm.mlstm_apply, layer, h, norms[j], cfg)
            return _mixer_apply(ssm.slstm_apply, slstm, h, norms[-1], cfg)
        group = _maybe_remat(group, cfg)
        for g, (mlstms, slstm) in enumerate(zip(model.mlstm, model.slstm)):
            x = group(x, mlstms, slstm, model.norms[g])

    elif cfg.family == "hybrid":
        def group(h, mambas, norms):
            h = tfm.self_block_apply(model.shared, h, cfg, positions)
            for j, layer in enumerate(mambas):
                h = _mixer_apply(ssm.mamba2_apply, layer, h, norms[j], cfg)
            return h
        group = _maybe_remat(group, cfg)
        for g, mambas in enumerate(model.mamba):
            x = group(x, mambas, model.norms[g])

    else:                                                   # audio
        frames = batch["frames"].to(dtype)
        enc_pos = torch.arange(frames.shape[1], device=x.device)

        def enc_body(h, layer):
            return tfm.self_block_apply(layer, h, cfg, enc_pos,
                                        causal=False)
        enc_body = _maybe_remat(enc_body, cfg)
        memory = frames
        for layer in model.encoder:
            memory = enc_body(memory, layer)
        memory = rmsnorm(memory, model.enc_ln, cfg.norm_eps)

        def dec_body(h, layer):
            return tfm.encdec_decoder_apply(layer, h, memory, cfg, positions)
        dec_body = _maybe_remat(dec_body, cfg)
        for layer in model.decoder:
            x = dec_body(x, layer)
    return x


def forward(model: Model, batch: Batch) -> torch.Tensor:
    """The full logits (B, S, V) (small models and tests only)."""
    h = forward_hidden(model, batch)
    h = rmsnorm(h, model.ln_f, model.cfg.norm_eps)
    return _logits_head(model, h)


XENT_CHUNK = 512


def chunked_xent(model: Model, hidden: torch.Tensor, labels: torch.Tensor,
                 chunk: int = XENT_CHUNK) -> torch.Tensor:
    """The mean cross-entropy of the final norm and LM head over hidden
    (B, S, d) against labels (B, S): whole when ``S <= chunk`` or S is no
    multiple of ``chunk``; otherwise chunk by chunk, each chunk's logits
    rematerialised, so no (B, S, V) fp32 tensor exists."""
    b, s, _ = hidden.shape
    hidden = rmsnorm(hidden, model.ln_f, model.cfg.norm_eps)
    if s <= chunk or s % chunk != 0:
        return softmax_xent(_logits_head(model, hidden), labels)

    def part(hh, ll):
        return softmax_xent(_logits_head(model, hh), ll)

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, chunk):
        total = total + remat(part, hidden[:, i:i + chunk],
                              labels[:, i:i + chunk])
    return total / (s // chunk)


def loss_fn(model: Model, batch: Batch) -> torch.Tensor:
    """The mean next-token cross-entropy of ``batch["labels"]``."""
    return chunked_xent(model, forward_hidden(model, batch), batch["labels"])


def stub_batch(cfg, batch_size: int,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The serving engine's stand-in memory, fp32 (``init_cache`` casts
    it): zero ``vision (B, vision_tokens, d)`` for vlm, zero ``frames (B,
    STUB_FRAMES, d)`` for audio, nothing for the other families."""
    shape = {"vlm": ("vision", cfg.vision_tokens),
             "audio": ("frames", STUB_FRAMES)}.get(cfg.family)
    if shape is None:
        return {}
    name, n = shape
    return {name: torch.zeros((batch_size, n, cfg.d_model),
                              dtype=torch.float32, device=device)}


def forward_encoder(model: Model, frames: torch.Tensor) -> torch.Tensor:
    """The audio encoder over frames (B, Sm, d) in the model's dtype: its
    self blocks without a causal mask, then RMSNorm ``enc_ln``."""
    cfg = model.cfg
    pos = torch.arange(frames.shape[1], device=frames.device)
    h = frames
    for layer in model.encoder:
        h = tfm.self_block_apply(layer, h, cfg, pos, causal=False)
    return rmsnorm(h, model.enc_ln, cfg.norm_eps)


def _stacked(state: Dict[str, torch.Tensor], n: int,
             prefix: str) -> Dict[str, torch.Tensor]:
    """One mixer's decode state repeated over ``n`` layers on a new
    leading axis, each leaf named ``<prefix>_<name>``."""
    return {f"{prefix}_{name}": t[None].repeat((n,) + (1,) * t.dim())
            for name, t in state.items()}


def init_cache(model: Model, batch_size: int, max_len: int,
               batch: Optional[Dict[str, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
    """The decode cache on the model's device: ``len (B,)`` int32, and the
    family's leaves, every one but ``len`` with the slot axis at position
    1:

      dense/moe/vlm/audio: the stacked self-attention caches ``k, v (L,
        B, S, Hkv, hd)`` (L the family's self-attention layers in order:
        vlm layer ``j`` of group ``g`` is ``g (every - 1) + j``), and for
        vlm and audio the memory's ``cross_k, cross_v (G or L, B, Sm, Hkv,
        hd)``, from ``batch["vision"]`` or the encoded ``batch["frames"]``
        (``stub_batch``'s zeros when ``batch`` is None);
      ssm: ``mlstm_C (Lm, B, H, hd, hd)``, ``mlstm_n (Lm, B, H, hd)``,
        ``mlstm_m (Lm, B, H)`` (-1e30), mLSTM ``j`` of group ``g`` at ``g
        (every - 1) + j``, and ``slstm_h, slstm_c, slstm_n, slstm_m (G, B,
        d)`` (``n`` ones), all fp32; no K or V;
      hybrid: ``mamba_conv (L, B, 3, inner + 2 N)`` in the model's dtype,
        ``mamba_ssm (L, B, H, N, 64)`` fp32 (layer ``j`` of group ``g`` at
        ``g every + j``), and the shared block's ``k, v (G, B, S, Hkv,
        hd)``, one per application."""
    cfg = model.cfg
    dtype, dev = dtype_of(cfg), model.device
    cache = {"len": torch.zeros((batch_size,), dtype=torch.int32,
                                device=dev)}
    if cfg.family == "ssm":
        groups = cfg.n_layers // cfg.slstm_every
        cache.update(_stacked(ssm.mlstm_state_init(cfg, batch_size, dev),
                              groups * (cfg.slstm_every - 1), "mlstm"))
        cache.update(_stacked(ssm.slstm_state_init(cfg, batch_size, dev),
                              groups, "slstm"))
        return cache
    if cfg.family == "hybrid":
        cache.update(_stacked(ssm.mamba2_state_init(cfg, batch_size, dtype,
                                                    dev),
                              cfg.n_layers, "mamba"))
        cache.update(tfm.kv_cache_init(cfg, batch_size, max_len, dtype, dev,
                                       cfg.n_layers // cfg.shared_attn_every))
        return cache
    if cfg.family == "vlm":
        n_self = cfg.n_layers // cfg.cross_attn_every \
            * (cfg.cross_attn_every - 1)
    else:
        n_self = cfg.n_layers
    cache.update(tfm.kv_cache_init(cfg, batch_size, max_len, dtype, dev,
                                   n_self))
    if cfg.family not in ("vlm", "audio"):
        return cache
    if batch is None:
        batch = stub_batch(cfg, batch_size, dev)
    if cfg.family == "vlm":
        memory = batch["vision"].to(dev, dtype)
        layers, precompute = model.crosses, tfm.cross_kv_precompute
    else:
        memory = forward_encoder(model, batch["frames"].to(dev, dtype))
        layers, precompute = model.decoder, tfm.xattn_kv_precompute
    shape = (len(layers), batch_size, memory.shape[1], cfg.n_kv_heads,
             cfg.resolved_head_dim)
    ck, cv = (torch.empty(shape, dtype=dtype, device=dev) for _ in range(2))
    for i, layer in enumerate(layers):
        ck[i], cv[i] = precompute(layer, memory, cfg)
    cache["cross_k"], cache["cross_v"] = ck, cv
    return cache


def _mixer_step(apply, layer, x: torch.Tensor, norm_w: torch.Tensor, cfg,
                cache: Dict[str, torch.Tensor], prefix: str, names,
                i: int) -> torch.Tensor:
    """A pre-norm residual mixer layer decoding one token from its state
    (``cache[<prefix>_<name>][i]``), which it overwrites in place."""
    state = {n: cache[f"{prefix}_{n}"][i] for n in names}
    y, state = apply(layer, rmsnorm(x, norm_w, cfg.norm_eps), cfg,
                     state=state)
    for n in names:
        cache[f"{prefix}_{n}"][i].copy_(state[n])
    return x + y


def decode_step(model: Model, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor, *, kernels=default_kernels
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tokens: (B, 1) -> (logits (B, V), cache).  ``cache["len"]`` holds
    each request's current length (ragged aggregated batches).  Each
    layer's K and V, or its mixer's state, are written into ``cache`` in
    place and ``len`` is advanced by one; the same dict is returned.
    ``kernels`` supplies ``decode_attention`` and ``grouped_gemm``
    (``kernels.ops`` by default; ``ops.PLAIN_LM`` for the plain
    versions).  The ssm family reads no attention; the hybrid applies
    its shared block before each group's Mamba2 layers."""
    cfg = model.cfg
    clen = cache["len"]
    k, v = cache.get("k"), cache.get("v")
    x = model.emb[tokens].to(dtype_of(cfg))
    if cfg.family == "ssm":
        i = 0
        for g, (mlstms, slstm) in enumerate(zip(model.mlstm, model.slstm)):
            for j, layer in enumerate(mlstms):
                x = _mixer_step(ssm.mlstm_apply, layer, x, model.norms[g, j],
                                cfg, cache, "mlstm", ("C", "n", "m"), i)
                i += 1
            x = _mixer_step(ssm.slstm_apply, slstm, x, model.norms[g, -1],
                            cfg, cache, "slstm", ("h", "c", "n", "m"), g)
    elif cfg.family == "hybrid":
        every = cfg.shared_attn_every
        for g, layers in enumerate(model.mamba):
            x = tfm.self_block_decode(model.shared, x, cfg, k[g], v[g], clen,
                                      kernels=kernels)
            for j, layer in enumerate(layers):
                x = _mixer_step(ssm.mamba2_apply, layer, x,
                                model.norms[g, j], cfg, cache, "mamba",
                                ("conv", "ssm"), g * every + j)
    elif cfg.family in ("dense", "moe"):
        for i, layer in enumerate(model.layers):
            x = tfm.self_block_decode(layer, x, cfg, k[i], v[i], clen,
                                      kernels=kernels)
    elif cfg.family == "vlm":
        i = 0
        for g, (selfs, cross) in enumerate(zip(model.selfs, model.crosses)):
            for layer in selfs:
                x = tfm.self_block_decode(layer, x, cfg, k[i], v[i], clen,
                                          kernels=kernels)
                i += 1
            x = tfm.cross_block_decode(cross, x, cfg, cache["cross_k"][g],
                                       cache["cross_v"][g], kernels=kernels)
    else:                                                   # audio
        for i, layer in enumerate(model.decoder):
            x = tfm.encdec_decoder_decode(
                layer, x, cfg, k[i], v[i], clen, cache["cross_k"][i],
                cache["cross_v"][i], kernels=kernels)
    h = rmsnorm(x[:, 0], model.ln_f, cfg.norm_eps)
    logits = _logits_head(model, h)
    cache["len"] = clen + 1
    return logits, cache
