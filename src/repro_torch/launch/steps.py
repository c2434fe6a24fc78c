"""The step builders (``repro.launch.steps``'s counterpart).

``make_train_step``: loss -> gradients -> AdamW update, optionally with
gradient accumulation over ``microbatch`` microbatches.  Each
microbatch's gradients are taken with ``torch.autograd.grad`` and added
into fp32 buffers, as the reference accumulates them (fp32 zeros plus each
microbatch's gradient): a second ``.backward()`` would add bf16 gradients
in bf16.  The update writes the model's weights and the optimizer state in
place (the reference donates both).

``make_prefill_step`` and ``make_serve_step``: the full-sequence forward
with the last position's logits, and one decode step; both run under
``torch.inference_mode()``, so a model that trains serves without
recording an autograd graph (and a CUDA-graph capture never sees one).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as model_mod
from repro_torch.models.common import rmsnorm
from repro_torch.optim.adamw import OptConfig, opt_update

Batch = Dict[str, torch.Tensor]


def _split(batch: Batch, n: int, i: int) -> Batch:
    """Microbatch ``i`` of ``n``: rows [i B/n, (i+1) B/n) of every input,
    the reference's ``reshape(n, B // n, ...)[i]``."""
    out = {}
    for name, x in batch.items():
        b = x.shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} rows is no whole number of "
                             f"{n} microbatches")
        out[name] = x[i * (b // n):(i + 1) * (b // n)]
    return out


def make_train_step(cfg, opt_cfg: OptConfig, *, microbatch: int = 0,
                    device: DeviceLike = None) -> Callable:
    """``train_step(model, opt_state, batch) -> (model, opt_state,
    {"loss", "grad_norm", "lr"})`` for a model of ``cfg`` on ``device``
    (the card unless ``device="cpu"``; raises without one).  The step
    turns the model's gradients on."""
    dev = resolve_device(device)

    def train_step(model: model_mod.Model, opt_state, batch: Batch):
        if model.device != dev:
            raise ValueError(f"the model lies on {model.device}, the step "
                             f"runs on {dev}")
        model.requires_grad_(True)
        params = dict(model.named_parameters())
        leaves = list(params.values())

        def grads_of(part: Batch) -> Tuple[torch.Tensor, Tuple]:
            loss = model_mod.loss_fn(model, part)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
            return loss.detach(), grads

        if microbatch and microbatch > 1:
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
                   for p in leaves]
            for i in range(microbatch):
                part_loss, grads = grads_of(_split(batch, microbatch, i))
                loss = loss + part_loss
                for a, g in zip(acc, grads):
                    a.add_(g)
                del grads
            loss = loss / microbatch
            for a in acc:
                a.div_(microbatch)
            grads = acc
        else:
            loss, grads = grads_of(batch)
        grads = dict(zip(params, grads))
        _, opt_state, metrics = opt_update(grads, opt_state, params, opt_cfg)
        return model, opt_state, {"loss": loss, **metrics}

    return train_step


def make_prefill_step(cfg) -> Callable:
    """``prefill_step(model, batch) -> (B, V)``: the full-sequence forward
    and the last position's logits (the decode handoff)."""
    @torch.inference_mode()
    def prefill_step(model: model_mod.Model, batch: Batch) -> torch.Tensor:
        h = model_mod.forward_hidden(model, batch)
        hl = rmsnorm(h[:, -1], model.ln_f, cfg.norm_eps)
        w = model.emb.T if cfg.tie_embeddings else model.head
        return hl @ w
    return prefill_step


def make_serve_step(cfg) -> Callable:
    """``serve_step(model, cache, batch) -> (logits (B, V), cache)``: one
    decode step (``batch`` a dict holding ``tokens (B, 1)``, or the
    tokens)."""
    @torch.inference_mode()
    def serve_step(model: model_mod.Model, cache, batch):
        tokens = batch["tokens"] if isinstance(batch, dict) else batch
        return model_mod.decode_step(model, cache, tokens)
    return serve_step
