"""AdamW, the cosine schedule with linear warmup, and global-norm clipping
(``repro.optim.adamw``'s counterpart).

Parameters and gradients are mappings of name to tensor (a model's
``named_parameters()``), the state ``{"m": {...}, "v": {...}, "step"}``:
``m`` and ``v`` fp32 whatever a parameter's dtype, ``step`` a 0-d int32
tensor.  The update runs in fp32 and is cast back to each parameter's
dtype; weight decay applies to every leaf, norms and biases included, as
in the reference.  The schedule and the bias corrections are fp32 tensors
on the parameters' device, so a step reads nothing back to the host.

``opt_update`` writes the parameters, ``m`` and ``v`` in place (the
reference donates them), one flat chunk of at most ``CHUNK`` elements at
a time, and scales each chunk's fp32 gradient by the clipping factor
there: no fp32 copy of all gradients and no leaf-sized fp32 temporary
exists at once, and the arithmetic is the reference's, operation for
operation.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterable, Mapping, Tuple, Union

import torch

CHUNK = 1 << 24            # elements per piece of a leaf's update

Tensors = Union[Mapping[str, torch.Tensor], Iterable[torch.Tensor]]


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    clip_norm: float = 1.0


def _tensors(tree: Tensors):
    return list(tree.values()) if isinstance(tree, Mapping) else list(tree)


def cosine_lr(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an int32 tensor), a 0-d
    fp32 tensor: linear warmup to ``lr`` over ``warmup_steps``, then a
    cosine to 0 at ``total_steps``."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = cfg.lr * (step + 1) / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * cfg.lr * (1.0 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def opt_init(params: Mapping[str, torch.Tensor]) -> Dict[str, object]:
    """Zero fp32 ``m`` and ``v`` beside each parameter, ``step`` 0."""
    def zeros():
        return {name: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
                for name, p in params.items()}
    dev = next(iter(params.values())).device
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _pieces(t: torch.Tensor):
    """Flat pieces of ``t`` (views of a contiguous tensor)."""
    flat = t.reshape(-1)
    return [flat[i:i + CHUNK] for i in range(0, flat.numel(), CHUNK)]


def global_norm(tree: Tensors) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in fp32."""
    total = None
    for x in _tensors(tree):
        for piece in _pieces(x.detach()):
            sq = torch.sum(torch.square(piece.float()))
            total = sq if total is None else total + sq
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-9), 1.0)


def clip_by_global_norm(tree: Mapping[str, torch.Tensor], max_norm: float):
    """(every leaf in fp32 scaled to a global norm of at most
    ``max_norm``, the norm before clipping)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return {k: g.float() * scale for k, g in tree.items()}, norm


@torch.no_grad()
def opt_update(grads: Mapping[str, torch.Tensor], state: Dict[str, object],
               params: Mapping[str, torch.Tensor], cfg: OptConfig
               ) -> Tuple[Mapping[str, torch.Tensor], Dict[str, object],
                          Dict[str, torch.Tensor]]:
    """One AdamW step: clip the gradients to ``cfg.clip_norm``, update
    ``m``, ``v`` and every parameter in place; returns (params, the state
    with ``step + 1``, {"grad_norm", "lr"})."""
    step = state["step"]
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.clip_norm)
    lr = cosine_lr(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - torch.pow(b1, step.float() + 1.0)
    bc2 = 1.0 - torch.pow(b2, step.float() + 1.0)
    for name, p in params.items():
        pieces = zip(_pieces(p), _pieces(grads[name]),
                     _pieces(state["m"][name]), _pieces(state["v"][name]))
        for pp, gg, m, v in pieces:
            g = gg.float() * scale
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            p32 = pp.float()
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
                + cfg.weight_decay * p32
            pp.copy_(p32 - lr * delta)
    new_state = {"m": state["m"], "v": state["v"], "step": step + 1}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
