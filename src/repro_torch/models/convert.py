"""Weights carried across from the reference: the JAX ``init_params``
pytree, as numpy arrays with the layers stacked on leading axes, into the
port's ``Model``, and back.

Both sides keep ``x @ W`` with ``W (d_in, d_out)``, so every leaf copies as
it is; only the stacked axes are split.  A port parameter
``<stack>.<i>[.<j>].<path>`` is the reference's ``<stack>.<path>[i[, j]]``:
``layers`` (dense, moe), ``selfs`` (vlm, stacked twice: ``(G, every-1,
...)``), ``crosses`` (vlm, its 0-d ``attn.gate`` stacked to ``(G,)``),
``mlstm`` (ssm, stacked twice: ``(G, every-1, ...)``), ``slstm`` (ssm,
``(G,)``), ``mamba`` (hybrid, stacked twice: ``(G, every, ...)``),
``encoder`` and ``decoder`` (audio).  ``emb``, ``ln_f`` and ``head`` are the
reference's ``embed.*``; ``enc_ln``, ``norms (G, every, d)`` and the
hybrid's unstacked ``shared`` block are top-level leaves as they are.  Each
leaf keeps its dtype (the mixers' fp32 leaves stay fp32 in a bf16 model);
bf16 leaves (numpy's ``bfloat16`` extension type) pass through fp32, which
holds every bf16 value exactly.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.models.model import Model, empty_model

Params = Dict[str, Any]
EMBED = ("emb", "ln_f", "head")


def _leaves(model: Model) -> Iterator[Tuple[Tuple[str, ...], Tuple[int, ...],
                                            torch.Tensor]]:
    """(path in the reference pytree, index into the leaf's stacked axes,
    the port's tensor) for every weight of ``model``."""
    for name, p in model.named_parameters():
        parts = name.split(".")
        if len(parts) == 1:
            yield ("embed", name) if name in EMBED else (name,), (), p
            continue
        rest = parts[1:]
        idx = []
        while rest[0].isdigit():
            idx.append(int(rest.pop(0)))
        yield (parts[0],) + tuple(rest), tuple(idx), p


def _get(tree: Params, path: Tuple[str, ...]):
    for key in path:
        if not isinstance(tree, dict) or key not in tree:
            raise KeyError(f"the reference params have no leaf "
                           f"{'.'.join(path)}")
        tree = tree[key]
    return tree


def _count(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count(v) for v in tree.values())
    return 1


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))      # a writable copy


def params_from_reference(np_params: Params, cfg,
                          device: DeviceLike = None) -> Model:
    """The reference's parameters (numpy leaves) as the port's ``Model``
    on ``device`` (the card unless ``device="cpu"``).  Raises if a leaf is
    missing, left over, or of another shape (a stack of another depth
    included)."""
    model = empty_model(cfg, device)
    leaves = list(_leaves(model))
    extents: Dict[Tuple[str, ...], Tuple[int, ...]] = {}  # the port's stacks
    for path, i, _ in leaves:
        extents[path] = tuple(max(a + 1, n) for a, n in
                              zip(i, extents.get(path, (0,) * len(i))))
    for path, ext in extents.items():
        ref = np.shape(_get(np_params, path))[:len(ext)]
        if ref != ext:
            raise ValueError(f"{'.'.join(path)}: the reference stacks {ref}, "
                             f"the port's model {ext}")
    if len(extents) != _count(np_params):
        raise ValueError(f"the reference params hold {_count(np_params)} "
                         f"leaves, the port's {cfg.name} model "
                         f"{len(extents)}")
    with torch.no_grad():
        for path, i, p in leaves:
            src = _to_torch(np.asarray(_get(np_params, path))[i])
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{'.'.join(path)}: reference shape "
                                 f"{tuple(src.shape)}, port "
                                 f"{tuple(p.shape)}")
            p.copy_(src.to(p.dtype))
    return model


def params_to_reference(model: Model) -> Params:
    """The port's weights as the reference's pytree of numpy arrays (fp32
    for bf16 weights), the layers stacked on leading axes."""
    out: Params = {}
    stacks: Dict[Tuple[str, ...], Dict[Tuple[int, ...], np.ndarray]] = {}
    for path, i, p in _leaves(model):
        a = p.detach().float().cpu().numpy() if p.dtype == torch.bfloat16 \
            else p.detach().cpu().numpy()
        stacks.setdefault(path, {})[i] = a
    for path, parts in stacks.items():
        first = next(iter(parts.values()))
        lead = tuple(1 + max(i[ax] for i in parts)
                     for ax in range(len(next(iter(parts)))))
        leaf = np.empty(lead + first.shape, dtype=first.dtype)
        for i, a in parts.items():
            leaf[i] = a
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out
