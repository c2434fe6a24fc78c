"""Weights carried across from the reference: the JAX ``init_params``
pytree, as numpy arrays with the layers stacked on a leading axis, into
the port's ``Model``, and back.

Both sides keep ``x @ W`` with ``W (d_in, d_out)``, so every leaf copies as
it is; only the layer axis is split (``layers.<path>[i]`` is
``model.layers[i].<path>``) and ``embed.{emb, ln_f, head}`` are the
model's top-level weights.  bf16 leaves (numpy's ``bfloat16`` extension
type) pass through fp32, which holds every bf16 value exactly.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.models.model import Model, empty_model

Params = Dict[str, Any]


def _leaves(model: Model) -> Iterator[Tuple[Tuple[str, ...], Any, torch.Tensor]]:
    """(path in the reference pytree, layer index or None, the port's
    tensor) for every weight of ``model``."""
    for name, p in model.named_parameters(recurse=False):
        yield ("embed", name), None, p
    for i, layer in enumerate(model.layers):
        for name, p in layer.named_parameters():
            yield ("layers",) + tuple(name.split(".")), i, p


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
    missing, left over, or of another shape."""
    model = empty_model(cfg, device)
    used = set()
    with torch.no_grad():
        for path, i, p in _leaves(model):
            leaf = _get(np_params, path)
            src = _to_torch(leaf if i is None else np.asarray(leaf)[i])
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{'.'.join(path)}: reference shape "
                                 f"{tuple(src.shape)}, port "
                                 f"{tuple(p.shape)}")
            p.copy_(src.to(p.dtype))
            used.add(path)
    if len(used) != _count(np_params):
        raise ValueError(f"the reference params hold {_count(np_params)} "
                         f"leaves, the port's {cfg.name} model {len(used)}")
    return model


def params_to_reference(model: Model) -> Params:
    """The port's weights as the reference's pytree of numpy arrays (fp32
    for bf16 weights), layers stacked on a leading axis."""
    out: Params = {}
    stacks: Dict[Tuple[str, ...], list] = {}
    for path, i, p in _leaves(model):
        a = p.detach().float().cpu().numpy() if p.dtype == torch.bfloat16 \
            else p.detach().cpu().numpy()
        if i is None:
            out.setdefault(path[0], {})[path[1]] = a
        else:
            stacks.setdefault(path, []).append(a)
    for path, arrays in stacks.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(arrays)
    return out
