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

The optimizer state carries across the same way: ``opt_state_to_reference``
/ ``opt_state_from_reference`` map the port's ``{"m": {name: t}, "v":
{name: t}, "step"}`` (``repro_torch.optim``) to the reference's ``{"m",
"v", "step"}`` trees of the parameters' layout and back, so a training
checkpoint holds the reference's keys.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.models.model import Model, empty_model

Params = Dict[str, Any]
EMBED = ("emb", "ln_f", "head")


def _leaves(model: Model, tensors: Optional[Mapping[str, torch.Tensor]] = None
            ) -> Iterator[Tuple[Tuple[str, ...], Tuple[int, ...],
                                torch.Tensor]]:
    """(path in the reference pytree, index into the leaf's stacked axes,
    the port's tensor) for every weight of ``model``, or, given
    ``tensors`` (parameter name -> tensor), for each weight's tensor
    there."""
    for name, p in model.named_parameters():
        if tensors is not None:
            p = tensors[name]
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


def fill_from_reference(np_params: Params, model: Model,
                         tensors: Optional[Mapping[str, torch.Tensor]] = None
                         ) -> None:
    """Copy the reference's tree (numpy leaves) into the model's weights,
    or into ``tensors`` (parameter name -> tensor of the weight's shape).
    Raises if a leaf is missing, left over, or of another shape (a stack
    of another depth included)."""
    leaves = list(_leaves(model, tensors))
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
                         f"leaves, the port's {model.cfg.name} model "
                         f"{len(extents)}")
    with torch.no_grad():
        for path, i, p in leaves:
            src = _to_torch(np.asarray(_get(np_params, path))[i])
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{'.'.join(path)}: reference shape "
                                 f"{tuple(src.shape)}, port "
                                 f"{tuple(p.shape)}")
            p.copy_(src.to(p.dtype))


def params_from_reference(np_params: Params, cfg,
                          device: DeviceLike = None) -> Model:
    """The reference's parameters (numpy leaves) as the port's ``Model``
    on ``device`` (the card unless ``device="cpu"``)."""
    model = empty_model(cfg, device)
    fill_from_reference(np_params, model)
    return model


def params_to_reference(model: Model,
                        tensors: Optional[Mapping[str, torch.Tensor]] = None
                        ) -> Params:
    """The port's weights, or ``tensors`` (parameter name -> tensor of the
    weight's shape: its gradients, say), as the reference's pytree of
    numpy arrays (fp32 for bf16 tensors), the layers stacked on leading
    axes."""
    out: Params = {}
    stacks: Dict[Tuple[str, ...], Dict[Tuple[int, ...], np.ndarray]] = {}
    for path, i, p in _leaves(model, tensors):
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


def reference_stacks(model: Model) -> Dict[Tuple[str, ...], list]:
    """Each leaf of the reference's pytree (its path) with the names of
    the port's parameters stacked into it, in the stack's row-major
    order: a leaf of one parameter is a list of one name."""
    out: Dict[Tuple[str, ...], list] = {}
    names = (n for n, _ in model.named_parameters())
    for (path, idx, _), name in zip(_leaves(model), names):
        out.setdefault(path, []).append((idx, name))
    return {path: [n for _, n in sorted(parts)]
            for path, parts in out.items()}


def reference_shapes(model: Model) -> Params:
    """The reference pytree of ``model``'s weights with each leaf a meta
    tensor of the leaf's shape (the layers stacked on leading axes) and
    dtype: what ``jax.eval_shape`` of the reference's ``init_params``
    gives, for sharding specs and sizes."""
    out: Params = {}
    stacks: Dict[Tuple[str, ...], Tuple[Tuple[int, ...], torch.Tensor]] = {}
    for path, i, p in _leaves(model):
        ext, _ = stacks.get(path, ((0,) * len(i), p))
        stacks[path] = (tuple(max(a + 1, n) for a, n in zip(i, ext)), p)
    for path, (ext, p) in stacks.items():
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.empty(ext + tuple(p.shape), dtype=p.dtype,
                                     device="meta")
    return out


def reference_layout(model: Model) -> Params:
    """The reference pytree's structure of ``model``'s weights, every leaf
    0: a restore template that copies nothing off the device."""
    out: Params = {}
    for path, _, _ in _leaves(model):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = 0
    return out


def opt_state_to_reference(model: Model, state: Dict[str, Any]) -> Params:
    """The port's optimizer state of ``model`` as the reference's ``{"m",
    "v", "step"}``: fp32 trees in the parameters' layout and an int32
    0-d ``step``."""
    return {"m": params_to_reference(model, state["m"]),
            "v": params_to_reference(model, state["v"]),
            "step": np.asarray(state["step"].cpu().numpy(), np.int32)}


def opt_state_from_reference(np_state: Params, model: Model
                             ) -> Dict[str, Any]:
    """The reference's ``{"m", "v", "step"}`` (numpy leaves) as the port's
    optimizer state of ``model``, fp32, on the model's device."""
    dev = model.device

    def fp32_like():
        return {name: torch.empty(p.shape, dtype=torch.float32, device=dev)
                for name, p in model.named_parameters()}
    m, v = fp32_like(), fp32_like()
    fill_from_reference(np_state["m"], model, m)
    fill_from_reference(np_state["v"], model, v)
    step = torch.as_tensor(np.asarray(np_state["step"]).astype(np.int32),
                           device=dev)
    return {"m": m, "v": v, "step": step}
