"""Data-parallel training with a compressed gradient all-reduce, the
resilient outer loop and elastic re-placement
(``repro.distributed.fault_tolerance``'s counterpart).

* ``make_dp_train_step``: each rank of a ``torch.distributed`` group
  takes the gradients of its own batch; the loss is averaged over the
  group and every gradient leaf is reduced, int8 with error feedback
  (``repro_torch.optim.compression.compressed_allreduce``) or as a plain
  fp32 mean, before the replicated AdamW update.  A leaf is the
  reference's: the port's per-layer parameters stacked into one tensor
  (``convert.reference_stacks``), so one int8 scale covers the stack as
  it does there.  The reference runs the same step in ``shard_map`` over
  a mesh axis; here each rank is one process on one device.
* ``resilient_loop``: ``state = step_fn(state, step)`` with checkpoint
  and replay.  A dead card raises ``torch.AcceleratorError`` in PyTorch,
  where the reference catches ``jax.errors.JaxRuntimeError``; tests inject
  ``SimulatedFailure``.  The (seed, step)-addressable data stream makes a
  replay exact.
* ``rescale_state``: a model and its optimizer state placed on a new mesh
  (a pod gained or lost) by the rules used at startup.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.distributed.api import place, tree_map
from repro_torch.optim.adamw import OptConfig, opt_update
from repro_torch.optim.compression import compressed_allreduce

log = logging.getLogger("repro_torch.ft")


def _params(model) -> Dict[str, torch.Tensor]:
    if isinstance(model, Mapping):
        return dict(model)
    return dict(model.named_parameters())


def _stacks(model) -> List[List[str]]:
    """The parameter names of each leaf of the reference's pytree."""
    from repro_torch.models import convert

    return list(convert.reference_stacks(model).values())


# ---------------------------------------------------------------------------
# data-parallel train step with compressed gradient reduction
# ---------------------------------------------------------------------------

def make_dp_train_step(loss_fn: Callable, opt_cfg: OptConfig, group=None,
                       compress: bool = True) -> Callable:
    """``step(model, opt_state, residual, batch) -> (model, opt_state,
    residual, loss, {"grad_norm", "lr"})`` over ``group`` (the default
    group when None).  ``loss_fn(model, batch) -> scalar`` on this rank's
    batch; the model's weights and the state are updated in place."""
    import torch.distributed as dist

    stacks: List[List[str]] = []

    def step(model, opt_state, residual, batch):
        model.requires_grad_(True)
        params = _params(model)
        if not stacks:
            stacks.extend(_stacks(model))
        loss = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True, materialize_grads=True)
        n = float(dist.get_world_size(group))
        loss = loss.detach().float()
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
        loss = loss / n
        grads = dict(zip(params, grads))
        reduced, new_res = {}, {}
        if compress:
            for names in stacks:
                g = torch.stack([grads.pop(k).float() for k in names])
                r = torch.stack([residual[k] for k in names])
                m, nr = compressed_allreduce(g, group, r)
                del g, r
                for i, k in enumerate(names):
                    reduced[k], new_res[k] = m[i], nr[i]
        else:
            for k in list(grads):
                g = grads.pop(k).float().clone()
                dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
                reduced[k], new_res[k] = g / n, residual[k]
        _, opt_state, metrics = opt_update(reduced, opt_state, params,
                                           opt_cfg)
        return model, opt_state, new_res, loss, metrics

    return step


def residual_init(model) -> Dict[str, torch.Tensor]:
    """fp32 zeros beside each parameter of ``model`` (a model or a mapping
    of name to tensor)."""
    return {name: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for name, p in _params(model).items()}


# ---------------------------------------------------------------------------
# resilient outer loop
# ---------------------------------------------------------------------------

class SimulatedFailure(RuntimeError):
    pass


# what a lost step raises: an injected failure, or a dead card (the error
# class torch raises for a failed CUDA call since 2.8)
RECOVERABLE = (SimulatedFailure,) + tuple(
    e for e in (getattr(torch, "AcceleratorError", None),) if e is not None)


def resilient_loop(step_fn: Callable, state: Any, n_steps: int, *,
                   save_every: int = 10,
                   save_fn: Optional[Callable] = None,
                   restore_fn: Optional[Callable] = None,
                   failure_hook: Optional[Callable[[int], None]] = None,
                   max_retries: int = 3) -> Tuple[Any, Dict[str, Any]]:
    """Run ``state = step_fn(state, step)`` for ``n_steps`` steps with
    checkpoint/replay recovery: ``save_fn(state, step)`` every
    ``save_every`` steps; on a :data:`RECOVERABLE` error, restore the last
    save (``restore_fn(step) -> state``) and replay from it, or replay the
    step when nothing was saved.  More than ``max_retries`` failures in a
    row raise ``RuntimeError("unrecoverable ...")``.  ``failure_hook(step)``
    may raise ``SimulatedFailure``.  Returns (state, {"failures",
    "restores", "saved_steps"})."""
    stats: Dict[str, Any] = {"failures": 0, "restores": 0, "saved_steps": []}
    step = 0
    last_saved = None
    retries = 0
    while step < n_steps:
        try:
            if failure_hook is not None:
                failure_hook(step)
            state = step_fn(state, step)
            if save_fn is not None and (step + 1) % save_every == 0:
                save_fn(state, step + 1)
                last_saved = step + 1
                stats["saved_steps"].append(step + 1)
                retries = 0
            step += 1
        except RECOVERABLE as e:
            stats["failures"] += 1
            retries += 1
            if retries > max_retries:
                raise RuntimeError(
                    f"unrecoverable: {retries} consecutive failures") from e
            if restore_fn is not None and last_saved is not None:
                log.warning("step %d failed (%s); restoring step %d",
                            step, e, last_saved)
                state = restore_fn(last_saved)
                step = last_saved
                stats["restores"] += 1
            else:
                log.warning("step %d failed (%s); replaying step", step, e)
    return state, stats


# ---------------------------------------------------------------------------
# elastic re-scale
# ---------------------------------------------------------------------------

def rescale_state(model, opt_state, new_mesh, spec_fn: Callable):
    """``(model, opt_state)`` placed on ``new_mesh``: ``spec_fn(tree,
    mesh)`` gives each leaf's placement (a ``NamedSharding`` or a device),
    for the model's parameters (name -> tensor) and for the state.  A
    model's parameters move in place; a mapping of tensors comes back as a
    new mapping."""
    params = _params(model)
    p_spec = spec_fn(params, new_mesh)
    o_spec = spec_fn(opt_state, new_mesh)
    opt_state = tree_map(place, opt_state, o_spec)
    if isinstance(model, Mapping):
        return {k: place(v, p_spec[k]) for k, v in params.items()}, opt_state
    with torch.no_grad():
        for name, p in params.items():
            p.data = place(p.data, p_spec[name])
    return model, opt_state
