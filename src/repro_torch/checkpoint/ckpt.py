"""Step-indexed checkpoints, crash-consistent, in the reference's format.

One ``step_XXXXXXXX.npz`` per step holds a flattened state: tensors,
tuples, lists and dicts of them, each leaf under a path-encoded key,
``params//<path>`` and ``opt//<path>``.  A path joins its parts with
``//``: ``#i`` for a tuple or list index, the key for a dict, nothing for
a bare tensor (``params//``).  A JSON sidecar ``step_XXXXXXXX.npz.json``
holds ``{"step": ..., **meta}``.  The keys and the publish order are the
JAX package's (``repro.checkpoint.ckpt``), so a file written by either
package restores in the other bit for bit.

Writes are atomic: each file is written under a temporary name and
renamed, the sidecar first, then the npz.  ``latest_step`` keys on npz
names only, so a crash between the two renames leaves no trace or a whole
checkpoint, never an npz without its sidecar.

bf16 leaves are stored as fp32 (npz has no bf16) and cast back to the
template's dtype on restore; a restored leaf lands on its template's
device.  ``restore_resharded`` restores onto a mesh: each leaf placed as
a spec function says (``repro_torch.distributed.api.place``).
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

SEP = "//"


def _leaves(tree, path: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``(key, leaf)`` pairs of a tree of tensors, tuples, lists and dicts,
    keyed as the reference's ``tree_flatten_with_path``: dict keys in
    sorted order, ``None`` an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, (tuple, list)):
        return [kv for i, sub in enumerate(tree)
                for kv in _leaves(sub, path + (f"#{i}",))]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _leaves(tree[k], path + (str(k),))]
    return [(SEP.join(path), tree)]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _rebuild(template, flat: Dict[str, np.ndarray],
             path: Tuple[str, ...] = ()):
    """``template``'s structure with each leaf read from ``flat``; tensor
    leaves take the template leaf's dtype and device."""
    if template is None:
        return None
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(sub, flat, path + (f"#{i}",))
                              for i, sub in enumerate(template))
    if isinstance(template, dict):
        return {k: _rebuild(v, flat, path + (str(k),))
                for k, v in template.items()}
    arr = flat[SEP.join(path)]
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(arr).to(device=template.device,
                                       dtype=template.dtype)
    return arr


def save_checkpoint(ckpt_dir: str, step: int, params, opt_state,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Write step ``step`` of ``params`` and ``opt_state`` (trees of
    tensors) with ``meta`` in its sidecar; returns the npz's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = {f"params{SEP}{k}": _to_numpy(v) for k, v in _leaves(params)}
    flat.update({f"opt{SEP}{k}": _to_numpy(v)
                 for k, v in _leaves(opt_state)})
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **flat)
    fd2, tmp2 = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    with os.fdopen(fd2, "w") as f:
        json.dump({"step": step, **(meta or {})}, f)
    # the sidecar first, then the npz (see the module's docstring)
    os.rename(tmp2, path + ".json")
    os.rename(tmp, path)
    return path


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The highest step with a published npz, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for fn in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)\.npz$", fn))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, params_template,
                       opt_template) -> Tuple[Any, Any, Dict[str, Any]]:
    """Step ``step`` as ``(params, opt_state, meta)``, each tree shaped
    like its template."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    heads = (f"params{SEP}", f"opt{SEP}")
    p_flat, o_flat = ({k[len(h):]: v for k, v in flat.items()
                       if k.startswith(h)} for h in heads)
    with open(path + ".json") as f:
        meta = json.load(f)
    return (_rebuild(params_template, p_flat),
            _rebuild(opt_template, o_flat), meta)


def restore_resharded(ckpt_dir: str, step: int, params_template,
                      opt_template, mesh, spec_fn):
    """Elastic restore: :func:`restore_checkpoint`, then each leaf placed
    on ``mesh`` as ``spec_fn(tree) -> tree of NamedSharding`` (or of
    devices) says; numpy leaves (non-tensor templates) become tensors
    there.  Returns ``(params, opt_state, meta)``."""
    from repro_torch.distributed.api import place, tree_map

    params, opt, meta = restore_checkpoint(ckpt_dir, step, params_template,
                                           opt_template)
    params = tree_map(place, params, spec_fn(params))
    opt = tree_map(place, opt, spec_fn(opt))
    return params, opt, meta
