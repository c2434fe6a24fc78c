"""Sharding specs for parameters, optimizer state, batches and caches
(``repro.launch.sharding``'s counterpart).

The logical-axis rules (``repro_torch.distributed.api``) are resolved
against a mesh with the divisibility fallback, so the same rules serve
every (arch x shape x mesh) cell: 4-KV-head GQA replicates the kv-head
dimension on a 16-way model axis, a 60-expert MoE falls back from expert-
to ff-sharding, a batch-1 long-context cache falls back from batch- to
sequence-sharding.  Weight matrices shard ``d_model`` over ``fsdp`` (pod x
data) and their fan-out over ``tp`` (model), the reference's ZeRO-3 rule.

Specs are taken over the reference's trees, so each leaf's spec is the
reference's: the parameters as ``convert.reference_shapes`` (the port's
per-layer weights stacked on leading axes) and the decode cache as
:func:`cache_reference_shapes` (the port's flat cache in the reference's
nesting).  Models are built on the ``meta`` device, so a full-width
model allocates nothing.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.distributed.api import (
    NamedSharding, PartitionSpec as P, logical_rules, spec_for, tree_map,
)

# -- parameter leaf rules (base shapes; stacked-layer axes are prepended) ---
# fmt: off
_PARAM_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "emb": ("vocab", "fsdp"),
    "head": ("fsdp", "vocab"),
    "wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "w_gate": ("fsdp", "tp"), "w_up": ("fsdp", "tp"),
    "w_down": ("tp", "fsdp"),
    "router": ("fsdp", None),
    "in_proj": ("fsdp", "tp"), "out_proj": ("tp", "fsdp"),
    "up_l": ("fsdp", "tp"), "up_r": ("fsdp", "tp"),
    "down": ("tp", "fsdp"),
    "w_x": ("fsdp", "tp"), "w_h": ("fsdp", "tp"),
    "w_if": ("fsdp", None),
}
_MOE_AXES: Dict[str, Tuple[Optional[str], ...]] = {
    "w_gate": ("expert", "fsdp", "tp"),
    "w_up": ("expert", "fsdp", "tp"),
    "w_down": ("expert", "tp", "fsdp"),
}
# fmt: on


def _walk(tree, keys: Tuple[str, ...] = ()
          ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(dict keys on the path, leaf) in the reference's flatten order
    (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], keys + (str(k),))
    elif isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        for v in tree:
            yield from _walk(v, keys)
    else:
        yield keys, tree


def _with_specs(tree, specs: List[P]):
    it = iter(specs)
    return tree_map(lambda _: next(it), _sorted(tree))


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree


def param_pspec(tree) -> Any:
    """PartitionSpec tree for a parameter tree (leaves with a ``shape``),
    inside a rules context."""
    out = []
    for keys, leaf in _walk(tree):
        key = keys[-1] if keys else ""
        in_moe = "moe" in keys and "shared" not in keys
        base = _MOE_AXES.get(key) if in_moe and key in _MOE_AXES else \
            _PARAM_AXES.get(key)
        shape = tuple(leaf.shape)
        if base is None or len(base) > len(shape):
            out.append(P())
            continue
        names = (None,) * (len(shape) - len(base)) + tuple(base)
        out.append(spec_for(shape, names))
    return _with_specs(tree, out)


# -- cache leaf rules --------------------------------------------------------

def _cache_slot_axes(cache_shapes, probe_shapes) -> List[Optional[int]]:
    axes = []
    for (_, a), (_, b) in zip(_walk(cache_shapes), _walk(probe_shapes)):
        axes.append(next((i for i, (x, y) in enumerate(zip(a.shape, b.shape))
                          if x != y), None))
    return axes


def cache_pspec(cache_shapes, probe_shapes) -> Any:
    """PartitionSpec tree for a decode cache.  ``probe_shapes`` is the same
    cache built at batch + 1 (its slot axis is the one that differs)."""
    slot_axes = _cache_slot_axes(cache_shapes, probe_shapes)
    out = []
    for (keys, leaf), slot in zip(_walk(cache_shapes), slot_axes):
        key = keys[-1] if keys else ""
        nd = len(leaf.shape)
        names: list = [None] * nd
        if slot is not None:
            names[slot] = "batch"
            rest = nd - slot - 1
            if key in ("k", "v") and rest >= 2:
                names[slot + 1] = "kv_seq"
                names[slot + 2] = "kv_heads"
            elif key in ("ssm", "C") and rest >= 1:
                names[slot + 1] = "heads"
            elif key in ("n", "m") and rest >= 1 and "mlstm" in keys:
                names[slot + 1] = "heads"
        out.append(spec_for(tuple(leaf.shape), names))
    return _with_specs(cache_shapes, out)


def batch_pspec(batch_shapes) -> Any:
    """Batch inputs shard on the (pod, data) batch axis."""
    return tree_map(lambda leaf: spec_for(
        tuple(leaf.shape), ["batch"] + [None] * (len(leaf.shape) - 1)),
        batch_shapes)


def named(mesh, spec_tree) -> Any:
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


def opt_pspec(param_spec_tree) -> Any:
    """Optimizer state mirrors params; step counter replicated."""
    return {"m": param_spec_tree, "v": param_spec_tree, "step": P()}


def rules_overrides(shape, cfg=None) -> Dict:
    """Logical-rule overrides for one shape cell (the reference's): decode
    caches let the KV sequence absorb the mesh axes the batch cannot
    cover, and serving replicates the weights of a model whose 16-way
    tensor-parallel share is under 6 GB (bf16), else keeps the FSDP
    gather on the intra-pod data axis only."""
    ov: Dict = {}
    if shape.kind == "decode":
        ov.setdefault("kv_seq", ("pod", "data", "model"))
        if cfg is not None:
            tp_bytes = cfg.param_count() * 2 / 16    # bf16, 16-way TP share
            ov.setdefault("fsdp",
                          None if tp_bytes < 6e9 else ("data",))
    return ov


def cache_reference_shapes(cfg, cache: Dict[str, torch.Tensor]) -> Dict:
    """The port's flat decode cache (``model.init_cache``) in the
    reference's nesting: ``kv`` / ``cross_kv`` / ``shared_kv`` ``{k, v}``,
    ``mlstm {C, n, m}`` and ``slstm {h, c, n, m}``, ``mamba {conv,
    ssm}``, the stacks reshaped to the reference's ``(G, every, ...)``
    where it stacks twice."""
    fam = cfg.family
    out: Dict[str, Any] = {"len": cache["len"]}

    def grouped(t, every):
        return t.reshape((t.shape[0] // every, every) + tuple(t.shape[1:]))

    if fam == "ssm":
        every = cfg.slstm_every
        out["mlstm"] = {n: grouped(cache[f"mlstm_{n}"], every - 1)
                        for n in ("C", "n", "m")}
        out["slstm"] = {n: cache[f"slstm_{n}"] for n in ("h", "c", "n", "m")}
        return out
    if fam == "hybrid":
        every = cfg.shared_attn_every
        out["mamba"] = {n: grouped(cache[f"mamba_{n}"], every)
                        for n in ("conv", "ssm")}
        out["shared_kv"] = {"k": cache["k"], "v": cache["v"]}
        return out
    kv = {"k": cache["k"], "v": cache["v"]}
    if fam == "vlm":
        kv = {n: grouped(t, cfg.cross_attn_every - 1) for n, t in kv.items()}
    out["kv"] = kv
    if fam in ("vlm", "audio"):
        out["cross_kv"] = {"k": cache["cross_k"], "v": cache["cross_v"]}
    return out


def _meta_cache(cfg, model, b: int, seq_len: int) -> Dict:
    """The decode cache of ``b`` requests on ``meta``, built from the
    reference's dummy batch (zeros of its vision or frames shape)."""
    from repro_torch.models import model as model_mod

    batch: Dict[str, torch.Tensor] = {}
    if cfg.family == "vlm":
        batch["vision"] = torch.empty((b, cfg.vision_tokens, cfg.d_model),
                                      dtype=torch.bfloat16, device="meta")
    if cfg.family == "audio":
        batch["frames"] = torch.empty((b, 8 * cfg.encoder_seq_ratio,
                                       cfg.d_model), dtype=torch.bfloat16,
                                      device="meta")
    with torch.no_grad():
        cache = model_mod.init_cache(model, b, seq_len, batch or None)
    return cache_reference_shapes(cfg, cache)


def make_all_specs(cfg, shape, mesh, *, overrides: Optional[Dict] = None):
    """``(params, batch, cache, param spec, opt spec, batch spec, cache
    spec)`` for one cell: the trees hold meta tensors; ``cache`` and its
    spec are None but for decode shapes."""
    from repro_torch.data.pipeline import make_batch_specs
    from repro_torch.models import convert
    from repro_torch.models import model as model_mod

    model = model_mod.empty_model(cfg, "meta")
    params_sh = convert.reference_shapes(model)
    batch_sh = make_batch_specs(cfg, shape)

    ov = dict(overrides or {})
    ov.update(rules_overrides(shape, cfg))

    with logical_rules(mesh, ov):
        pspec = param_pspec(params_sh)
        ospec = opt_pspec(pspec)
        bspec = batch_pspec(batch_sh)
        if shape.kind == "decode":
            cache_sh = _meta_cache(cfg, model, shape.global_batch,
                                   shape.seq_len)
            probe_sh = _meta_cache(cfg, model, shape.global_batch + 1,
                                   shape.seq_len)
            cspec = cache_pspec(cache_sh, probe_sh)
            return params_sh, batch_sh, cache_sh, pspec, ospec, bspec, cspec
    return params_sh, batch_sh, None, pspec, ospec, bspec, None


def device_bytes(tree, spec_tree, mesh) -> int:
    """Bytes one device holds of ``tree`` sharded by ``spec_tree`` on
    ``mesh``: each leaf's bytes over the product of the mesh axes its spec
    names (a dimension the axes do not divide cannot occur: the rules
    keep only dividing axes)."""
    total = 0
    specs = [s for _, s in _walk(spec_tree)]
    for (_, leaf), spec in zip(_walk(tree), specs):
        n = 1
        for part in spec:
            for a in ((part,) if isinstance(part, str) else (part or ())):
                n *= mesh.shape.get(a, 1)
        total += leaf.numel() * leaf.element_size() // n
    return total

