"""Logical-axis sharding rules, the port's mesh and placements
(``repro.distributed.api``'s counterpart).

Model and launch code name a tensor's dimensions by logical axes
(``"batch"``, ``"heads"``, ``"fsdp"`` ...); a rules context
(:func:`logical_rules`) maps them onto the axes of a :class:`Mesh`.
:func:`spec_for` resolves a shape against the rules with the reference's
divisibility fallback: a logical axis keeps only the mesh axes whose sizes
divide the dimension, skipping axes another dimension already took, so
the same rules serve every (architecture x shape x mesh) cell.

The port has no global-array type: a process holds whole tensors on its
devices.  :class:`Mesh` is a numpy array of ``torch.device`` with axis
names and a ``shape`` dict, as the reference's mesh reads; a
:class:`PartitionSpec` is a tuple (``tuple(jax_spec) == port_spec``
compares the two packages' specs), and :class:`NamedSharding` places a
whole tensor on the mesh's device for this process (:func:`place`).
:func:`constrain` resolves its spec (so a bad name raises, as in the
reference) and returns the tensor itself: eager PyTorch has no sharding
constraint to record.

A mesh may name one device more than once (``subgrid_mesh(8,
devices=["cpu"] * 8)``): several shards on one device, each drained on its
own stream by ``ShardedAggregationExecutor``.  That is the port's stand-in
for XLA's forced host devices, on the CPU and on a one-card machine.

:func:`process_group` opens a ``torch.distributed`` group whose backend
follows the device the caller asked for: ``nccl`` on the card, ``gloo`` on
the CPU.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

AxisSpec = Union[None, str, Tuple[str, ...]]

# The reference's default logical rules: "pod" and "data" form the DP/FSDP
# domain, "model" the TP/EP domain.
DEFAULT_RULES: Dict[str, AxisSpec] = {
    "batch": ("pod", "data"),
    "tokens": ("pod", "data"),    # flattened batch*seq (MoE dispatch)
    "seq": None,                  # activations inside a block
    "seq_sp": ("model",),         # residual stream between blocks
    "kv_seq": None,
    "embed": None,
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "fsdp": ("pod", "data"),      # parameter sharding domain (ZeRO-3)
    "tp": ("model",),
    "subgrid": ("pod", "data"),   # hydro: sub-grids distribute like batch
    "capacity": ("model",),       # expert-capacity rows
    "state": None,
    "replicated": None,
}


class PartitionSpec(tuple):
    """One entry per dimension: None (replicated), a mesh axis name, or a
    tuple of them."""

    def __new__(cls, *parts: AxisSpec):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """``devices``: an array of ``torch.device`` shaped by the mesh's axes
    (``axis_names``); ``shape`` maps each axis to its size."""

    def __init__(self, devices, axis_names: Sequence[str]):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(src.shape):
            arr[idx] = torch.device(src[idx])
        if arr.ndim != len(axis_names):
            raise ValueError(f"{arr.ndim}-d devices for axes {axis_names}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, arr.shape))

    @classmethod
    def abstract(cls, shape: Sequence[int], axis_names: Sequence[str]
                 ) -> "Mesh":
        """A mesh of ``shape`` over placeholder (meta) devices: for specs
        and sizing of a mesh that does not exist here."""
        devs = np.empty(tuple(shape), dtype=object)
        devs.fill(torch.device("meta"))
        return cls(devs, axis_names)

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def device_list(self) -> Tuple[torch.device, ...]:
        """The devices in row-major (shard) order."""
        return tuple(self.devices.flat)

    @property
    def local_device(self) -> torch.device:
        """This process's device: the one at its rank when a process group
        spans the mesh, else the mesh's first."""
        devs = self.device_list
        if (torch.distributed.is_available()
                and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() == len(devs)):
            return devs[torch.distributed.get_rank()]
        return devs[0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {sorted(set(map(str, self.devices.flat)))})"


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh.  The whole tensor is placed on the mesh's device
    for this process (:attr:`Mesh.local_device`)."""
    mesh: Mesh
    spec: PartitionSpec = field(default_factory=PartitionSpec)

    @property
    def device(self) -> torch.device:
        return self.mesh.local_device


def place(x, where) -> torch.Tensor:
    """``x`` (a tensor or a numpy array) on ``where``: a device, a device
    string or a :class:`NamedSharding`."""
    dev = where.device if isinstance(where, NamedSharding) \
        else torch.device(where)
    if isinstance(x, torch.Tensor):
        return x.detach().to(dev)
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a tree of dicts, tuples and lists (and
    the matching leaves of ``rest``); ``None`` is an empty subtree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree,
                                                          PartitionSpec):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


@dataclass
class ShardingRules:
    mesh: Optional[Mesh] = None
    rules: Dict[str, AxisSpec] = field(
        default_factory=lambda: dict(DEFAULT_RULES))

    def axis_size(self, spec: AxisSpec) -> int:
        if spec is None or self.mesh is None:
            return 1
        names = (spec,) if isinstance(spec, str) else spec
        n = 1
        for a in names:
            n *= self.mesh.shape.get(a, 1)
        return n


_tls = threading.local()


def current_rules() -> Optional[ShardingRules]:
    return getattr(_tls, "rules", None)


@contextlib.contextmanager
def logical_rules(mesh, overrides: Optional[Dict[str, AxisSpec]] = None
                  ) -> Iterator[ShardingRules]:
    """Install ``DEFAULT_RULES`` (updated by ``overrides``) against
    ``mesh`` (anything with a ``shape`` dict) for this thread."""
    prev = current_rules()
    r = ShardingRules(mesh=mesh)
    if overrides:
        r.rules.update(overrides)
    _tls.rules = r
    try:
        yield r
    finally:
        _tls.rules = prev


def _resolve(ctx: ShardingRules, dim_size: int, name: Optional[str],
             used: set) -> AxisSpec:
    """The longest run of the rule's mesh axes, not used by another
    dimension and of size > 1, whose product divides ``dim_size``."""
    if name is None:
        return None
    spec = ctx.rules.get(name)
    if spec is None:
        return None
    names = (spec,) if isinstance(spec, str) else tuple(spec)
    kept = []
    prod = 1
    for a in names:
        if a in used:
            continue
        sz = ctx.mesh.shape.get(a, 1) if ctx.mesh else 1
        if sz == 1:
            continue
        if dim_size % (prod * sz) == 0:
            kept.append(a)
            prod *= sz
    if not kept:
        return None
    return tuple(kept) if len(kept) > 1 else kept[0]


def spec_for(shape: Sequence[int], names: Sequence[Optional[str]]
             ) -> PartitionSpec:
    """The spec of a tensor of ``shape`` whose dimensions carry the
    logical ``names``, under the current rules."""
    ctx = current_rules()
    assert ctx is not None
    assert len(shape) == len(names), (shape, names)
    used: set = set()
    out = []
    for d, n in zip(shape, names):
        s = _resolve(ctx, d, n, used)
        if s is not None:
            used.update((s,) if isinstance(s, str) else s)
        out.append(s)
    return PartitionSpec(*out)


def visible_devices(device: DeviceLike = None) -> Tuple[torch.device, ...]:
    """The devices a mesh over ``device``'s kind can take: every visible
    card, ``device``'s first, for a CUDA device (the card unless
    ``device="cpu"``; raises without one); ``device`` alone otherwise."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return (dev,)
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return (dev,) + tuple(c for c in cards if c != dev)


def subgrid_mesh(n_devices: int = 0, *, pod: int = 1,
                 devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """Mesh over the logical ``"subgrid"`` axes ``("pod", "data")``: the
    first ``n_devices`` of ``devices`` (default: every visible card), 0
    taking them all; ``pod`` > 1 splits the inter-pod axis off and must
    divide the count.  ``devices`` may repeat a device (module
    docstring)."""
    devs = [torch.device(d) for d in (devices if devices is not None
                                      else visible_devices())]
    n = n_devices or len(devs)
    if not 1 <= n <= len(devs):
        raise ValueError(f"n_devices={n} outside 1..{len(devs)}")
    if n % pod:
        raise ValueError(f"pod={pod} does not divide n_devices={n}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr.reshape(pod, n // pod), ("pod", "data"))


def constrain(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """``x`` itself; under rules with a mesh its spec is resolved first,
    so a rank mismatch raises as in the reference."""
    ctx = current_rules()
    if ctx is None or ctx.mesh is None:
        return x
    spec_for(x.shape, names)
    return x


@contextlib.contextmanager
def process_group(rank: int, world_size: int, *, device: DeviceLike = None,
                  store_path: Optional[str] = None,
                  init_method: Optional[str] = None,
                  timeout_s: float = 120.0):
    """The default ``torch.distributed`` group for the block, destroyed
    after it: backend ``nccl`` on the card, ``gloo`` on the CPU
    (``device``: the card unless ``device="cpu"``), rendezvous through a
    ``FileStore`` at ``store_path`` or ``init_method``
    (``tcp://localhost:<port>``).  Yields the group's device for this
    rank."""
    import torch.distributed as dist

    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kw: Dict[str, Any] = dict(backend=backend, rank=rank,
                              world_size=world_size,
                              timeout=timedelta(seconds=timeout_s))
    if store_path is not None:
        kw["store"] = dist.FileStore(store_path, world_size)
    else:
        kw["init_method"] = init_method
    if backend == "nccl":
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(**kw)
    try:
        yield dev
    finally:
        dist.destroy_process_group()
