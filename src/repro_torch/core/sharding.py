"""Sharded aggregation over a mesh and multi-tenant batching (DESIGN.md
§15).

:class:`ShardedAggregationExecutor` is the ``s4`` strategy's executor with
the reference's surface (``register``, ``submit``, ``submit_range``,
``flush``, ``warmup``, ``save_tuning``, the breaker states and the
``mesh`` / ``n_shards`` / ``shard_occupancy`` / ``backend_key`` stats).
It partitions each range over a ``("pod", "data")`` mesh
(``repro_torch.distributed.api.subgrid_mesh``; without ``mesh=``,
``config.shard_devices`` of the visible cards, 0 taking them all).  A
range of ``count`` tasks over ``S`` shards drains as the reference's
wave does::

    local  = count // S     # shard i takes tasks [i local, (i+1) local)
    n_even = local * S      # one program: every shard the same ladder
    rem    = count - n_even # one program on the primary device

Each shard drains its tasks through the greedy bucket ladder, every bucket
one launch of the family's body written through its ``out=`` into its
slice of the range's output, on its own stream (on the card).  A task's
result therefore does not depend on the shard or the bucket, and ``s4``
equals ``fused``, ``s3`` and ``mixed`` bit for bit.  The remainder drains
unsharded on the primary device (the mesh's first).

When every shard lies on one device (one card, or a mesh that repeats a
device: the port's stand-in for XLA's forced host devices) the shards
write their slices of ONE output: a whole range's result is that output,
with no copy.  Over several cards each card drains its shards into an
output of its own, copying its inputs onto itself first, and the drain
copies the shards back onto the primary card in shard order (the
reference's all-gather at ``ghost_gather``); ``stats["scatter_copies"]``
and ``stats["gather_copies"]`` count those copies (0 on one device).
``halo_exchange`` rolls shard blocks one step along a mesh axis (the
reference's ``ppermute`` ring).

Each drain is one program of the region's table ``compiled``, under the
reference's keys ``("shard", local, key)`` and ``("rem", count, key)``
(``key`` the arguments' shapes and dtypes), launched on the next
``ExecutorPool`` stream.  On the card a program is one CUDA graph per
input set on its device (:class:`~repro_torch.core.graphs.BucketProgram`):
the ``TenantBatcher``'s captured extract hands it outputs that keep their
address (``submit_range(fixed=True)``), any other range is copied into the
region's static inputs for its key first.  Every breaker reports closed,
and host staging is refused; under ``guard="finite"`` a non-finite row
fails exactly its task and the others are fulfilled from the same output.

:class:`TenantBatcher` funnels many independent scenario instances
("tenants") through one executor's waves: per RK stage, every tenant's
populations are grouped by kernel family into one range per family, so a
stage is one merged wave whatever the tenant count, and each tenant's
result equals its solo run bit for bit (same bodies, no padding).  The
phases around the wave (``extract``: every tenant's parents, concatenated
per family; ``assemble``: each tenant's outputs sliced back and
assembled) are one CUDA graph each on the card
(:class:`~repro_torch.core.graphs.CapturedCall`), cached per tenant set
and state shapes, and the same closures run eagerly on the CPU.  A
population that syncs with the host cannot be captured: the batcher then
takes the eager per-tenant path for good, counted in
``stats["eager_fallbacks"]``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import AggregationConfig
from repro_torch.core.aggregation import (
    RangeFuture, TaskFuture, TaskSignature, _device_key, _out_like,
    gather_futures, greedy_decomposition,
)
from repro_torch.core import graphs
from repro_torch.core.executor import ExecutorPool
from repro_torch.core.faults import (
    FaultInjector, TaskFailedError, poison_slots,
)
from repro_torch.core.graphs import CaptureError, CapturedCall
from repro_torch.device import DeviceLike
from repro_torch.distributed.api import (
    DEFAULT_RULES, Mesh, subgrid_mesh, visible_devices,
)

# the logical axes a task range distributes over
SUBGRID_AXES: Tuple[str, ...] = tuple(DEFAULT_RULES["subgrid"])


def _dtype_str(dtype: torch.dtype) -> str:
    """numpy's ``dtype.str`` of a torch dtype, as the reference's argument
    keys spell it (bfloat16, which numpy lacks, as JAX's ``"<V2"``)."""
    try:
        return np.dtype(str(dtype).replace("torch.", "")).str
    except TypeError:
        return "<V2"


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


class _ShardRegion:
    """One kernel family's lane: ladder, queued ranges and per-task
    submissions, its drain programs (``compiled``) with the static inputs
    they read and the streams they spread over, and the stats keys the
    reference publishes."""

    __slots__ = ("signature", "kernel", "batched_fn", "ladder", "queue",
                 "singles", "waves", "stats", "compiled", "statics",
                 "_readers", "streams")

    def __init__(self, signature: TaskSignature, batched_fn: Callable,
                 ladder: Tuple[int, ...]):
        self.signature = signature
        self.kernel = signature.kernel
        self.batched_fn = batched_fn
        self.ladder = ladder
        self.queue: List[_ShardPending] = []
        self.singles: List[Tuple[TaskFuture, Tuple[torch.Tensor, ...]]] = []
        self.waves = 0
        self.compiled: Dict[Tuple, Callable] = {}
        # key -> the static inputs of a range that does not keep its
        # address, and the events of the launches reading them
        self.statics: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}
        self._readers: Dict[Tuple, List[Any]] = {}
        # (device, kind) -> the drains' streams there (the card)
        self.streams: Dict[Tuple, List[Any]] = {}
        self.stats: Dict[str, Any] = {
            "submitted": 0, "launches": 0, "sharded_launches": 0,
            "remainder_launches": 0, "aggregated_hist": {},
            "ladder": list(ladder), "shard_occupancy": [],
            "breaker": "closed", "measurement_launches": 0,
            "faults": {"injected": 0, "trips": 0, "isolated": 0},
        }


class _ShardPending:
    """One queued contiguous range (per-task submissions are stacked into
    one at flush; ``singles`` are their futures)."""

    __slots__ = ("future", "parents", "start", "count", "wave_base",
                 "singles", "fixed")

    def __init__(self, future: RangeFuture,
                 parents: Tuple[torch.Tensor, ...], start: int, count: int,
                 singles: Optional[List[TaskFuture]] = None,
                 fixed: bool = False):
        self.future = future
        self.parents = parents
        self.start = start
        self.count = count
        self.wave_base = 0          # wave-relative id of task 0 (at flush)
        self.singles = singles
        self.fixed = fixed          # the parents keep their address


class _ShardLaunch:
    """One drained range awaiting its audit and fulfilment."""

    __slots__ = ("region", "entry", "out", "off", "n", "wave")

    def __init__(self, region, entry, out, off, n, wave):
        self.region = region
        self.entry = entry
        self.out = out              # tasks [off, off + n) of the range
        self.off = off
        self.n = n
        self.wave = wave


class _MeshDrain:
    """The shards' drain over several devices: each device's program
    drains its shards (their rows copied onto it: the programs' inputs
    are copied in), and the outputs are copied onto the primary device in
    shard order, counted in the executor's stats."""

    def __init__(self, parts, local: int, primary: torch.device,
                 stats: Dict[str, Any]):
        self.parts = parts          # (device, shard indices, program)
        self.local = local
        self.primary = primary
        self.stats = stats

    def __call__(self, *args):
        local = self.local
        pieces = []
        for dev, shards, program in self.parts:
            rows = tuple(torch.cat([a.narrow(0, i * local, local)
                                    for i in shards])
                         if len(shards) > 1 else a.narrow(0, shards[0] * local,
                                                          local)
                         for a in args)
            self.stats["scatter_copies"] += len(shards)
            pieces.append((shards, program(*rows)))
        first = pieces[0][1]
        out = torch.empty((args[0].shape[0],) + tuple(first.shape[1:]),
                          dtype=first.dtype, device=self.primary)
        for shards, part in pieces:
            for j, i in enumerate(shards):
                out.narrow(0, i * local, local).copy_(
                    part.narrow(0, j * local, local))
            self.stats["gather_copies"] += len(shards)
        return out


class ShardedAggregationExecutor:
    """The ``s4`` executor over ``mesh`` (default: ``subgrid_mesh`` of
    ``config.shard_devices`` cards visible beside ``device``); takes the
    ``AggregationExecutor`` constructor (``timer`` is accepted and unused:
    nothing here is measured)."""

    def __init__(self, batched_fn: Optional[Callable] = None,
                 config: Optional[AggregationConfig] = None,
                 pool: Optional[ExecutorPool] = None, name: str = "region",
                 device: DeviceLike = None,
                 timer: Optional[Callable] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 mesh: Optional[Mesh] = None):
        self.name = name
        self.config = config or AggregationConfig()
        if self.config.staging == "host":
            raise ValueError(
                "ShardedAggregationExecutor requires staging='device' — "
                "host staging re-serializes the per-task loop the sharded "
                "drain exists to remove")
        self.mesh = mesh if mesh is not None else subgrid_mesh(
            self.config.shard_devices, devices=visible_devices(device))
        self._shards = self.mesh.device_list
        self.n_shards = len(self._shards)
        self.device = self._shards[0]            # the primary device
        # the mesh's devices, the primary first, with their shards
        self._groups: List[Tuple[torch.device, List[int]]] = []
        for i, d in enumerate(self._shards):
            for dev, idx in self._groups:
                if dev == d:
                    idx.append(i)
                    break
            else:
                self._groups.append((d, [i]))
        self.pool = pool or ExecutorPool(self.config.n_executors,
                                         device=self.device)
        # the drain programs are graphs, which read fixed inputs
        self._graphs = isinstance(graphs.make_program(self.flush,
                                                      self.device),
                                  graphs.BucketProgram)
        self._buckets = tuple(sorted(self.config.bucket_sizes()))
        self._guard = self.config.guard
        self._injector = fault_injector
        self._bodies: Dict[str, Callable] = {}
        self._regions: Dict[TaskSignature, _ShardRegion] = {}
        self._default_kernel: Optional[str] = None
        kind, dev_name, _ = _device_key(self.device)
        self.stats: Dict[str, Any] = {
            "submitted": 0, "launches": 0, "aggregated_hist": {},
            "staging_s": 0.0, "regions": {}, "warm_start": False,
            "captures": 0, "graph_bytes": 0,
            "scatter_copies": 0, "gather_copies": 0,
            "flush_policy": "eager",
            "backend_key": (kind, dev_name or kind, f"d{self.n_shards}"),
            "mesh": dict(self.mesh.shape),
            "n_shards": self.n_shards,
            "shard_occupancy": [0] * self.n_shards,
        }
        if batched_fn is not None:
            self.register(name, batched_fn)

    # -- region registry ---------------------------------------------------
    def register(self, kernel: str, batched_fn: Callable,
                 default: bool = False) -> str:
        """Register a family's batched body (one body per kernel id)."""
        if kernel in self._bodies and self._bodies[kernel] is not batched_fn:
            raise ValueError(
                f"kernel {kernel!r} already registered with a different body")
        self._bodies[kernel] = batched_fn
        if default or self._default_kernel is None:
            self._default_kernel = kernel
        return kernel

    def set_fault_injector(self,
                           injector: Optional[FaultInjector]) -> None:
        self._injector = injector

    def _resolve_kernel(self, kernel: Optional[str]) -> str:
        k = kernel or self._default_kernel
        if k is None or k not in self._bodies:
            raise KeyError(f"unknown kernel family {k!r} — register() it "
                           f"before submitting")
        return k

    def _region(self, sig: TaskSignature) -> _ShardRegion:
        region = self._regions.get(sig)
        if region is None:
            region = _ShardRegion(sig, self._bodies[sig.kernel],
                                  self._buckets)
            self._regions[sig] = region
            self.stats["regions"][sig.describe()] = region.stats
        return region

    @property
    def regions(self) -> Dict[TaskSignature, _ShardRegion]:
        return dict(self._regions)

    # each range is read where its tenancy keeps it
    # (``submit_range(fixed=True)``) or staged here: no population is
    # written into this executor's buffers
    writes_in_place = False

    # -- submission --------------------------------------------------------
    def submit_range(self, parents: Tuple[torch.Tensor, ...], start: int,
                     n: int, kernel: Optional[str] = None, *,
                     fixed: bool = False) -> RangeFuture:
        """Tasks ``start .. start+n-1`` of device-resident ``parents`` as
        one range.  ``fixed``: the parents keep their address and are not
        written while the range drains (a captured extract's outputs), so
        the drain program reads them in place."""
        kernel = self._resolve_kernel(kernel)
        if n < 1:
            raise ValueError(f"range of {n} tasks — need at least 1")
        limit = min(p.shape[0] for p in parents)
        if not 0 <= start <= limit - n:
            raise IndexError(f"range [{start}, {start + n}) outside parent "
                             f"task axis of length {limit}")
        region = self._region(TaskSignature(kernel, tuple(
            (tuple(p.shape[1:]), str(p.dtype)) for p in parents)))
        fut = RangeFuture(n)
        region.queue.append(_ShardPending(fut, tuple(parents), start, n,
                                          fixed=fixed))
        region.stats["submitted"] += n
        self.stats["submitted"] += n
        return fut

    def submit(self, *args: torch.Tensor,
               kernel: Optional[str] = None) -> TaskFuture:
        """One task of per-task tensors, stacked with the region's other
        single tasks into one range at flush."""
        kernel = self._resolve_kernel(kernel)
        region = self._region(TaskSignature.from_args(kernel, args))
        fut = TaskFuture()
        region.singles.append((fut, tuple(a.to(self.device) for a in args)))
        region.stats["submitted"] += 1
        self.stats["submitted"] += 1
        return fut

    # -- flush: dispatch everything, then settle ---------------------------
    def flush(self) -> None:
        """Drain every region's ranges (dispatch all, then make the
        caller's stream wait for every executor), then audit and fulfil
        them: injection, the guard, the futures."""
        recs: List[_ShardLaunch] = []
        for region in self._regions.values():
            if region.singles:
                self._pack_singles(region)
            if not region.queue:
                continue
            cursor = 0
            occupancy = [0] * self.n_shards
            for entry in region.queue:
                entry.wave_base = cursor
                cursor += entry.count
                recs.extend(self._dispatch(region, entry, occupancy))
            region.queue = []
            region.stats["shard_occupancy"] = occupancy
            self.stats["shard_occupancy"] = occupancy
            region.waves += 1
        self.pool.join()
        for rec in recs:
            self._settle(rec)

    def _pack_singles(self, region: _ShardRegion) -> None:
        singles, region.singles = region.singles, []
        futs = [f for f, _ in singles]
        parents = tuple(torch.stack(col)
                        for col in zip(*(a for _, a in singles)))
        region.queue.append(_ShardPending(RangeFuture(len(futs)), parents,
                                          0, len(futs), singles=futs))

    # -- the drain programs ------------------------------------------------
    @staticmethod
    def _arg_key(args: Sequence[torch.Tensor]) -> Tuple:
        """The arguments' shapes and dtypes, as the reference keys its
        drain programs."""
        return tuple((tuple(a.shape), _dtype_str(a.dtype)) for a in args)

    @property
    def _spread(self) -> bool:
        """The shards lie on several devices."""
        return len(self._groups) > 1

    def _sharded_fn(self, region: _ShardRegion, local: int,
                    args: Sequence[torch.Tensor]) -> Callable:
        """The program that drains ``local`` tasks of every shard through
        the greedy bucket sequence."""
        key = ("shard", local, self._arg_key(args))
        fn = region.compiled.get(key)
        if fn is None:
            if self._spread:
                fn = _MeshDrain([(dev, idx, self._drain_program(
                    region, local, len(idx), dev, copy_in="all"))
                    for dev, idx in self._groups], local, self.device,
                    self.stats)
            else:
                fn = self._drain_program(region, local, self.n_shards,
                                         self.device)
            region.compiled[key] = fn
        return fn

    def _chunked_fn(self, region: _ShardRegion, count: int,
                    args: Sequence[torch.Tensor]) -> Callable:
        """The remainder's program (fewer tasks than shards): the same
        greedy drain on the primary device."""
        key = ("rem", count, self._arg_key(args))
        fn = region.compiled.get(key)
        if fn is None:
            fn = region.compiled[key] = self._drain_program(
                region, count, 1, self.device)
        return fn

    def _streams(self, region: _ShardRegion, device: torch.device,
                 kind: str, n: int) -> List[Any]:
        if device.type != "cuda" or n < 2:
            return []
        got = region.streams.get((device, kind))
        if got is None:
            got = region.streams[(device, kind)] = [
                torch.cuda.Stream(device) for _ in range(n)]
        return got

    def _drain_program(self, region: _ShardRegion, local: int, shards: int,
                       device: torch.device, copy_in: Any = ()) -> Callable:
        """``(*args) -> out`` for ``shards * local`` tasks on ``device``:
        shard ``i`` drains rows ``[i local, (i+1) local)`` through the
        greedy decomposition of ``local``, each bucket the body written
        into its slice of one output.  On the card the shards fork over
        streams of their own and join back (one shard alone spreads its
        buckets over one stream per pool stream), so a captured drain
        keeps them concurrent; a
        :class:`~repro_torch.core.graphs.BucketProgram` there."""
        chunks = greedy_decomposition(local, region.ladder)
        body = region.batched_fn
        work = [(i, j, i * local + sum(chunks[:j]), b)
                for i in range(shards) for j, b in enumerate(chunks)]
        if shards > 1:
            streams = self._streams(region, device, "shard", shards)
            lane = [i for i, _, _, _ in work]
        else:
            streams = self._streams(region, device, "bucket", len(self.pool))
            lane = [j for _, j, _, _ in work]

        def drain(*args):
            out = _out_like(body, args)
            caller = (torch.cuda.current_stream(device)
                      if streams and len(work) > 1 else None)
            used = []
            for (_, _, s, b), k in zip(work, lane):
                part = tuple(a.narrow(0, s, b) for a in args)
                dst = out.narrow(0, s, b)
                if caller is None:
                    body(*part, out=dst)
                    continue
                st = streams[k % len(streams)]
                if st not in used:
                    st.wait_stream(caller)
                    used.append(st)
                with torch.cuda.stream(st):
                    body(*part, out=dst)
            for st in used:
                caller.wait_stream(st)
            return out

        return graphs.make_program(drain, device, copy_in=copy_in,
                                   stats=self.stats)

    def _inputs(self, region: _ShardRegion, entry: _ShardPending, start: int,
                n: int, copied: bool
                ) -> Tuple[Tuple[torch.Tensor, ...], Optional[Tuple]]:
        """A launch's arguments: tasks ``[start, start + n)`` of the
        range's parents, in place when they keep their address, when the
        program copies its inputs in (``copied``) or off the card, else
        copied into the region's static inputs for their key (after every
        launch still reading them); and that key (None when read in
        place)."""
        args = tuple(p if start == 0 and p.shape[0] == n
                     else p.narrow(0, start, n) for p in entry.parents)
        if not self._graphs or copied or (
                entry.fixed and all(a is p for a, p in
                                    zip(args, entry.parents))):
            return args, None
        key = self._arg_key(args)
        statics = region.statics.get(key)
        if statics is None:
            statics = region.statics[key] = tuple(
                torch.empty_like(a) for a in args)
        for event in region._readers.pop(key, []):
            torch.cuda.current_stream(self.device).wait_event(event)
        for dst, a in zip(statics, args):
            dst.copy_(a, non_blocking=True)
        return statics, key

    def _dispatch(self, region: _ShardRegion, entry: _ShardPending,
                  occupancy: List[int]) -> List[_ShardLaunch]:
        """One range, as the reference splits it: the shards' even share
        through ``("shard", local, key)``, the rest through
        ``("rem", count, key)``; each one launch of its program on the
        next executor stream (counted as its bucket launches)."""
        recs = []
        local = entry.count // self.n_shards
        n_even = local * self.n_shards
        rem = entry.count - n_even
        for off, n, tag in ((0, n_even, "sharded_launches"),
                            (n_even, rem, "remainder_launches")):
            if not n:
                continue
            sharded = tag == "sharded_launches"
            args, key = self._inputs(region, entry, entry.start + off, n,
                                     copied=sharded and self._spread)
            if sharded:
                fn = self._sharded_fn(region, local, args)
                chunks = greedy_decomposition(local, region.ladder) \
                    * self.n_shards
            else:
                fn = self._chunked_fn(region, n, args)
                chunks = greedy_decomposition(n, region.ladder)
            ex = self.pool.get()
            out = ex.launch(fn, *args, family=region.kernel,
                            count=len(chunks))
            if key is not None and ex.last_event is not None:
                region._readers.setdefault(key, []).append(ex.last_event)
            recs.append(_ShardLaunch(region, entry, out, off, n,
                                     region.waves))
            hist = region.stats["aggregated_hist"]
            ghist = self.stats["aggregated_hist"]
            for b in chunks:
                hist[b] = hist.get(b, 0) + 1
                ghist[b] = ghist.get(b, 0) + 1
            region.stats["launches"] += len(chunks)
            self.stats["launches"] += len(chunks)
            region.stats[tag] += 1
            if sharded:
                for i in range(self.n_shards):
                    occupancy[i] += local
            else:
                occupancy[0] += n     # the remainder runs on the primary
        return recs

    def _settle(self, rec: _ShardLaunch) -> None:
        region, entry, out = rec.region, rec.entry, rec.out
        n, off = rec.n, rec.off
        if self._injector is not None:
            hits = self._injector.poison_positions(
                region.kernel, rec.wave,
                [entry.wave_base + off + i for i in range(n)])
            if hits:
                poison_slots(out, sorted(hits), hits, inplace=True)
                region.stats["faults"]["injected"] += len(hits)
        if self._guard == "finite":
            bad = self._nonfinite_rows(out, n)
            if bad:
                region.stats["faults"]["trips"] += 1
                region.stats["faults"]["isolated"] += len(bad)
                self._fulfil_with_failures(rec, bad)
                return
        entry.future._fulfil_range(out, 0, off, n)
        if entry.singles is not None:
            for i in range(n):
                entry.singles[off + i]._fulfil(out, i)

    @staticmethod
    def _nonfinite_rows(out: torch.Tensor, n: int) -> List[int]:
        """The rows of ``out`` holding a non-finite value (one host
        read)."""
        if not (out.is_floating_point() or out.is_complex()):
            return []
        ok = torch.isfinite(out.reshape(n, -1)).all(dim=1)
        return [int(i) for i in torch.nonzero(~ok).flatten().tolist()]

    def _fulfil_with_failures(self, rec: _ShardLaunch,
                              bad: List[int]) -> None:
        """The guard names the bad rows exactly (tasks are independent):
        they fail one by one, and the survivors are fulfilled as
        contiguous runs of the same output."""
        region, entry, out = rec.region, rec.entry, rec.out
        fut, n, off = entry.future, rec.n, rec.off
        bad_set = set(bad)
        for i in bad:
            wave_id = entry.wave_base + off + i
            err = TaskFailedError(
                f"non-finite output in family {region.kernel!r} "
                f"(sharded wave {rec.wave}, task {wave_id})",
                task_ids=[wave_id], kernel=region.kernel)
            fut._fail_range(off + i, 1, err)
            if entry.singles is not None:
                entry.singles[off + i]._fail(err)
        run_start = None
        for i in range(n + 1):
            if i < n and i not in bad_set:
                if run_start is None:
                    run_start = i
                continue
            if run_start is not None:
                fut._fulfil_range(out, run_start, off + run_start,
                                  i - run_start)
                if entry.singles is not None:
                    for j in range(run_start, i):
                        entry.singles[off + j]._fulfil(out, j)
                run_start = None

    # -- the reference's collectives ---------------------------------------
    def ghost_gather(self, x: Any) -> Any:
        """Replicate a sharded wave output onto the primary device: a
        drained range is already whole there (the drain gathered it), so
        only a tensor elsewhere is copied, and counted."""
        if not isinstance(x, torch.Tensor) or _same_device(x.device,
                                                           self.device):
            return x
        self.stats["gather_copies"] += 1
        return x.to(self.device)

    def halo_exchange(self, x: torch.Tensor,
                      axis_name: str = "data") -> torch.Tensor:
        """Roll ``x``'s shard blocks (its leading axis cut into one block
        per shard, in shard order) one step around ``axis_name``'s ring:
        the reference's ``ppermute`` of shard ``i`` to shard ``i + 1``
        along that axis.  On a one-shard axis every block stays where it
        is: ``x`` itself."""
        if axis_name not in self.mesh.shape:
            raise KeyError(f"no mesh axis {axis_name!r} (have "
                           f"{self.mesh.axis_names})")
        if self.mesh.shape[axis_name] == 1:
            return x
        if x.shape[0] % self.n_shards:
            raise ValueError(f"{x.shape[0]} rows do not split into "
                             f"{self.n_shards} shard blocks")
        grid = tuple(self.mesh.shape[a] for a in self.mesh.axis_names)
        blocks = x.reshape(grid + (x.shape[0] // self.n_shards,)
                           + tuple(x.shape[1:]))
        return torch.roll(blocks, 1, dims=self.mesh.axis_names.index(
            axis_name)).reshape(x.shape)

    # -- runner protocol ---------------------------------------------------
    def warmup(self, parent_shapes: Sequence[Tuple[Tuple[int, ...],
                                                   torch.dtype]], *,
               kernel: Optional[str] = None,
               buckets: Optional[Sequence[int]] = None,
               store: Optional[Any] = None) -> None:
        """Drain one throwaway wave of ones at the given parent shapes
        (builds the kernels, pays first-launch costs and, on the card,
        captures the drain program over the region's static inputs for
        these shapes), with the guard and the injector off.  ``buckets``
        and ``store`` are accepted for the runner's protocol: nothing here
        is tuned."""
        kernel = self._resolve_kernel(kernel)
        parents = tuple(torch.ones(shape, dtype=dtype, device=self.device)
                        for shape, dtype in parent_shapes)
        guard, injector = self._guard, self._injector
        self._guard, self._injector = "off", None
        try:
            fut = self.submit_range(parents, 0, parents[0].shape[0],
                                    kernel=kernel)
            self.flush()
            fut.result()
        finally:
            self._guard, self._injector = guard, injector
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def save_tuning(self, store: Optional[Any] = None) -> Optional[str]:
        return None                     # no measured state to persist

    def breaker_state(self, kernel: str) -> str:
        return "closed"

    def breaker_states(self) -> Dict[str, str]:
        return {r.kernel: "closed" for r in self._regions.values()}


# ---------------------------------------------------------------------------
# multi-tenant batching
# ---------------------------------------------------------------------------

def _leaves(state) -> Tuple[torch.Tensor, ...]:
    return state if isinstance(state, tuple) else (state,)


def _like(template, leaves):
    return tuple(leaves) if isinstance(template, tuple) else leaves[0]


def _scale_all(xs: Dict[Any, Any], cs) -> Dict[Any, Any]:
    """{tid: c_tid * x_tid} over every tenant's tensors, one
    ``torch._foreach_mul`` per distinct scalar (``cs``: one scalar, or one
    per tenant; a float or a 0-dim tensor)."""
    groups: Dict[Any, Tuple[Any, List[Tuple[Any, int]],
                            List[torch.Tensor]]] = {}
    for tid, x in xs.items():
        c = cs[tid] if isinstance(cs, dict) else cs
        key = id(c) if isinstance(c, torch.Tensor) else ("value", c)
        g = groups.setdefault(key, (c, [], []))
        for i, leaf in enumerate(_leaves(x)):
            g[1].append((tid, i))
            g[2].append(leaf)
    out = {tid: list(_leaves(x)) for tid, x in xs.items()}
    for c, where, tensors in groups.values():
        for (tid, i), y in zip(where, torch._foreach_mul(tensors, c)):
            out[tid][i] = y
    return {tid: _like(xs[tid], leaves) for tid, leaves in out.items()}


def _add_all(xs: Dict[Any, Any], ys: Dict[Any, Any]) -> Dict[Any, Any]:
    """{tid: x_tid + y_tid} over every tenant's tensors, one
    ``torch._foreach_add`` (no ``alpha``: each sum rounds once, as the
    solo runner's ``+`` does)."""
    tids = list(xs)
    a = [leaf for t in tids for leaf in _leaves(xs[t])]
    b = [leaf for t in tids for leaf in _leaves(ys[t])]
    sums = iter(torch._foreach_add(a, b))
    return {t: _like(xs[t], [next(sums) for _ in _leaves(xs[t])])
            for t in tids}


class _Tenant:
    __slots__ = ("tid", "scenario", "state", "dt", "steps")

    def __init__(self, tid, scenario, state, dt):
        self.tid = tid
        self.scenario = scenario
        self.state = state
        self.dt = dt
        self.steps = 0


class _Layout:
    """One merged wave's layout: per kernel, in first-seen order, which
    tenant's population contributes which slice of the family's range,
    and each zero-task population's body and parents."""

    __slots__ = ("order", "groups", "contrib", "n_pops", "empty")

    def __init__(self, tenants: Dict[Any, _Tenant],
                 pops_by: Dict[Any, Sequence[Any]]):
        self.groups: Dict[str, Dict[str, Any]] = {}
        self.order: List[str] = []
        self.contrib: Dict[Tuple[Any, int], Tuple[str, int, int]] = {}
        self.empty: Dict[Tuple[Any, int], Tuple[Callable, Any]] = {}
        self.n_pops = {tid: len(pops) for tid, pops in pops_by.items()}
        for tid, pops in pops_by.items():
            for pi, pop in enumerate(pops):
                if not pop.n_tasks:
                    self.empty[(tid, pi)] = (tenants[tid].scenario.family(
                        pop.kernel).batched_body, pop.parents)
                    continue
                g = self.groups.get(pop.kernel)
                if g is None:
                    g = self.groups[pop.kernel] = {"slices": [], "total": 0}
                    self.order.append(pop.kernel)
                g["slices"].append((tid, pi, g["total"], pop.n_tasks))
                self.contrib[(tid, pi)] = (pop.kernel, g["total"],
                                           pop.n_tasks)
                g["total"] += pop.n_tasks

    def columns(self, pops_by: Dict[Any, Sequence[Any]]
                ) -> Dict[str, Tuple[torch.Tensor, ...]]:
        """Each family's parents, the tenants' concatenated in layout
        order."""
        out = {}
        for kernel in self.order:
            sl = self.groups[kernel]["slices"]
            per = zip(*[pops_by[tid][pi].parents for tid, pi, _, _ in sl])
            out[kernel] = tuple(c[0] if len(c) == 1 else torch.cat(c)
                                for c in per)
        return out

    def outputs(self, tid, batches: Dict[str, torch.Tensor]
                ) -> List[torch.Tensor]:
        """One tenant's per-population outputs, sliced from the families'
        batches (zeros of the body's shape for a zero-task population)."""
        touts = []
        for pi in range(self.n_pops[tid]):
            hit = self.contrib.get((tid, pi))
            if hit is None:
                touts.append(torch.zeros_like(
                    _out_like(*self.empty[(tid, pi)])))
                continue
            kernel, off, n = hit
            batch = batches[kernel]
            touts.append(batch if off == 0 and n == self.groups[kernel][
                "total"] else batch.narrow(0, off, n))
        return touts


class _Stage:
    """A merged wave's layout and its two phases (captured on the card,
    the layout's eager closures on the CPU)."""

    __slots__ = ("extract", "assemble", "layout")

    def __init__(self, extract, assemble, layout: _Layout):
        self.extract = extract
        self.assemble = assemble
        self.layout = layout


class TenantBatcher:
    """Many independent scenario instances through ONE executor's waves.

    Each tenant owns a scenario, a state and a dt; :meth:`rk3_step_all`
    advances every tenant one RK3 step in three merged waves (one per
    stage), whatever the tenant count, with the solo runner's Shu-Osher
    expressions, so a tenant's trajectory equals its solo run bit for
    bit.  ``queue_depths`` and ``shard_occupancy`` are what
    ``ServingEngine.healthz`` republishes under ``"tenants"``."""

    def __init__(self, executor: ShardedAggregationExecutor):
        self.executor = executor
        self._tenants: Dict[Any, _Tenant] = {}
        self.stats: Dict[str, Any] = {"waves": 0, "merged_tasks": 0,
                                      "max_tenancy": 0, "eager_fallbacks": 0}
        self._eager = False          # set when a population cannot capture
        self._stage_cache: Dict[Any, _Stage] = {}

    # -- tenancy -----------------------------------------------------------
    def add(self, tid, scenario, state, dt) -> None:
        if tid in self._tenants:
            raise ValueError(f"tenant {tid!r} already registered")
        for fam in scenario.families():
            self.executor.register(fam.kernel, fam.batched_body)
        self._tenants[tid] = _Tenant(tid, scenario, state, dt)
        self.stats["max_tenancy"] = max(self.stats["max_tenancy"],
                                        len(self._tenants))

    def remove(self, tid):
        return self._tenants.pop(tid).state

    def __len__(self) -> int:
        return len(self._tenants)

    def states(self) -> Dict[Any, Any]:
        return {tid: t.state for tid, t in self._tenants.items()}

    # -- observability -----------------------------------------------------
    def queue_depths(self) -> Dict[Any, int]:
        """Tasks each tenant contributes to the next wave."""
        return {tid: sum(p.n_tasks
                         for p in t.scenario.populations(t.state))
                for tid, t in self._tenants.items()}

    def shard_occupancy(self) -> List[int]:
        return list(self.executor.stats.get("shard_occupancy", []))

    def healthz(self) -> Dict[str, Any]:
        return {"count": len(self._tenants),
                "queue_depth": self.queue_depths(),
                "shard_occupancy": self.shard_occupancy()}

    # -- merged waves ------------------------------------------------------
    def _populations(self, states: Dict[Any, Any]) -> Dict[Any, Any]:
        return {tid: self._tenants[tid].scenario.populations(st)
                for tid, st in states.items()}

    def _assemble(self, layout: _Layout, states: Dict[Any, Any],
                  batches: Dict[str, torch.Tensor]) -> Dict[Any, Any]:
        return {tid: self._tenants[tid].scenario.assemble(
                    st, layout.outputs(tid, batches))
                for tid, st in states.items()}

    def _rhs_all(self, states: Dict[Any, Any]) -> Dict[Any, Any]:
        """One merged wave over every tenant: the staged path, or the
        eager one after a population failed to capture."""
        if not self._eager:
            try:
                stage = self._stage_for(states)
            except CaptureError:
                self._eager = True
                self.stats["eager_fallbacks"] += 1
            else:
                batches = self._drain(stage.layout, stage.extract(states),
                                      fixed=self.executor.device.type
                                      == "cuda")
                return stage.assemble(states, batches)
        pops_by = self._populations(states)
        layout = _Layout(self._tenants, pops_by)
        batches = self._drain(layout, layout.columns(pops_by))
        return self._assemble(layout, states, batches)

    def _drain(self, layout: _Layout, cols,
               fixed: bool = False) -> Dict[str, torch.Tensor]:
        """Submit one range per kernel, flush, gather each range (failed
        tasks named in tenant words).  ``fixed``: the columns are the
        captured extract's static outputs, read in place by the drain
        programs (the next extract replays on the caller's stream, which
        the flush has made wait for every launch)."""
        exe = self.executor
        futs = {}
        for kernel in layout.order:
            total = layout.groups[kernel]["total"]
            futs[kernel] = exe.submit_range(cols[kernel], 0, total,
                                            kernel=kernel, fixed=fixed)
            self.stats["merged_tasks"] += total
        exe.flush()
        self.stats["waves"] += 1
        batches = {}
        for kernel in layout.order:
            try:
                batches[kernel] = exe.ghost_gather(
                    gather_futures([futs[kernel]]))
            except TaskFailedError as err:
                what = self._describe_failed(layout.groups[kernel],
                                             err.task_ids)
                raise TaskFailedError(
                    f"{what} failed in merged tenant wave: {err}",
                    task_ids=err.task_ids, kernel=kernel) from err
        return batches

    # -- the staged wave: two phases, captured on the card -----------------
    @staticmethod
    def _stage_key(states: Dict[Any, Any]):
        return tuple((tid, tuple((tuple(u.shape), u.dtype)
                                 for u in _leaves(st)))
                     for tid, st in states.items())

    def _stage_for(self, states: Dict[Any, Any]) -> _Stage:
        key = self._stage_key(states)
        stage = self._stage_cache.get(key)
        if stage is None:
            stage = self._stage_cache[key] = self._build_stage(states)
        return stage

    def _build_stage(self, states: Dict[Any, Any]) -> _Stage:
        """A dry pass over ``populations`` fixes the wave's layout; the two
        phases then derive the same parents and outputs from any states of
        these shapes.  On the card each phase is captured as one CUDA
        graph here, before any launch of the wave, so a population that
        cannot be captured raises ``CaptureError`` first."""
        layout = _Layout(self._tenants, self._populations(states))

        def extract(states):
            return layout.columns(self._populations(states))

        def assemble(states, batches):
            return self._assemble(layout, states, batches)

        device = self.executor.device
        if device.type != "cuda":
            return _Stage(extract, assemble, layout)
        cols = extract(states)
        batch_specs = {}
        for kernel in layout.order:
            tid = layout.groups[kernel]["slices"][0][0]
            body = self._tenants[tid].scenario.family(kernel).batched_body
            batch_specs[kernel] = torch.zeros_like(
                _out_like(body, cols[kernel]))
        return _Stage(*_captured_phases(extract, assemble, states, cols,
                                        batch_specs, layout.order, device),
                      layout)

    def _describe_failed(self, group: Dict[str, Any],
                         task_ids: Sequence[int]) -> str:
        """Merged-range task ids in tenant words."""
        names = []
        for gid in task_ids:
            for tid, pi, off, n in group["slices"]:
                if off <= gid < off + n:
                    names.append(f"tenant {tid!r} task {gid - off}")
                    break
            else:
                names.append(f"task {gid}")
        return ", ".join(names) or "unknown task"

    def rk3_step_all(self) -> Dict[Any, Any]:
        """Advance every tenant one RK3 step: three merged waves, and the
        solo runner's Shu-Osher combines over the whole tenancy, each
        multiply and add its own ``torch._foreach`` call so that every
        intermediate rounds as the runner's ``u + dt * l`` and ``0.75 * u
        + 0.25 * (a + dt * l)`` do."""
        dts = {tid: t.dt for tid, t in self._tenants.items()}
        s0 = self.states()
        l0 = self._rhs_all(s0)
        u1 = _add_all(s0, _scale_all(l0, dts))
        l1 = self._rhs_all(u1)
        m1 = _add_all(u1, _scale_all(l1, dts))
        u2 = _add_all(_scale_all(s0, 0.75), _scale_all(m1, 0.25))
        l2 = self._rhs_all(u2)
        m2 = _add_all(u2, _scale_all(l2, dts))
        out = _add_all(_scale_all(s0, 1.0 / 3.0), _scale_all(m2, 2.0 / 3.0))
        for tid, t in self._tenants.items():
            t.state = t.scenario.finalize_step(out[tid])
            t.steps += 1
        return self.states()


def _captured_phases(extract, assemble, states, cols, batch_specs, order,
                     device):
    """``extract`` and ``assemble`` as one :class:`CapturedCall` each,
    over flat tensor lists (the states' leaves in tenant order; the
    families' parents and outputs in ``order``), wrapped back to the
    closures' dict signatures."""
    tids = list(states)
    shapes = {tid: (isinstance(st, tuple), len(_leaves(st)))
              for tid, st in states.items()}
    n_cols = {k: len(cols[k]) for k in order}
    n_state = sum(n for _, n in shapes.values())

    def flat_states(sts):
        return tuple(u for tid in tids for u in _leaves(sts[tid]))

    def unflat_states(flat):
        out, i = {}, 0
        for tid in tids:
            is_tuple, n = shapes[tid]
            out[tid] = tuple(flat[i:i + n]) if is_tuple else flat[i]
            i += n
        return out

    def flat_extract(*flat):
        got = extract(unflat_states(flat))
        return tuple(c for k in order for c in got[k])

    def flat_assemble(*flat):
        batches = dict(zip(order, flat[n_state:]))
        got = assemble(unflat_states(flat[:n_state]), batches)
        return tuple(u for tid in tids for u in _leaves(got[tid]))

    g_extract = CapturedCall(flat_extract, flat_states(states), device)
    g_assemble = CapturedCall(
        flat_assemble, flat_states(states) + tuple(batch_specs[k]
                                                   for k in order), device)

    def run_extract(sts):
        # the static outputs themselves: the drain programs read them in
        # place (fixed addresses), and nothing reads them past the wave
        flat = g_extract.replay_static(*flat_states(sts))
        out, i = {}, 0
        for k in order:
            out[k] = tuple(flat[i:i + n_cols[k]])
            i += n_cols[k]
        return out

    def run_assemble(sts, batches):
        return unflat_states(g_assemble(*flat_states(sts), *(
            batches[k] for k in order)))

    return run_extract, run_assemble
