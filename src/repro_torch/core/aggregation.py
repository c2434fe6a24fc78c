"""The paper's strategy 3: on-the-fly explicit work aggregation (the subset
the uniform main path runs).

Fine-grained tasks submit "launch kernel K on my inputs" requests.  While
the underlying executors are busy, compatible submissions accumulate; when
one becomes idle — or the ``max_aggregated`` cap is reached — the queued
tasks are fused into ONE batched launch over a slot axis, and each task's
future resolves to its slot of the batched output.

Submissions are routed by :class:`TaskSignature` (kernel id plus per-task
shape and dtype) to their family's region, with its own queue and bucket
ladder.  A queue of length k drains greedily with the largest ladder bucket
<= k; since bucket 1 exists, nothing is ever padded and results are
bit-identical to one whole-wave launch.

Three staging modes, one per queue entry (a switch of mode launches what
is queued first):

* ``ref`` — a task is a :class:`SlotView` ``(parent, index)`` into a
  tensor already on the device (``submit_range``, ``submit_indexed``).  A
  contiguous bucket is ``parent.narrow(0, start, k)`` — a view, no copy;
  any other bucket is one ``index_select``.
* ``ring`` — concrete per-task tensors under device staging go into the
  region's :class:`~repro_torch.core.buffers.SlotRing`; a bucket reads the
  ring's filled prefix in place, and the ring swaps buffers when the queue
  drains.
* ``host`` — under ``staging="host"`` every task is kept as given and each
  bucket is stacked at launch: ``torch.stack`` of tensors already on the
  device, or CPU tensors through a pinned :class:`BufferPool` slab and one
  H2D copy.

``make_s2_scatter`` builds the ``s2`` strategy's per-task launch.  The
reference's containment, cost model, autotune and tune store wait in
ROADMAP.md.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import AggregationConfig
from repro_torch.core.buffers import BufferPool, SlotRing
from repro_torch.core.executor import ExecutorPool
from repro_torch.device import DeviceLike, resolve_device


class TaskFuture:
    """Resolves to one task's slot of a batched launch (lazily: fulfilment
    records (batch, slot); ``result()`` slices)."""

    __slots__ = ("_batch", "_slot", "_done")

    def __init__(self):
        self._batch = None
        self._slot = -1
        self._done = False

    def _fulfil(self, batch_out: torch.Tensor, slot: int) -> None:
        self._batch, self._slot, self._done = batch_out, slot, True

    def ready(self) -> bool:
        return self._done

    def result(self) -> torch.Tensor:
        if not self._done:
            raise RuntimeError("task not launched yet — call executor.flush()")
        return self._batch[self._slot]


class RangeFuture:
    """One future for a contiguous range of ``count`` tasks.

    The greedy drain may split a range across several bucketed launches,
    so fulfilment is segmented: each launch contributes
    ``(range_offset, batch, slot, n)``.  ``result()`` assembles the
    ``(count, ...)`` batch — the launch output itself, with no copy, when
    one launch covered the whole range.
    """

    __slots__ = ("_parts", "_count", "_value")

    def __init__(self, count: int):
        self._parts: List[Tuple[int, torch.Tensor, int, int]] = []
        self._count = count
        self._value = None

    def __len__(self) -> int:
        return self._count

    def _fulfil_range(self, batch_out: torch.Tensor, slot: int, offset: int,
                      n: int) -> None:
        self._parts.append((offset, batch_out, slot, n))

    def ready(self) -> bool:
        if self._value is not None:
            return True
        return sum(p[3] for p in self._parts) == self._count

    def result(self) -> torch.Tensor:
        """The whole range as one batched tensor (task axis leading)."""
        if self._value is None:
            self._value = _assemble_segments(list(self._segments()))
            self._parts = []
        return self._value

    def task_result(self, index: int) -> torch.Tensor:
        if not 0 <= index < self._count:
            raise IndexError(f"task {index} out of range [0, {self._count})")
        if self._value is not None:
            return self._value[index]
        for off, batch, slot, n in self._parts:
            if off <= index < off + n:
                return batch[slot + index - off]
        raise RuntimeError("task not launched yet — call executor.flush()")

    def _segments(self):
        if self._value is not None:
            yield self._value, 0, self._value.shape[0]
            return
        if not self.ready():
            raise RuntimeError(
                "range not fully launched yet — call executor.flush()")
        for _, batch, slot, n in sorted(self._parts, key=lambda p: p[0]):
            yield batch, slot, n


def _assemble_segments(segments: List[Tuple[torch.Tensor, int, int]]
                       ) -> torch.Tensor:
    """Merge ``(batch, start_slot, n)`` runs into one batched tensor.

    Consecutive runs on the same launch output coalesce; a run covering a
    whole launch in order is the batch itself (no copy), a contiguous
    partial run one ``narrow``, anything else one ``index_select``.
    """
    parts = []
    i = 0
    while i < len(segments):
        batch = segments[i][0]
        runs: List[Tuple[int, int]] = []           # [(start, n)] on `batch`
        while i < len(segments) and segments[i][0] is batch:
            s0, n = segments[i][1], segments[i][2]
            if runs and runs[-1][0] + runs[-1][1] == s0:
                runs[-1] = (runs[-1][0], runs[-1][1] + n)
            else:
                runs.append((s0, n))
            i += 1
        if runs == [(0, batch.shape[0])]:
            parts.append(batch)
        elif len(runs) == 1:
            parts.append(batch.narrow(0, runs[0][0], runs[0][1]))
        else:
            idx = torch.tensor([s for s0, n in runs for s in range(s0, s0 + n)],
                               device=batch.device)
            parts.append(batch.index_select(0, idx))
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def gather_futures(futs: Sequence[Any]) -> torch.Tensor:
    """Assemble many futures' results into one batched tensor, lazily:
    O(launches) tensor ops, not O(tasks).  ``TaskFuture`` and
    ``RangeFuture`` entries may be interleaved freely."""
    if not futs:
        raise ValueError("gather_futures needs at least one future")
    segments: List[Tuple[torch.Tensor, int, int]] = []
    for f in futs:
        if isinstance(f, RangeFuture):
            segments.extend(f._segments())
        elif not f._done:
            raise RuntimeError("task not launched yet — call executor.flush()")
        else:
            segments.append((f._batch, f._slot, 1))
    return _assemble_segments(segments)


class SlotView:
    """Zero-copy task-input reference: ``parent[index]``, never sliced."""

    __slots__ = ("parent", "index")

    def __init__(self, parent: torch.Tensor, index: int):
        self.parent = parent
        self.index = index


def _spec_of(a: Any) -> Tuple[Tuple[int, ...], str]:
    """(per-task shape, dtype name) of one task argument."""
    if isinstance(a, SlotView):
        return tuple(a.parent.shape[1:]), str(a.parent.dtype)
    return tuple(a.shape), str(a.dtype)


@dataclass(frozen=True)
class TaskSignature:
    """What makes two fine-grained tasks aggregable: the kernel family id
    plus every argument's per-task shape and dtype (the paper's SGMT
    compatibility check, reified as the region-registry key)."""

    kernel: str
    arg_specs: Tuple[Tuple[Tuple[int, ...], str], ...]

    @classmethod
    def from_args(cls, kernel: str, args: Sequence[Any]) -> "TaskSignature":
        return cls(kernel, tuple(_spec_of(a) for a in args))

    def describe(self) -> str:
        """Unique readable key: shapes, with the dtype appended unless it
        is float32."""
        def one(spec):
            shape, dt = spec
            s = "x".join(map(str, shape)) or "scalar"
            return s if dt == "torch.float32" else f"{s}:{dt[6:]}"
        return f"{self.kernel}[{','.join(one(s) for s in self.arg_specs)}]"


@dataclass
class _Pending:
    future: Any                           # TaskFuture | RangeFuture
    views: Optional[Tuple[SlotView, ...]] = None   # ref mode
    args: Optional[Tuple[torch.Tensor, ...]] = None  # host mode
    slot: int = -1                        # ring mode: the task's ring slot
    count: int = 1                        # tasks in this entry (>1: a range)
    fut_offset: int = 0                   # offset in its RangeFuture

    def split(self, n: int) -> Tuple["_Pending", "_Pending"]:
        """Split a range entry: first ``n`` tasks / the rest.  Both halves
        share the future (each fulfils its own offset)."""
        assert 0 < n < self.count
        head = _Pending(self.future, self.views, count=n,
                        fut_offset=self.fut_offset)
        tail = _Pending(
            self.future,
            tuple(SlotView(v.parent, v.index + n) for v in self.views),
            count=self.count - n, fut_offset=self.fut_offset + n)
        return head, tail


def _entry_mode(entry: _Pending) -> str:
    if entry.views is not None:
        return "ref"
    if entry.args is not None:
        return "host"
    return "ring"


def greedy_decomposition(k: int, buckets: Sequence[int]) -> Tuple[int, ...]:
    """The bucket sequence the greedy drain launches for a queue of length
    k under a valid ladder (one definition of "what will launch")."""
    out = []
    while k:
        b = max(x for x in buckets if x <= k)
        out.append(b)
        k -= b
    return tuple(out)


class _Region:
    """One aggregation region: per-TaskSignature queue, bucket ladder, slot
    ring (made at the first per-task submission) and the two staging
    programs (contiguous prefix, indexed gather)."""

    __slots__ = ("signature", "batched_fn", "queue", "queued_tasks",
                 "buckets", "stats", "ring")

    def __init__(self, signature: TaskSignature, batched_fn: Callable,
                 buckets: Tuple[int, ...]):
        self.signature = signature
        self.batched_fn = batched_fn
        self.queue: List[_Pending] = []
        self.queued_tasks = 0
        self.buckets = buckets
        self.stats = {"submitted": 0, "launches": 0, "aggregated_hist": {},
                      "ladder": list(buckets)}
        self.ring: Optional[SlotRing] = None

    def ensure_ring(self, capacity: int, example_args: Sequence[torch.Tensor],
                    device: torch.device) -> SlotRing:
        if self.ring is None:
            self.ring = SlotRing(capacity, example_args, device=device)
        return self.ring

    def apply_prefix(self, start: int, k: int, *parents: torch.Tensor):
        """Contiguous bucket: the body reads ``[start, start+k)`` of each
        parent as a view, with no staging copy."""
        return self.batched_fn(*(p.narrow(0, start, k) for p in parents))

    def apply_gathered(self, idx: torch.Tensor, *parents: torch.Tensor):
        """Any other bucket: one gather per parent feeds the body."""
        return self.batched_fn(*(p.index_select(0, idx) for p in parents))


class AggregationExecutor:
    """Aggregates submissions of kernel families into bucketed launches.

    ``batched_fn(*stacked_args) -> stacked_out`` takes and returns tensors
    with a leading slot axis; it is registered as the default family under
    ``name``, further families via :meth:`register`.  ``config`` caps the
    bucket size (``max_aggregated``, also each slot ring's capacity), sizes
    the executor pool (``n_executors``: strategy 3 combined with strategy
    2) and picks the staging of per-task submissions (``staging``).
    """

    def __init__(self, batched_fn: Optional[Callable] = None,
                 config: Optional[AggregationConfig] = None,
                 pool: Optional[ExecutorPool] = None, name: str = "region",
                 device: DeviceLike = None,
                 buffer_pool: Optional[BufferPool] = None):
        self.name = name
        self.config = config or AggregationConfig()
        self.device = resolve_device(device)
        self.pool = pool or ExecutorPool(self.config.n_executors,
                                         device=self.device)
        self._staging = self.config.staging
        self.buffers = buffer_pool or BufferPool(
            pinned=self.device.type == "cuda")
        self._buckets = tuple(sorted(self.config.bucket_sizes()))
        self._bodies: Dict[str, Callable] = {}
        self._regions: Dict[TaskSignature, _Region] = {}
        self._default_kernel: Optional[str] = None
        self.stats = {"submitted": 0, "launches": 0, "aggregated_hist": {},
                      "staging_s": 0.0, "regions": {}}
        if batched_fn is not None:
            self.register(name, batched_fn)

    # -- region registry ---------------------------------------------------
    def register(self, kernel: str, batched_fn: Callable,
                 default: bool = False) -> str:
        """Register a kernel family's batched body; the first registration
        (or ``default=True``) serves untagged submissions."""
        if kernel in self._bodies and self._bodies[kernel] is not batched_fn:
            raise ValueError(
                f"kernel {kernel!r} already registered with a different body")
        self._bodies[kernel] = batched_fn
        if default or self._default_kernel is None:
            self._default_kernel = kernel
        return kernel

    def _resolve_kernel(self, kernel: Optional[str]) -> str:
        kernel = kernel or self._default_kernel
        if kernel is None:
            raise RuntimeError("no kernel family registered — pass "
                               "batched_fn to the constructor or register()")
        return kernel

    def _region_for(self, kernel: str, args: Sequence[Any]) -> _Region:
        sig = TaskSignature.from_args(kernel, args)
        region = self._regions.get(sig)
        if region is None:
            body = self._bodies.get(kernel)
            if body is None:
                raise KeyError(f"no batched body registered for kernel "
                               f"{kernel!r} (have {sorted(self._bodies)})")
            region = _Region(sig, body, self._buckets)
            self._regions[sig] = region
            self.stats["regions"][sig.describe()] = region.stats
        return region

    @property
    def ring(self) -> Optional[SlotRing]:
        """The slot ring of the sole region (None with several regions, or
        before a per-task submission or warmup made one)."""
        if len(self._regions) != 1:
            return None
        return next(iter(self._regions.values())).ring

    # -- warmup ------------------------------------------------------------
    def warmup(self, parent_shapes: Sequence[Tuple[Tuple[int, ...],
                                                   torch.dtype]], *,
               kernel: Optional[str] = None) -> None:
        """Launch each ladder bucket once on every executor's stream, on
        zero-filled parents of the given ``(shape, dtype)``s (the shapes a
        range or a host-stacked bucket reads), and under device staging
        once more on the family's slot ring, which this makes: builds the
        kernel at first use and pays every first-launch cost (including
        each stream's first allocations) before the timed run.  Launch
        statistics are not touched.  (Per-bucket CUDA-graph capture waits
        in ROADMAP.md.)"""
        kernel = self._resolve_kernel(kernel)
        parents = tuple(torch.zeros(shape, dtype=dtype, device=self.device)
                        for shape, dtype in parent_shapes)
        region = self._region_for(kernel, [SlotView(p, 0) for p in parents])
        n_parent = min(p.shape[0] for p in parents)
        ring = None
        if self._staging == "device":
            ring = region.ensure_ring(self.config.max_aggregated,
                                      [p[0] for p in parents], self.device)
        for ex in self.pool.executors:
            for b in region.buckets:
                if b <= n_parent:
                    ex.run(region.apply_prefix, 0, b, *parents)
                if ring is not None:
                    ex.run(region.apply_prefix, 0, b, *ring.buffers())
                    ring.track_read(0, b, ex.last_event)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- submission API ----------------------------------------------------
    def submit(self, *args, kernel: Optional[str] = None) -> TaskFuture:
        """Queue one task, routed to its signature's region.  Args are all
        :class:`SlotView` references (staged by reference under device
        staging) or per-task tensors — on the executor's device, or on the
        CPU for the card — written into the region's slot ring (device
        staging) or kept for a stack at launch (host staging)."""
        if not args:
            raise ValueError("submit needs the task's arguments")
        kernel = self._resolve_kernel(kernel)
        fut = TaskFuture()
        if (self._staging == "device"
                and all(isinstance(a, SlotView) for a in args)):
            if any(v.index != args[0].index for v in args[1:]):
                raise ValueError(
                    "SlotView args of one task must share one index — a "
                    "launch gathers the SAME slot from every parent")
            region = self._region_for(kernel, args)
            self._enqueue(region, _Pending(fut, views=tuple(args)))
            return fut
        args = tuple(a.parent[a.index] if isinstance(a, SlotView) else a
                     for a in args)
        self._check_task_devices(args)
        region = self._region_for(kernel, args)
        if self._staging == "host":
            self._enqueue(region, _Pending(fut, args=args))
            return fut
        t0 = time.perf_counter()
        ring = region.ensure_ring(self.config.max_aggregated, args,
                                  self.device)
        if ring.fill >= ring.capacity:
            # watermark remainders left a consumed prefix: slide the live
            # tail to the front
            first = region.queue[0].slot if region.queue else ring.fill
            ring.compact(first)
            for p in region.queue:
                p.slot -= first
        slot = ring.write(args)
        self.stats["staging_s"] += time.perf_counter() - t0
        self._enqueue(region, _Pending(fut, slot=slot))
        return fut

    def _check_task_devices(self, args: Sequence[torch.Tensor]) -> None:
        for a in args:
            if a.device != self.device and a.device.type != "cpu":
                raise ValueError(
                    f"a task argument lives on {a.device}; the executor "
                    f"stages tensors on {self.device} or on the CPU")

    def submit_indexed(self, parents: Tuple[torch.Tensor, ...], index: int,
                       kernel: Optional[str] = None) -> TaskFuture:
        """Submit task ``index`` whose j-th arg is ``parents[j][index]``."""
        return self.submit(*(SlotView(p, index) for p in parents),
                           kernel=kernel)

    def submit_range(self, parents: Tuple[torch.Tensor, ...], start: int,
                     n: int, kernel: Optional[str] = None) -> RangeFuture:
        """Bulk submission: tasks ``start .. start+n-1`` of a parent set as
        ONE queue entry backed by ONE :class:`RangeFuture`.  Device staging
        only: under host staging submit per task."""
        if n <= 0:
            raise ValueError(f"submit_range needs n >= 1, got {n}")
        if self._staging != "device":
            raise ValueError(
                "submit_range requires device staging — ranges reference "
                "device-resident parents by slot index (use per-task "
                "submit() under staging='host')")
        n_parent = min(p.shape[0] for p in parents)
        if start < 0 or start + n > n_parent:
            raise ValueError(
                f"range [{start}, {start + n}) out of bounds for parents "
                f"with {n_parent} slots")
        kernel = self._resolve_kernel(kernel)
        views = tuple(SlotView(p, start) for p in parents)
        region = self._region_for(kernel, views)
        fut = RangeFuture(n)
        self._enqueue(region, _Pending(fut, views=views, count=n))
        return fut

    def _enqueue(self, region: _Region, entry: _Pending) -> None:
        self._check_mode(region, entry)
        region.queue.append(entry)
        region.queued_tasks += entry.count
        self.stats["submitted"] += entry.count
        region.stats["submitted"] += entry.count
        self._maybe_launch()

    def _check_mode(self, region: _Region, entry: _Pending) -> None:
        """A bucket stages uniformly: one mode, and for ref entries one
        parent set (a launch gathers from ONE parent set).  Launch the
        region's queue before admitting an incompatible entry."""
        if not region.queue:
            return
        head = region.queue[0]
        compatible = _entry_mode(head) == _entry_mode(entry)
        if compatible and entry.views is not None:
            compatible = all(a.parent is b.parent
                             for a, b in zip(head.views, entry.views))
        if not compatible:
            while region.queue:
                self._launch(region, self._largest_bucket(
                    region, region.queued_tasks))

    def _maybe_launch(self) -> None:
        """The paper's launch policy, per region: launch when the cap is
        reached, or when an executor is idle (eager drain); otherwise keep
        aggregating."""
        progress = True
        while progress:
            progress = False
            for region in self._regions.values():
                q = region.queued_tasks
                if q >= self.config.max_aggregated:
                    self._launch(region, self._largest_bucket(
                        region, self.config.max_aggregated))
                    progress = True
                elif (q >= self.config.launch_watermark
                      and self.pool.any_idle()):
                    self._launch(region, self._largest_bucket(region, q))
                    progress = True

    @staticmethod
    def _largest_bucket(region: _Region, k: int) -> int:
        best = region.buckets[0]
        for b in region.buckets:
            if b <= k:
                best = b
        if best > k:
            raise RuntimeError(
                f"bucket {best} exceeds queue length {k} — ladder "
                f"{region.buckets} lacks a remainder bucket")
        return best

    def _take(self, region: _Region, k: int) -> List[_Pending]:
        """Pop k tasks' worth of entries off the queue, splitting a range
        entry at the bucket boundary."""
        taken: List[_Pending] = []
        need = k
        while need:
            e = region.queue[0]
            if e.count <= need:
                taken.append(region.queue.pop(0))
                need -= e.count
            else:
                head, tail = e.split(need)
                region.queue[0] = tail
                taken.append(head)
                need = 0
        region.queued_tasks -= k
        return taken

    def _launch(self, region: _Region, k: int) -> None:
        tasks = self._take(region, k)
        mode = _entry_mode(tasks[0])
        self._launch_tasks(region, tasks, k, mode)
        if mode == "ring" and not region.queue:
            region.ring.swap()    # in-flight launches keep the old buffer

    def _stage(self, region: _Region, tasks: List[_Pending], k: int,
               mode: str):
        """One bucket's program and arguments.  Ref: a contiguous slot run
        reads a view of its parents, anything else gathers by index; ring:
        the ring's prefix in place; host: the bucket stacked."""
        if mode == "ring":
            return (region.apply_prefix,
                    (tasks[0].slot, k) + region.ring.buffers())
        if mode == "host":
            return region.batched_fn, tuple(
                self._stack([t.args[j] for t in tasks])
                for j in range(len(tasks[0].args)))
        indices: List[int] = []
        for t in tasks:
            i0 = t.views[0].index
            indices.extend(range(i0, i0 + t.count))
        parents = tuple(v.parent for v in tasks[0].views)
        if indices == list(range(indices[0], indices[0] + k)):
            return region.apply_prefix, (indices[0], k) + parents
        idx = torch.tensor(indices, device=parents[0].device)
        return region.apply_gathered, (idx,) + parents

    def _stack(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """One host-staged argument of a bucket: tensors on the device are
        stacked there; CPU tensors for the card fill a pinned slab, copied
        over in one non-blocking H2D copy, and the slab goes back to the
        pool with that copy's event."""
        if parts[0].device == self.device:
            return torch.stack(parts)
        slab = self.buffers.stage(parts)
        staged = slab.to(self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self.buffers.release(slab, event)
        return staged

    def _launch_tasks(self, region: _Region, tasks: List[_Pending], k: int,
                      mode: str) -> None:
        t0 = time.perf_counter()
        fn, call_args = self._stage(region, tasks, k, mode)
        self.stats["staging_s"] += time.perf_counter() - t0
        ex = self.pool.get()
        out = ex.launch(fn, *call_args, family=region.signature.kernel)
        if mode == "ring":
            region.ring.track_read(tasks[0].slot, tasks[0].slot + k,
                                   ex.last_event)
        slot = 0
        for t in tasks:
            if isinstance(t.future, RangeFuture):
                t.future._fulfil_range(out, slot, t.fut_offset, t.count)
            else:
                t.future._fulfil(out, slot)
            slot += t.count
        self.stats["launches"] += 1
        hist = self.stats["aggregated_hist"]
        hist[k] = hist.get(k, 0) + 1
        region.stats["launches"] += 1
        rhist = region.stats["aggregated_hist"]
        rhist[k] = rhist.get(k, 0) + 1

    def flush(self) -> None:
        """Launch everything still queued (greedy buckets; live regions
        round-robin) and make the caller's stream wait for every executor."""
        live = [r for r in self._regions.values() if r.queue]
        while live:
            for region in live:
                if region.queue:
                    self._launch(region, self._largest_bucket(
                        region, region.queued_tasks))
            live = [r for r in live if r.queue]
        self.pool.join()


def make_s2_scatter(batched_fn: Callable, width: int = 1) -> Callable:
    """One ``s2`` launch: run the batched body on ``width`` contiguous
    tasks, ``parents[j].narrow(0, i, width)``, writing straight into
    ``out_ring.narrow(0, i, width)`` through the body's ``out=`` (the
    port's bodies, ``kernels.ops``, take one).  Every width gives the same
    values per task: the body is independent per slot."""
    def scatter(out_ring: torch.Tensor, i: int,
                *parents: torch.Tensor) -> torch.Tensor:
        dst = out_ring.narrow(0, i, width)
        batched_fn(*(p.narrow(0, i, width) for p in parents), out=dst)
        return dst
    return scatter
