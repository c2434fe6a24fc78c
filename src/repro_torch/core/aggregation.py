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

Measured tuning: each region keeps a :class:`BucketCostModel` of timed
launches (``cost_model=True``), a queue-length histogram of its waves and,
under ``autotune=True``, re-derives its ladder (:func:`derive_ladder`)
after ``autotune_warmup`` waves.  A launch is timed by :class:`LaunchTimer`
(CUDA events around back-to-back launches on the card, the host clock on
the CPU), or by any callable the caller passes.  The flush policies decide
whether a partial queue drains into an idle executor, ``inner_chunk``
evaluates a bucket as sequential chunk launches, and ``select_strategy``
compares the measured ``s2``, ``s3`` and ``fused`` paths for the ``mixed``
strategy.  No policy, ladder, chunk or width changes a result.

Containment: under ``guard="finite"`` each launch issues one finite
reduction on its own stream, and ``flush`` reads every verdict in one
copy; a tripped bucket is bisected down to its culprits, which fail
(:class:`~repro_torch.core.faults.TaskFailedError`) while the survivors
are fulfilled bit for bit.  Injected compile and launch faults degrade a
bucket (bounded retries, rung bans, bucket 1 as the floor), the launch
watchdog bounds each launch by ``launch_timeout_s`` and a per-family
circuit breaker pins a faulting family to bucket 1 (DESIGN.md §11, §14).

Warm start (DESIGN.md §13): with a ``tune_store`` a region restores its
tuned state (ladder, chunk, cost tables, queue histogram, strategy
selection) at warmup instead of measuring it, and every retune writes the
tuned state back; ``prior="roofline"`` seeds an unmeasured region's cost
model and ladder from the roofline of its shapes
(:class:`~repro_torch.core.tunestore.RooflinePrior`) until the first
retune measures for real.  Entries are keyed by :func:`_backend_key`.

Compiled bucket programs: each region keeps the reference's table
``compiled`` under its keys, ``("ring", b)``, ``("host", b)``,
``("prefix", b)``, ``("gather", b, pk)`` and ``("prefix_aot", b, pk)``
(``pk`` the parent set's shapes), filled where the reference compiles:
``warmup``, the lazy ``compiled_for``, the measurements and the retune,
and dropped by ``reset_compiled`` when a re-sweep changes the inner chunk.
On the CPU each entry is the eager callable; on the card a
:class:`~repro_torch.core.graphs.BucketProgram`, one CUDA graph per slot
offset and input buffer, so a bucket launch is a graph replay.  A graph
reads its inputs where they are: the slot ring's two buffers, or a static
parent set of the region for ``pk``.  A population written in place
(:meth:`AggregationExecutor.population_buffers`: the scenario extracts
straight into the static parents) is read there as it is; any other
by-reference parent set is copied into the ``pk``'s first static set
once, at its first launch (``stats["static_parent_copies"]`` counts the
copies).

``make_s2_scatter`` builds the ``s2`` strategy's per-task launch.
"""
from __future__ import annotations

import bisect
import functools
import statistics
import threading
import time
import warnings
from dataclasses import dataclass
from typing import (
    Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple,
)

import torch

from repro_torch import tracing
from repro_torch.configs.base import (
    AggregationConfig, resolve_family_option, validate_ladder,
)
from repro_torch.core.buffers import BufferPool, SlotRing
from repro_torch.core import graphs
from repro_torch.core.executor import DeviceExecutor, ExecutorPool
from repro_torch.core.faults import (
    BucketCompileError, FaultInjector, LaunchFaultError, LaunchTimeoutError,
    QuarantineList, RegionFaultError, TaskFailedError, all_finite_async,
    poison_slots,
)
from repro_torch.core.tunestore import (
    RooflinePrior, TuneStore, TuneStoreWarning,
)
from repro_torch.device import DeviceLike, resolve_device


class TaskFuture:
    """Resolves to one task's slot of a batched launch (lazily: fulfilment
    records (batch, slot); ``result()`` slices).

    Under ``guard="finite"`` a future may resolve failed instead:
    ``failed()`` says so, ``error()`` carries the
    :class:`~repro_torch.core.faults.TaskFailedError` and ``result()``
    raises it.  A contained fault never returns garbage."""

    __slots__ = ("_batch", "_slot", "_done", "_error")

    def __init__(self):
        self._batch = None
        self._slot = -1
        self._done = False
        self._error = None

    def _fulfil(self, batch_out: torch.Tensor, slot: int) -> None:
        self._batch, self._slot, self._done = batch_out, slot, True

    def _fail(self, err: Exception) -> None:
        self._error, self._done = err, True
        self._batch = None

    def _retract(self) -> None:
        """Un-fulfil: the launch that fulfilled this future tripped the
        guard; containment fulfils or fails it again."""
        self._done = False
        self._batch = None

    def ready(self) -> bool:
        return self._done

    def failed(self) -> bool:
        return self._error is not None

    def error(self) -> Optional[Exception]:
        return self._error

    def result(self) -> torch.Tensor:
        if self._error is not None:
            raise self._error
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

    Containment may mark single offsets failed: ``failed_indices()`` lists
    them, ``error(i)`` returns one task's
    :class:`~repro_torch.core.faults.TaskFailedError`, ``task_result(i)``
    reads one survivor, and ``result()`` and ``gather_futures`` raise
    rather than assemble a batch with garbage slots in it.
    """

    __slots__ = ("_parts", "_count", "_value", "_failed")

    def __init__(self, count: int):
        self._parts: List[Tuple[int, torch.Tensor, int, int]] = []
        self._count = count
        self._value = None
        self._failed: Dict[int, Exception] = {}

    def __len__(self) -> int:
        return self._count

    def _fulfil_range(self, batch_out: torch.Tensor, slot: int, offset: int,
                      n: int) -> None:
        self._parts.append((offset, batch_out, slot, n))

    def _fail_range(self, offset: int, n: int, err: Exception) -> None:
        for i in range(offset, offset + n):
            self._failed[i] = err

    def _retract(self, batch_out: torch.Tensor) -> None:
        """Drop every segment a tripped launch contributed (containment
        fulfils or fails those offsets again after bisection)."""
        self._parts = [p for p in self._parts if p[1] is not batch_out]

    def ready(self) -> bool:
        if self._value is not None:
            return True
        return (sum(p[3] for p in self._parts) + len(self._failed)
                == self._count)

    def failed(self) -> bool:
        return bool(self._failed)

    def failed_indices(self) -> List[int]:
        return sorted(self._failed)

    def error(self, index: Optional[int] = None) -> Optional[Exception]:
        if index is not None:
            return self._failed.get(index)
        return next(iter(self._failed.values()), None)

    def result(self) -> torch.Tensor:
        """The whole range as one batched tensor (task axis leading)."""
        if self._failed:
            raise TaskFailedError(
                f"{len(self._failed)} of {self._count} tasks in this range "
                f"failed (indices {self.failed_indices()}) — read survivors "
                f"individually with task_result()",
                task_ids=self.failed_indices())
        if self._value is None:
            self._value = _assemble_segments(list(self._segments()))
            self._parts = []
        return self._value

    def task_result(self, index: int) -> torch.Tensor:
        """One task's result (raises its error if containment failed it)."""
        if index in self._failed:
            raise self._failed[index]
        if not 0 <= index < self._count:
            raise IndexError(f"task {index} out of range [0, {self._count})")
        if self._value is not None:
            return self._value[index]
        for off, batch, slot, n in self._parts:
            if off <= index < off + n:
                return batch[slot + index - off]
        raise RuntimeError("task not launched yet — call executor.flush()")

    def _segments(self):
        if self._failed:
            raise TaskFailedError(
                f"range contains {len(self._failed)} failed tasks "
                f"(indices {self.failed_indices()}) — gather_futures would "
                f"assemble garbage slots; read survivors with task_result()",
                task_ids=self.failed_indices())
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
        elif f._error is not None:    # a failed task never assembles
            raise f._error
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


def _slot_spec(shape: Sequence[int], dtype: torch.dtype
               ) -> Tuple[Tuple[int, ...], str]:
    """(per-task shape, dtype name) of a slot of a parent of ``shape``."""
    return tuple(shape[1:]), str(dtype)


def _spec_of(a: Any) -> Tuple[Tuple[int, ...], str]:
    """(per-task shape, dtype name) of one task argument."""
    if isinstance(a, SlotView):
        return _slot_spec(a.parent.shape, a.parent.dtype)
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

    @classmethod
    def from_parents(cls, kernel: str,
                     specs: Sequence[Tuple[Tuple[int, ...], torch.dtype]]
                     ) -> "TaskSignature":
        """The signature of tasks that are slots of parents of these
        ``(shape, dtype)``, as :meth:`from_args` gives it for their
        views."""
        return cls(kernel, tuple(_slot_spec(*spec) for spec in specs))

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
    wave_index: int = 0                   # first task's wave-relative id

    def split(self, n: int) -> Tuple["_Pending", "_Pending"]:
        """Split a range entry: first ``n`` tasks / the rest.  Both halves
        share the future (each fulfils its own offset)."""
        assert 0 < n < self.count
        head = _Pending(self.future, self.views, count=n,
                        fut_offset=self.fut_offset,
                        wave_index=self.wave_index)
        tail = _Pending(
            self.future,
            tuple(SlotView(v.parent, v.index + n) for v in self.views),
            count=self.count - n, fut_offset=self.fut_offset + n,
            wave_index=self.wave_index + n)
        return head, tail


@dataclass
class _LaunchRecord:
    """What the guard needs to audit one launch and, on a trip, run any
    subset of its positions again: subset ``S`` re-runs as
    ``region.apply_gathered(indices[S], *parents)``.  ``parents`` are the
    submitted parents (ref staging), the bucket's ring slice copied at
    launch (ring staging: the ring itself is rewritten in place by later
    waves and compactions) or the stacked batch (host staging).
    ``poisoned`` maps the wave ids that carried an injected payload fault
    at launch to its mode; re-executions apply exactly those again."""

    region: "_Region"
    out: torch.Tensor                 # the launch's batched output
    k: int                            # bucket size
    parents: Tuple[torch.Tensor, ...]
    indices: List[int]                # per-position index into ``parents``
    tasks: List[_Pending]             # the entries this launch fulfilled
    wave_ids: List[int]               # per-position wave-relative task id
    wave: int                         # region wave counter at launch
    poisoned: Dict[int, str]          # wave id -> injected payload mode
    verdict: Any = True               # 0-dim bool tensor, read at flush


def _split_taken(entries: List[_Pending], n: int
                 ) -> Tuple[List[_Pending], List[_Pending]]:
    """Split an entry list at task boundary ``n``: the first ``n`` tasks'
    entries and the rest, a range entry split at the boundary (a queue
    drained by a bucket, or taken tasks carved to a smaller bucket)."""
    head: List[_Pending] = []
    rest = list(entries)
    need = n
    while need:
        e = rest[0]
        if e.count <= need:
            head.append(rest.pop(0))
            need -= e.count
        else:
            h, t = e.split(need)
            rest[0] = t
            head.append(h)
            need = 0
    return head, rest


def _index_tensor(indices: Sequence[int], device: torch.device
                  ) -> torch.Tensor:
    """An index tensor on ``device``, copied without a host sync."""
    return torch.tensor(list(indices), dtype=torch.long).to(
        device, non_blocking=True)


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


def greedy_launches(k: int, buckets: Sequence[int]) -> int:
    """Launches the greedy drain performs for a queue of length k."""
    return len(greedy_decomposition(k, buckets))


class BucketCostModel:
    """Measured per-bucket launch times (seconds) of ONE region, per
    execution path: ``"s3"`` (the bucket programs, keyed by bucket),
    ``"s2"`` (the scatter launch, keyed by coalesce width) and ``"fused"``
    (the whole-wave launch, keyed by wave size).

    ``time`` is the median of a bucket's samples; ``predict`` extends the
    table piecewise-linearly in the bucket size — clamped below the
    smallest measured bucket, extrapolated above the largest with the last
    segment's slope (floored at the largest measurement).  Priors
    (``seed_prior``) live beside the samples and answer only for a path
    without one real sample, each such answer counted in ``prior_hits``.
    ``as_stats`` is the table in milliseconds for ``stats["regions"]``.
    """

    __slots__ = ("samples", "_paths", "priors", "_sources", "prior_hits")

    def __init__(self):
        self.samples: Dict[int, List[float]] = {}
        # path -> {bucket/width: raw samples}; "s3" aliases ``samples``
        self._paths: Dict[str, Dict[int, List[float]]] = {"s3": self.samples}
        self.priors: Dict[str, Dict[int, float]] = {}
        self._sources: Dict[Tuple[str, int], str] = {}
        self.prior_hits = 0

    def _table(self, path: str) -> Dict[int, List[float]]:
        t = self._paths.get(path)
        if t is None:
            t = self._paths[path] = {}
        return t

    def record(self, bucket: int, seconds: float, path: str = "s3",
               source: str = "measured") -> None:
        self._table(path).setdefault(int(bucket), []).append(float(seconds))
        self._sources[(path, int(bucket))] = source

    def seed_prior(self, bucket: int, seconds: float,
                   path: str = "s3") -> None:
        """Install an analytical estimate for one bucket, beside the
        samples, never in them (``time`` stays None)."""
        self.priors.setdefault(path, {})[int(bucket)] = float(seconds)

    def clear(self) -> None:
        """Drop every sample and prior on every path (the measured
        programs changed, e.g. the region's inner chunk)."""
        for table in self._paths.values():
            table.clear()
        self.priors.clear()
        self._sources.clear()

    def clear_priors(self) -> None:
        self.priors.clear()

    def measured(self, path: str = "s3") -> bool:
        return bool(self._paths.get(path))

    def seeded(self, path: str = "s3") -> bool:
        return bool(self.priors.get(path))

    def has_data(self, path: str = "s3") -> bool:
        """Can ``predict`` answer for this path (measured or seeded)?"""
        return self.measured(path) or self.seeded(path)

    def sources(self) -> Dict[str, Dict[int, str]]:
        """{path: {bucket: "measured" | "prior" | ...}}: where each known
        bucket's number came from (priors shadowed by samples)."""
        out: Dict[str, Dict[int, str]] = {}
        for path, prior in self.priors.items():
            for b in prior:
                out.setdefault(path, {})[b] = "prior"
        for (path, b), src in self._sources.items():
            if self._paths.get(path, {}).get(b):
                out.setdefault(path, {})[b] = src
        return out

    def paths(self) -> Tuple[str, ...]:
        """The execution paths with at least one measurement."""
        return tuple(sorted(p for p, t in self._paths.items() if t))

    def buckets(self, path: str = "s3") -> Tuple[int, ...]:
        return tuple(sorted(self._paths.get(path, ())))

    def time(self, bucket: int, path: str = "s3") -> Optional[float]:
        s = self._paths.get(path, {}).get(bucket)
        return statistics.median(s) if s else None

    @staticmethod
    def _interp(bs: Sequence[int], val: Callable[[int], float],
                bucket: int) -> float:
        """Clamp below the smallest entry, interpolate inside, extrapolate
        above with the last segment's slope (floored)."""
        if bucket <= bs[0]:
            return val(bs[0])
        if bucket >= bs[-1]:
            hi = val(bs[-1])
            if len(bs) == 1:
                return hi * bucket / bs[-1]
            lo = val(bs[-2])
            slope = (hi - lo) / (bs[-1] - bs[-2])
            return max(hi, hi + slope * (bucket - bs[-1]))
        i = bisect.bisect_left(bs, bucket)
        b0, b1 = bs[i - 1], bs[i]
        t0, t1 = val(b0), val(b1)
        return t0 + (t1 - t0) * (bucket - b0) / (b1 - b0)

    def predict(self, bucket: int, path: str = "s3") -> float:
        t = self.time(bucket, path)
        if t is not None:
            return t
        bs = self.buckets(path)
        if bs:
            return self._interp(bs, lambda b: self.time(b, path), bucket)
        prior = self.priors.get(path)
        if prior:
            self.prior_hits += 1
            return self._interp(tuple(sorted(prior)), prior.__getitem__,
                                bucket)
        raise ValueError("cost model has no measurements or priors — "
                         "check has_data() before predicting")

    def predict_seq(self, buckets: Sequence[int], path: str = "s3") -> float:
        """Predicted time of one greedy drain (a launch sequence)."""
        return sum(self.predict(b, path) for b in buckets)

    def predict_s2_wave(self, wave: int) -> Optional[Tuple[int, float]]:
        """(best coalesce width, predicted seconds) for a ``wave``-task
        population through the measured ``s2`` widths: width-w launches
        over w tasks each, the remainder at width 1.  None before any
        ``"s2"`` measurement (or when a remainder would need an unmeasured
        width 1)."""
        ws = self.buckets("s2") or tuple(sorted(self.priors.get("s2", ())))
        if not ws:
            return None
        best = None
        for w in ws:
            if w > wave:
                continue
            rem = wave % w
            if rem and 1 not in ws:
                continue
            t = (wave // w) * self.predict(w, "s2")
            if rem:
                t += rem * self.predict(1, "s2")
            if best is None or t < best[1]:
                best = (w, t)
        return best

    def as_stats(self, path: str = "s3") -> Dict[int, float]:
        """{bucket: median milliseconds}, rounded for the stats surface."""
        return {b: round(self.time(b, path) * 1e3, 4)
                for b in self.buckets(path)}

    def as_stats_paths(self) -> Dict[str, Dict[int, float]]:
        return {p: self.as_stats(p) for p in self.paths()}


class LaunchTimer:
    """Seconds per call of a launch program ``fn``, one sample per call of
    the timer: ``timer(fn, device, path, size)`` (``path`` and ``size``
    name what is timed, for a timer that feeds known times).

    On the card, ``reps`` back-to-back calls on the current stream between
    two CUDA events, the elapsed time over ``reps``: a launch shorter than
    its wrapper's host time then costs the host's pacing, which is what a
    wave pays, and kernel times spread far less than host times do.  On
    the CPU, the host clock around one call."""

    def __init__(self, reps: int = 8):
        if reps < 1:
            raise ValueError(f"reps must be >= 1, got {reps}")
        self.reps = reps

    def launches_per_sample(self, device: torch.device) -> int:
        return self.reps if device.type == "cuda" else 1

    def __call__(self, fn: Callable[[], Any], device: torch.device,
                 path: str, size: int) -> float:
        if device.type != "cuda":
            t0 = time.perf_counter()
            fn()
            return time.perf_counter() - t0
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            for _ in range(self.reps):
                fn()
            end.record(stream)
            end.synchronize()
        return start.elapsed_time(end) / self.reps / 1e3


def _samples(timer: Callable, fn: Callable[[], Any], device: torch.device,
             path: str, size: int, count: int) -> List[float]:
    """``count`` timer samples of ``fn``, after one untimed warm call."""
    fn()
    return [timer(fn, device, path, size) for _ in range(count)]


def _launches(timer: Callable, device: torch.device, count: int) -> int:
    """Launches of one warm call and ``count`` samples."""
    per = getattr(timer, "launches_per_sample", None)
    return 1 + count * (per(device) if per is not None else 1)


# a body's per-task output (shape, dtype), memoised per (body, task shapes):
# sizing walks the body's plain version on meta tensors, about a second for
# the hydro body.  The value keeps the body alive, so its id stays valid;
# FIFO-bounded.
_OUT_SPECS: Dict[Tuple, Tuple[Any, Tuple[int, ...], torch.dtype]] = {}
_OUT_SPECS_MAX = 64


def _out_like(batched_fn: Callable, stacked: Sequence[torch.Tensor]
              ) -> torch.Tensor:
    """An empty output of the body over ``stacked``: the per-task output is
    sized once on one-slot meta tensors (a body is independent per slot)
    and memoised."""
    key = (id(batched_fn),
           tuple((tuple(a.shape[1:]), a.dtype) for a in stacked))
    memo = _OUT_SPECS.get(key)
    if memo is None:
        spec = batched_fn(*(torch.empty((1,) + tuple(a.shape[1:]),
                                        dtype=a.dtype, device="meta")
                            for a in stacked))
        while len(_OUT_SPECS) >= _OUT_SPECS_MAX:
            _OUT_SPECS.pop(next(iter(_OUT_SPECS)))
        memo = _OUT_SPECS[key] = (batched_fn, tuple(spec.shape[1:]),
                                  spec.dtype)
    return torch.empty((stacked[0].shape[0],) + memo[1], dtype=memo[2],
                       device=stacked[0].device)


def _chunked(chunk: int, k: int) -> bool:
    """Whether a k-slot bucket runs as launches of ``chunk`` slots: a
    chunk that divides it, smaller than it (no padding, ever)."""
    return bool(chunk) and 0 < chunk < k and k % chunk == 0


def _chunked_eval(batched_fn: Callable, chunk: int, *stacked: torch.Tensor,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The body over a bucket as sequential launches of ``chunk`` slots,
    each written into its slice of the bucket's output through ``out=``.
    Bit-identical to the flat call (the body is independent per slot).
    The flat call whenever the chunk does not divide the bucket."""
    k = stacked[0].shape[0] if stacked else 0
    if not _chunked(chunk, k):
        if out is None:
            return batched_fn(*stacked)
        return batched_fn(*stacked, out=out)
    if out is None:
        out = _out_like(batched_fn, stacked)
    for i in range(0, k, chunk):
        batched_fn(*(a.narrow(0, i, chunk) for a in stacked),
                   out=out.narrow(0, i, chunk))
    return out


def s2_width_candidates(wave: int) -> Tuple[int, ...]:
    """The ``s2`` coalesce widths the measurement probes: 1 (one launch
    per task), 2, and the largest power of two fitting the wave."""
    top = 1
    while top * 2 <= wave:
        top *= 2
    return tuple(sorted({1, min(2, wave), top}))


def measure_s2_widths(batched_fn: Callable, parents: Sequence[torch.Tensor],
                      widths: Sequence[int], samples: int = 3,
                      timer: Optional[Callable] = None) -> Dict[int, float]:
    """Time the ``s2`` scatter launch per coalesce width on zero-filled
    parents of the given shapes: one warm call, then the median of
    ``samples`` timer samples each.  Returns {width: seconds per
    launch}."""
    timer = timer or LaunchTimer()
    zeros = tuple(torch.zeros(p.shape, dtype=p.dtype, device=p.device)
                  for p in parents)
    wave = min(p.shape[0] for p in zeros)
    ring = _out_like(batched_fn, zeros)
    out: Dict[int, float] = {}
    for w in sorted(set(widths)):
        if w > wave:
            continue
        scatter = make_s2_scatter(batched_fn, w)
        out[w] = statistics.median(_samples(
            timer, lambda: scatter(ring, 0, *zeros), ring.device, "s2", w,
            max(1, samples)))
    return out


def ladder_candidates(queue_hist: Mapping[int, int], cap: int) -> set:
    """The bucket sizes a ladder derivation considers: observed wave peaks
    clipped to the cap, their cap-split remainders, plus powers of two up
    to the cap."""
    candidates = set()
    for k in queue_hist:
        if k <= 0:
            continue
        candidates.add(min(k, cap))
        if k > cap and k % cap:
            candidates.add(k % cap)
    b = 1
    while b <= cap:
        candidates.add(b)
        b *= 2
    return candidates


def derive_ladder(queue_hist: Mapping[int, int], cap: int, budget: int,
                  cost_model: Optional[BucketCostModel] = None
                  ) -> Tuple[int, ...]:
    """Re-derive a bucket ladder from an observed queue-length histogram.

    From ``{1}`` seeded with the dominant wave's cap decomposition, add
    greedily the candidate (:func:`ladder_candidates`, smallest first)
    that most lowers the per-wave objective, up to ``budget`` buckets.
    The objective is expected launches per wave, or with a cost model the
    predicted time per wave; under the model a final prune drops any
    bucket whose removal does not raise the predicted time and lets the
    search refill the budget.
    """
    queue_hist = {k: c for k, c in queue_hist.items() if k > 0}
    candidates = ladder_candidates(queue_hist, cap)
    use_model = cost_model is not None and cost_model.has_data()

    def cost(ladder):
        ls = sorted(ladder)
        if use_model:
            return sum(c * cost_model.predict_seq(greedy_decomposition(k, ls))
                       for k, c in queue_hist.items())
        return sum(c * greedy_launches(k, ls)
                   for k, c in queue_hist.items())

    ladder = {1}
    peaks = [k for k in queue_hist if k > 0]
    if peaks:
        top = max(peaks, key=lambda k: (queue_hist[k], k))
        seed = {cap, top % cap} if top > cap else {top}
        for b in sorted(seed - {0}, reverse=True):
            if len(ladder) < budget:
                ladder.add(b)

    def grow():
        while len(ladder) < budget:
            best, best_cost = None, cost(ladder)
            for c in sorted(candidates - ladder):
                cc = cost(ladder | {c})
                if cc < best_cost:
                    best, best_cost = c, cc
            if best is None:
                break
            ladder.add(best)

    grow()
    if use_model:
        while True:
            pruned = False
            for b in sorted(ladder - {1}, reverse=True):
                if cost(ladder - {b}) <= cost(ladder):
                    ladder.discard(b)
                    pruned = True
                    break
            if not pruned:
                break
            grow()
    return tuple(sorted(ladder))


def _pk(parents: Sequence[Any]) -> Tuple[Tuple[int, ...], ...]:
    """A parent set's shape key (the reference's ``pk``)."""
    return tuple(tuple(p.shape) if isinstance(p, torch.Tensor)
                 else tuple(p[0]) for p in parents)


def _specs(parents: Sequence[Any]) -> Tuple[Tuple[Tuple[int, ...],
                                                 torch.dtype], ...]:
    """``(shape, dtype)`` of each parent, given as a tensor or as itself."""
    return tuple((tuple(p.shape), p.dtype) if isinstance(p, torch.Tensor)
                 else (tuple(p[0]), p[1]) for p in parents)


def _greedy_sites(n: int, buckets: Sequence[int]) -> List[Tuple[int, int]]:
    """The (slot offset, bucket) of every launch of the greedy drain of an
    ``n``-slot range starting at slot 0."""
    sites, start = [], 0
    for b in greedy_decomposition(n, buckets):
        sites.append((start, b))
        start += b
    return sites


class _Region:
    """One aggregation region: per-TaskSignature queue, bucket ladder, slot
    ring (made at the first per-task submission), its compiled bucket
    programs (``compiled``, the shared ``host_jit`` and ``gather_jit``) and
    the static parents they read, and its tuning state: the inner chunk,
    the wave count and queue-length histogram, the cost model, and the
    parent sets its ranges read (``parent_specs``, by ``pk``: which
    measurements replay); and its containment state: the quarantine list,
    the rungs banned by degraded launches, the wave-relative task counter
    and the circuit breaker.

    On the card the captures a region can hold are bounded by its sites:
    per ``("prefix_aot", b, pk)`` or ``("prefix", b)`` program one graph
    per slot offset a ``b`` launch starts at on the static parent (the
    prefix sums of the drains: 16 at cap 32 over 512 slots, 1 at cap
    512), per ``("ring", b)`` at most ``capacity - b + 1`` offsets on each
    of the ring's two buffers, one graph per static parent for a
    ``("gather", b, pk)`` and one per ``("host", b)``."""

    __slots__ = ("signature", "batched_fn", "queue", "queued_tasks",
                 "buckets", "stats", "ring", "chunk", "chunk_tuned",
                 "waves", "tuned", "_wave_peak", "cost", "_retuned_waves",
                 "_retuned_peak", "warmup_wave", "parent_specs", "_outs",
                 "quarantine", "bad_buckets", "_wave_submitted",
                 "breaker_state", "_breaker_counts", "_breaker_wave_mark",
                 "_breaker_mark", "_breaker_open_waves", "compiled",
                 "host_jit", "gather_jit", "device", "_counters",
                 "_graphs", "ring_staged", "_statics", "_static_src",
                 "_static_readers", "_static_held", "_static_ids")

    def __init__(self, signature: TaskSignature, batched_fn: Callable,
                 buckets: Tuple[int, ...], chunk: int = 0,
                 quarantine_threshold: int = 2,
                 device: torch.device = torch.device("cpu"),
                 counters: Optional[Dict[str, Any]] = None):
        self.signature = signature
        self.batched_fn = batched_fn
        self.queue: List[_Pending] = []
        self.queued_tasks = 0
        self.buckets = buckets
        self.ring: Optional[SlotRing] = None
        self.chunk = chunk            # inner chunk (0 = flat)
        self.chunk_tuned = False      # "auto" tuning ran for this region
        self.waves = 0                # completed waves (queue drained to 0)
        self.tuned = False
        self._wave_peak = 0
        self.cost = BucketCostModel()
        self._retuned_waves = -1      # waves at the last retune
        self._retuned_peak = 0        # largest wave peak at the last retune
        self.warmup_wave = 0          # the wave size warmup was told about
        # pk -> ((shape, dtype), ...) of each parent set a range or warmup
        # read (the reference's ``_aot_parents``)
        self.parent_specs: Dict[Tuple, Tuple] = {}
        self._outs: Dict[Tuple, Tuple] = {}   # chunked outputs' shapes
        self.quarantine = QuarantineList(threshold=quarantine_threshold)
        self.bad_buckets: set = set()     # rungs banned by degraded launches
        self._wave_submitted = 0          # wave-relative task ids
        # circuit breaker: a sliding window of per-wave fault counts; open
        # drains at the bucket-1 floor
        self.breaker_state = "closed"     # closed | open | half_open
        self._breaker_counts: List[int] = []
        self._breaker_wave_mark = 0       # waves at the last breaker tick
        self._breaker_mark = 0            # cumulative faults at that tick
        self._breaker_open_waves = 0      # waves spent open (cooldown)
        self.device = device
        self._counters = counters         # the executor's capture counters
        self.compiled: Dict[Tuple, Callable] = {}
        # graphs: the programs are BucketPrograms, which read fixed inputs
        self._graphs = isinstance(graphs.make_program(self.eval, device),
                                  graphs.BucketProgram)
        self.ring_staged = False          # a ring program was filed
        # (pk, slot) -> a static parent set, the parents last copied into
        # it in this wave, the events of the launches still reading it, and
        # the tensors whose values its positions hold (``write_in_place``)
        self._statics: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}
        self._static_src: Dict[Tuple, Tuple[torch.Tensor, ...]] = {}
        self._static_readers: Dict[Tuple, List[Any]] = {}
        self._static_held: Dict[Tuple, Dict[int, torch.Tensor]] = {}
        # the ids of each static set's tensors -> its key (the sets live as
        # long as the region, so no id is reused while it is a key here)
        self._static_ids: Dict[Tuple[int, ...], Tuple] = {}
        self.reset_compiled()
        self.stats = {"submitted": 0, "launches": 0, "aggregated_hist": {},
                      "queue_hist": {}, "ladder": list(buckets),
                      "measurement_launches": 0, "prior_hits": 0,
                      "breaker": "closed",
                      "faults": {"trips": 0, "bisection_launches": 0,
                                 "failed_tasks": 0, "quarantined": [],
                                 "retries": 0, "compile_failures": 0,
                                 "launch_failures": 0, "timeouts": 0,
                                 "breaker_trips": 0,
                                 "degraded_launches": 0}}

    def ensure_ring(self, capacity: int, example_args: Sequence[torch.Tensor],
                    device: torch.device) -> SlotRing:
        if self.ring is None:
            self.ring = SlotRing(capacity, example_args, device=device)
        return self.ring

    def remember(self, parents: Sequence[torch.Tensor]) -> None:
        self.parent_specs.setdefault(_pk(parents), tuple(
            (tuple(p.shape), p.dtype) for p in parents))

    def expected_peak(self) -> int:
        """The modal observed wave peak (ties to the larger), what the
        adaptive flush policies treat as a full wave; 0 before any wave."""
        qh = self.stats["queue_hist"]
        if not qh:
            return 0
        return max(qh, key=lambda k: (qh[k], k))

    def eval(self, *stacked: torch.Tensor,
             chunk: Optional[int] = None) -> torch.Tensor:
        """The body over a staged bucket, in chunks of the region's inner
        chunk (or ``chunk``)."""
        chunk = self.chunk if chunk is None else chunk
        if not _chunked(chunk, stacked[0].shape[0]):
            return self.batched_fn(*stacked)
        key = tuple((tuple(a.shape), a.dtype) for a in stacked)
        spec = self._outs.get(key)
        if spec is None:
            out = _out_like(self.batched_fn, stacked)
            self._outs[key] = (tuple(out.shape), out.dtype)
        else:
            out = torch.empty(spec[0], dtype=spec[1],
                              device=stacked[0].device)
        return _chunked_eval(self.batched_fn, chunk, *stacked, out=out)

    def apply_prefix(self, start: int, k: int, *parents: torch.Tensor):
        """Contiguous bucket: the body reads ``[start, start+k)`` of each
        parent as a view, with no staging copy."""
        return self.eval(*(p.narrow(0, start, k) for p in parents))

    def apply_gathered(self, idx: torch.Tensor, *parents: torch.Tensor):
        """Any other bucket: one gather per parent feeds the body."""
        return self.eval(*(p.index_select(0, idx) for p in parents))

    # -- the compiled bucket programs --------------------------------------
    def program(self, fn: Callable, **kw) -> Callable:
        """``fn`` as a program: itself on the CPU, a
        :class:`~repro_torch.core.graphs.BucketProgram` on the card whose
        captures the executor's ``stats`` count."""
        return graphs.make_program(fn, self.device, stats=self._counters,
                                   tag=self.signature.kernel, **kw)

    def _prefix_program(self, bucket: int) -> Callable:
        """``(start, *parents)`` -> the body over ``[start, start+bucket)``
        of each parent (a ring buffer or a static parent)."""
        return self.program(functools.partial(self._apply_prefix_at, bucket))

    def _apply_prefix_at(self, bucket: int, start: int, *parents):
        return self.apply_prefix(start, bucket, *parents)

    def compiled_for(self, bucket: int, mode: str = "ring") -> Callable:
        """The ``(mode, bucket)`` program, filed at its first use:
        ``"ring"`` and ``"prefix"`` read a slot run of their inputs in
        place, ``"host"`` is the shared ``host_jit``."""
        key = (mode, bucket)
        fn = self.compiled.get(key)
        if fn is None:
            fn = (self._prefix_program(bucket) if mode in ("ring", "prefix")
                  else self.host_jit)
            self.compiled[key] = fn
        if mode == "ring":
            self.ring_staged = True
        return fn

    def aot_ref(self, bucket: int, pk: Tuple) -> None:
        """File the indexed-gather and contiguous-prefix programs of one
        bucket over one parent set (``pk``)."""
        if ("gather", bucket, pk) not in self.compiled:
            self.compiled[("gather", bucket, pk)] = self.program(
                self.apply_gathered, copy_in=(0,))
        if ("prefix_aot", bucket, pk) not in self.compiled:
            self.compiled[("prefix_aot", bucket, pk)] = \
                self._prefix_program(bucket)

    def aot_ring(self, bucket: int) -> None:
        """File the slot ring's prefix program of one bucket; on the card
        capture it at slot 0 of both ring buffers."""
        self.ring_staged = True
        if ("ring", bucket) not in self.compiled:
            self.compiled[("ring", bucket)] = self._prefix_program(bucket)
        if self._graphs and bucket <= self.ring.capacity:
            for bufs in self.ring.all_buffers():
                self.compiled[("ring", bucket)](0, *bufs)

    def prime(self, pk: Tuple, sites: Sequence[Tuple[int, int]]) -> None:
        """On the card, capture the ``("prefix_aot", b, pk)`` programs at
        the given (slot offset, bucket) sites of the static parent (a
        drain's sites: what warmup and a retune know will launch)."""
        if not self._graphs:
            return
        statics = self.statics_for(self.parent_specs[pk])
        for start, b in sites:
            prog = self.compiled.get(("prefix_aot", b, pk))
            if prog is not None:
                prog(start, *statics)

    def reset_compiled(self) -> None:
        """Drop every program and make the shared ``host_jit`` (the host
        staged bucket, any size; its stacked inputs are copied into each
        graph) and ``gather_jit`` anew.  ``gather_jit`` stays an eager
        launch of the same kernels on the card too: it re-runs any subset
        of a launch's positions for the guard's bisection and serves a
        gather of an unwarmed bucket, as the reference's compiles such a
        shape at first use.  Needed when the inner chunk changes: every
        program baked the old one."""
        self.compiled.clear()
        self.host_jit = self.program(self.eval, copy_in="all")
        self.gather_jit = self.apply_gathered

    # -- the static parents the card's programs read -----------------------
    def statics_for(self, specs: Sequence[Tuple[Tuple[int, ...],
                                                torch.dtype]],
                    slot: int = 0) -> Tuple[torch.Tensor, ...]:
        """Static parent set ``slot`` of one ``pk`` (zeros when made).  Set
        0 is the one warmup primes and other parents are copied into; the
        populations of a wave written in place take sets 0, 1, ... in
        order (:meth:`write_in_place`)."""
        key = (_pk(specs), slot)
        statics = self._statics.get(key)
        if statics is None:
            statics = self._statics[key] = tuple(
                torch.zeros(shape, dtype=dtype, device=self.device)
                for shape, dtype in specs)
            self._static_ids[tuple(map(id, statics))] = key
        return statics

    def _static_key(self, parents: Sequence[torch.Tensor]) -> Optional[Tuple]:
        """The key of the static set ``parents`` is, tensor by tensor, or
        None."""
        return self._static_ids.get(tuple(map(id, parents)))

    def _wait_for_readers(self, key: Tuple) -> None:
        """The caller's stream waits for every launch still reading the
        static set ``key``: what it writes there next comes after them."""
        readers = self._static_readers.pop(key, [])
        if readers:
            stream = torch.cuda.current_stream(self.device)
            for event in readers:
                stream.wait_event(event)

    def write_in_place(self, parents: Sequence[Any], slot: int
                       ) -> Tuple[torch.Tensor, ...]:
        """Static parent set ``slot`` for a population the caller writes
        there itself, on its current stream, once that stream waits for
        every launch still reading the set.  ``parents``: per position a
        ``(shape, dtype)`` the caller writes, or a tensor whose values the
        position must hold (a parent that never changes, such as the cell
        widths), copied in only when the position does not hold that
        tensor's values already (the tensor must keep them)."""
        specs = _specs(parents)
        statics = self.statics_for(specs, slot)
        key = (_pk(specs), slot)
        self._wait_for_readers(key)
        self._static_src.pop(key, None)
        held = self._static_held.setdefault(key, {})
        for j, p in enumerate(parents):
            if isinstance(p, torch.Tensor) and held.get(j) is not p:
                statics[j].copy_(p, non_blocking=True)
                held[j] = p
                if tracing.on():
                    tracing.add("copy_bytes", tracing.nbytes((p,)))
        return statics

    def static_parents(self, parents: Tuple[torch.Tensor, ...]
                       ) -> Tuple[torch.Tensor, ...]:
        """The parents a by-reference launch reads.  On the card: the
        parents themselves where they are a static set (written in place);
        else the ``pk``'s static set 0, into which this wave's parents are
        copied once (at its first launch; later launches of the same
        parents in the wave find them there), after every launch still
        reading it.  The parents themselves on the CPU."""
        if not self._graphs or self._static_key(parents) is not None:
            return parents
        statics = self.statics_for(_specs(parents))
        key = (_pk(parents), 0)
        src = self._static_src.get(key)
        if src is not None and all(a is b for a, b in zip(src, parents)):
            return statics
        self._wait_for_readers(key)
        for dst, p in zip(statics, parents):
            dst.copy_(p, non_blocking=True)
        if self._counters is not None:
            self._counters["static_parent_copies"] = self._counters.get(
                "static_parent_copies", 0) + len(parents)
        if tracing.on():
            tracing.add("copy_bytes", tracing.nbytes(parents))
        self._static_src[key] = parents
        self._static_held.pop(key, None)
        return statics

    def track_static_read(self, launched: Sequence[Any], event) -> None:
        """A launch reading the static set ``launched`` (its parent
        arguments) ends at ``event``: the next write into the set waits
        for it (no-op off the card, or for parents that are no static
        set)."""
        if event is None:
            return
        key = self._static_key(launched)
        if key is not None:
            self._static_readers.setdefault(key, []).append(event)

    def end_wave(self) -> None:
        """The queue drained: the next wave's parents are copied anew."""
        self._static_src.clear()


# inner-chunk choices, memoized per (device, timer, body, bucket, task
# shapes): a chunk timed on one device never serves another.  The value
# keeps the body and the timer alive, so their ids stay valid; FIFO-bounded.
_CHUNK_MEMO: Dict[Tuple, Tuple[Any, Any, int]] = {}
_CHUNK_MEMO_MAX = 32


def _device_key(device: torch.device) -> Tuple[str, str, int]:
    """(type, name, count): what a timed choice is valid for."""
    if device.type == "cuda":
        return ("cuda", torch.cuda.get_device_name(device),
                torch.cuda.device_count())
    return (device.type, "", 1)


def _backend_key(device: torch.device) -> Tuple[str, str, str]:
    """(type, device name, ``"d<count>"``): the identity a stored tuning
    entry is valid for, in the reference's form.  The device count keeps a
    ladder tuned on one card from warm-starting a run over several; the
    CPU's name is ``"cpu"``."""
    kind, name, count = _device_key(device)
    return kind, name or kind, f"d{count}"


class AggregationExecutor:
    """Aggregates submissions of kernel families into bucketed launches.

    ``batched_fn(*stacked_args) -> stacked_out`` takes and returns tensors
    with a leading slot axis; it is registered as the default family under
    ``name``, further families via :meth:`register`.  ``config`` caps the
    bucket size (``max_aggregated``, also each slot ring's capacity), sizes
    the executor pool (``n_executors``: strategy 3 combined with strategy
    2) and picks the staging of per-task submissions (``staging``); its
    tuning knobs (``autotune``, ``cost_model``, ``inner_chunk``,
    ``flush_policy``) act per region.  ``timer(fn, device, path, size)``
    gives one sample of a launch's seconds (default :class:`LaunchTimer`).

    Containment (``guard="finite"``, the launch watchdog, the circuit
    breakers) and ``fault_injector`` (a
    :class:`~repro_torch.core.faults.FaultInjector`) act at dispatch and at
    :meth:`flush`: see :meth:`_launch_tasks` and :meth:`flush`.
    """

    def __init__(self, batched_fn: Optional[Callable] = None,
                 config: Optional[AggregationConfig] = None,
                 pool: Optional[ExecutorPool] = None, name: str = "region",
                 device: DeviceLike = None,
                 buffer_pool: Optional[BufferPool] = None,
                 timer: Optional[Callable] = None,
                 fault_injector: Optional[FaultInjector] = None):
        self.name = name
        self.config = config or AggregationConfig()
        self.device = resolve_device(device)
        self.pool = pool or ExecutorPool(self.config.n_executors,
                                         device=self.device)
        self._staging = self.config.staging
        self.buffers = buffer_pool or BufferPool(
            pinned=self.device.type == "cuda")
        self._buckets = tuple(sorted(self.config.bucket_sizes()))
        ic = self.config.inner_chunk
        self._chunk_auto = ic == "auto"
        self._chunk = 0 if self._chunk_auto else int(ic)
        self._flush_policy = self.config.flush_policy
        self._cost_on = self.config.cost_model
        self._cost_samples = self.config.cost_samples
        self.timer = timer or LaunchTimer()
        cfg = self.config
        # warm start: the store (None: cold, unless REPRO_TUNE_STORE names
        # one) and the analytical prior, made at its first use
        self._store = TuneStore.open(cfg.tune_store)
        self._prior_on = cfg.prior == "roofline"
        self._prior: Optional[RooflinePrior] = None
        self._guard = cfg.guard
        self._injector = fault_injector
        self._max_retries = max(0, int(cfg.max_bucket_retries))
        self._retry_backoff = float(cfg.retry_backoff_s)
        self._retry_backoff_max = max(0.0, float(cfg.retry_backoff_max_s))
        self._qthreshold = max(1, int(cfg.quarantine_threshold))
        self._launch_timeout = max(0.0, float(cfg.launch_timeout_s))
        self._breaker_window = max(0, int(cfg.breaker_window))
        self._breaker_threshold = max(1, int(cfg.breaker_threshold))
        self._breaker_cooldown = max(1, int(cfg.breaker_cooldown))
        # (deadline, completion event, region, bucket) of every launch the
        # watchdog must see complete within its budget
        self._watchdog_records: List[Tuple[float, Any, _Region, int]] = []
        self._guard_records: List[_LaunchRecord] = []
        self._bodies: Dict[str, Callable] = {}
        self._regions: Dict[TaskSignature, _Region] = {}
        self._default_kernel: Optional[str] = None
        # the bucket programs are graphs, which read static parents
        self._graphs_on = isinstance(graphs.make_program(
            lambda: None, self.device), graphs.BucketProgram)
        self.stats = {"submitted": 0, "launches": 0, "aggregated_hist": {},
                      "staging_s": 0.0, "regions": {},
                      # bucket-program graphs captured, and the device
                      # memory their captures reserved (the card only)
                      "captures": 0, "graph_bytes": 0,
                      # tensors copied into static parents (the card only)
                      "static_parent_copies": 0,
                      "warm_start": False,   # a region restored from store
                      "flush_policy": (dict(self._flush_policy)
                                       if isinstance(self._flush_policy,
                                                     Mapping)
                                       else self._flush_policy)}
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

    def set_fault_injector(self,
                           injector: Optional[FaultInjector]) -> None:
        """Attach (or detach, with None) a deterministic fault schedule:
        payload faults on launch outputs, ring corruption at submission,
        compile and launch faults at dispatch."""
        self._injector = injector

    def _resolve_kernel(self, kernel: Optional[str]) -> str:
        kernel = kernel or self._default_kernel
        if kernel is None:
            raise RuntimeError("no kernel family registered — pass "
                               "batched_fn to the constructor or register()")
        return kernel

    def _region_for(self, kernel: str, args: Sequence[Any]) -> _Region:
        return self._region_of(TaskSignature.from_args(kernel, args))

    def _region_of(self, sig: TaskSignature) -> _Region:
        kernel = sig.kernel
        region = self._regions.get(sig)
        if region is None:
            body = self._bodies.get(kernel)
            if body is None:
                raise KeyError(f"no batched body registered for kernel "
                               f"{kernel!r} (have {sorted(self._bodies)})")
            region = _Region(sig, body, self._buckets, chunk=self._chunk,
                             quarantine_threshold=self._qthreshold,
                             device=self.device, counters=self.stats)
            self._regions[sig] = region
            self.stats["regions"][sig.describe()] = region.stats
        return region

    @property
    def regions(self) -> Dict[TaskSignature, _Region]:
        """The live region registry (a copy)."""
        return dict(self._regions)

    @property
    def ring(self) -> Optional[SlotRing]:
        """The slot ring of the sole region (None with several regions, or
        before a per-task submission or warmup made one)."""
        if len(self._regions) != 1:
            return None
        return next(iter(self._regions.values())).ring

    # -- warmup ------------------------------------------------------------
    def warmup(self, parent_shapes: Optional[Sequence[Tuple[
            Tuple[int, ...], torch.dtype]]] = None, *,
               example_args: Optional[Sequence[torch.Tensor]] = None,
               kernel: Optional[str] = None,
               buckets: Optional[Sequence[int]] = None,
               store: Optional[Any] = None) -> None:
        """Make each ladder bucket's programs (or each of ``buckets``') and
        pay every first-launch cost before the timed run, in the
        reference's two modes, combinable:

        * ``parent_shapes`` — the ``(shape, dtype)`` of the parents a
          range or an indexed submission will read: files the
          ``("gather", b, pk)`` and ``("prefix_aot", b, pk)`` programs and
          launches each prefix program on every executor's stream, on the
          zero-filled parents (on the card: the region's static parent,
          where the programs are captured at slot 0 and at every slot
          offset of the warmed wave's greedy drain); under device staging
          also launches each bucket once on the family's slot ring, which
          this makes, eagerly (the ring's programs are filed at its first
          ring launch, as the reference's are).
        * ``example_args`` — one task's inputs: files the slot ring's
          ``("ring", b)`` programs (device staging; captured at slot 0 of
          both buffers on the card) or the ``("host", b)`` programs (host
          staging; captured over a zero-filled bucket).

        Builds the kernels at first use.  Launch statistics are not
        touched.  A tune store (``store``, a path or a ``TuneStore``, else
        the config's) with an entry for this family on this device
        restores its tuned state first (:meth:`_restore_region`);
        otherwise, under ``prior="roofline"``, the roofline prior seeds its
        cost model and ladder (:meth:`_seed_prior`).  Either way the
        installed ladder's decomposition of the wave is warmed too.  Under
        ``inner_chunk="auto"`` the chunks are timed (unless restored);
        under ``cost_model=True`` the buckets without a time are timed
        through their programs, and, for the ``mixed`` strategy's choice,
        the ``s2`` widths and the whole-wave launch, unless the prior
        seeded the region (its first retune measures): a restored region
        measures nothing.  A capture is not a measurement launch."""
        kernel = self._resolve_kernel(kernel)
        if parent_shapes is None and example_args is None:
            raise ValueError("warmup needs parent_shapes and/or "
                             "example_args")
        if store is not None:
            self._store = TuneStore.open(store)
        if parent_shapes is not None:
            self._warmup_parents(kernel, parent_shapes, buckets)
        if example_args is not None:
            self._warmup_example(kernel, tuple(example_args), buckets)

    @staticmethod
    def _aot_buckets(region: _Region,
                     buckets: Optional[Sequence[int]]) -> Tuple[int, ...]:
        want = region.buckets if buckets is None else tuple(sorted(buckets))
        if region.stats.get("tuned_by") in ("store", "prior"):
            # the installed ladder is what the drain launches: warm its
            # decomposition of the wave too
            want = tuple(sorted(set(want).union(
                greedy_decomposition(region.warmup_wave, region.buckets))))
        return want

    def _warmup_parents(self, kernel: str, parent_shapes, buckets) -> None:
        parents = tuple(torch.zeros(shape, dtype=dtype, device=self.device)
                        for shape, dtype in parent_shapes)
        region = self._region_for(kernel, [SlotView(p, 0) for p in parents])
        region.remember(parents)
        pk = _pk(parents)
        restored = self._restore_region(region)
        n_parent = min(p.shape[0] for p in parents)
        region.warmup_wave = max(region.warmup_wave, n_parent)
        if self._chunk_auto and not region.chunk_tuned:
            self._tune_chunk(region, parents)
        if (self._prior_on and not restored and not region.cost.measured()
                and not region.cost.seeded()):
            self._seed_prior(region, parent_shapes)
        want = self._aot_buckets(region, buckets)
        for b in want:
            if b <= n_parent:
                region.aot_ref(b, pk)
        launch = (region.statics_for(parent_shapes) if region._graphs
                  else parents)
        ring = None
        if self._staging == "device":
            ring = region.ensure_ring(self.config.max_aggregated,
                                      [p[0] for p in parents], self.device)
        for ex in self.pool.executors:
            for b in want:
                if b <= n_parent:
                    ex.run(region.compiled[("prefix_aot", b, pk)], 0,
                           *launch)
                if ring is not None:
                    ex.run(region.apply_prefix, 0, b, *ring.buffers())
                    ring.track_read(0, b, ex.last_event)
        region.prime(pk, _greedy_sites(n_parent, [
            b for b in region.buckets if b <= n_parent]))
        self._sync()
        if self._cost_on and not region.cost.seeded():
            self._measure_region(region, want, parents)

    def _warmup_example(self, kernel: str, args: Tuple[torch.Tensor, ...],
                        buckets) -> None:
        region = self._region_for(kernel, args)
        restored = self._restore_region(region)
        specs = [(tuple(a.shape), a.dtype) for a in args]
        cap = self.config.max_aggregated
        if self._chunk_auto and not region.chunk_tuned:
            # a pseudo-parent of the largest bucket's stacked shape
            self._tune_chunk(region, self._zeros(
                [((max(region.buckets),) + shape, dt) for shape, dt in specs]))
        if (self._prior_on and not restored and not region.cost.measured()
                and not region.cost.seeded()):
            # the wave is unknown before traffic: the cap bounds it
            self._seed_prior(region, [((cap,) + shape, dt)
                                      for shape, dt in specs])
        want = self._aot_buckets(region, buckets)
        if self._staging == "device":
            ring = region.ensure_ring(cap, args, self.device)
            for b in want:
                region.aot_ring(b)
            self._sync()
            if self._cost_on and not region.cost.seeded():
                self._measure_region(region, want, ring.buffers(),
                                     alt_paths=False, ring=True)
            return
        for b in want:
            prog = region.compiled[("host", b)] = region.program(
                region.eval, copy_in="all")
            if region._graphs:
                prog(*self._zeros([((b,) + shape, dt)
                                   for shape, dt in specs]))
        self._sync()

    # -- persistent warm start (DESIGN.md §13) -----------------------------
    def _restore_region(self, region: _Region) -> bool:
        """Install the store's entry for this region on this device, if
        there is one: the ladder (validated: a store is data), the inner
        chunk, every cost path's table (tagged ``"store"``, so the
        measurements skip those buckets), the queue histogram and the
        strategy selection.  The region comes up tuned; a wave peak beyond
        the stored histogram re-arms the tuner, as after a live retune.  A
        malformed entry warns (:class:`TuneStoreWarning`) and leaves the
        region cold.  Returns whether the region is restored."""
        if region.stats.get("tuned_by") == "store":
            return True                      # a repeated warmup
        if self._store is None:
            return False
        entry = self._store.get(_backend_key(self.device),
                                region.signature.describe())
        if not entry:
            return False
        try:
            ladder = validate_ladder([int(b) for b in entry["ladder"]],
                                     self.config.max_aggregated)
            cost_tables = {
                str(path): {int(b): float(t) for b, t in dict(table).items()}
                for path, table in dict(entry.get("cost_model",
                                                  {})).items()}
            queue_hist = {int(k): int(v) for k, v in dict(
                entry.get("queue_hist", {})).items()}
            chunk = entry.get("inner_chunk")
            chunk = None if chunk is None else int(chunk)
        except (KeyError, TypeError, ValueError) as err:
            warnings.warn(
                f"tune store entry for {region.signature.describe()} is "
                f"unusable ({err}) — falling back to cold-start "
                f"measurement", TuneStoreWarning, stacklevel=3)
            return False
        if chunk is not None:
            self._set_chunk(region, chunk)
        for path, table in cost_tables.items():
            for b, sec in sorted(table.items()):
                region.cost.record(b, sec, path=path, source="store")
        region.buckets = ladder
        region.stats["ladder"] = list(ladder)
        qh = region.stats["queue_hist"]
        for k, c in queue_hist.items():
            qh[k] = qh.get(k, 0) + c
        region.warmup_wave = max(region.warmup_wave,
                                 int(entry.get("warmup_wave", 0) or 0))
        region.tuned = True
        region._retuned_waves = region.waves
        region._retuned_peak = max(queue_hist, default=0)
        for k in ("selected_strategy", "strategy_costs"):
            if k in entry:
                region.stats[k] = entry[k]
        if region.cost.measured():
            region.stats["cost_model"] = region.cost.as_stats()
        if len(region.cost.paths()) > 1:
            region.stats["cost_model_paths"] = region.cost.as_stats_paths()
        region.stats["tuned_by"] = "store"
        region.stats["cost_sources"] = {
            p: dict(t) for p, t in region.cost.sources().items()}
        region.stats["warm_start"] = True
        self.stats["warm_start"] = True
        return True

    def _seed_prior(self, region: _Region, parent_shapes: Sequence[
            Tuple[Tuple[int, ...], torch.dtype]]) -> None:
        """First contact without a timer: fill the region's cost model with
        roofline estimates (every candidate bucket of the wave on
        ``"s3"``, the ``s2`` widths, the whole wave on ``"fused"``), then
        derive the ladder from them.  The entries are tagged ``"prior"``
        and the region stays untuned: its first retune measures and
        retires them."""
        wave = min(shape[0] for shape, _ in parent_shapes)
        if not wave:
            return
        if self._prior is None:
            self._prior = RooflinePrior(_backend_key(self.device))
        task_specs = tuple((tuple(shape[1:]), dtype)
                           for shape, dtype in parent_shapes)
        fn = region.batched_fn
        cap = self.config.max_aggregated
        for b in sorted(ladder_candidates({wave: 1}, cap)):
            region.cost.seed_prior(b, self._prior.predict(fn, task_specs, b))
        for w in s2_width_candidates(wave):
            region.cost.seed_prior(w, self._prior.predict(fn, task_specs, w),
                                   path="s2")
        region.cost.seed_prior(wave, self._prior.predict(fn, task_specs,
                                                         wave),
                               path="fused")
        ladder = validate_ladder(
            derive_ladder({wave: 1}, cap, self.config.compile_budget,
                          region.cost), cap)
        region.buckets = ladder
        region.stats["ladder"] = list(ladder)
        region.stats["tuned_by"] = "prior"
        region.stats["cost_sources"] = {
            p: dict(t) for p, t in region.cost.sources().items()}
        region.stats["prior_hits"] = region.cost.prior_hits

    def _persist_region(self, region: _Region,
                        store: Optional[TuneStore] = None) -> None:
        """Put one region's tuned state into the store (measured medians
        only: priors are seeds, not knowledge)."""
        store = self._store if store is None else store
        entry: Dict[str, Any] = {
            "cost_model": {path: {str(b): region.cost.time(b, path)
                                  for b in region.cost.buckets(path)}
                           for path in region.cost.paths()},
            "ladder": [int(b) for b in region.buckets],
            "inner_chunk": int(region.chunk),
            "queue_hist": {str(k): int(v)
                           for k, v in region.stats["queue_hist"].items()},
            "warmup_wave": int(region.warmup_wave),
            "tuned_by": region.stats.get("tuned_by", "measured"),
        }
        for k in ("selected_strategy", "strategy_costs"):
            if k in region.stats:
                entry[k] = region.stats[k]
        store.put(_backend_key(self.device), region.signature.describe(),
                  entry)

    def save_tuning(self, store: Optional[Any] = None) -> Optional[str]:
        """Put every tuned or measured region into the tune store (the
        executor's, or ``store``, a path or a ``TuneStore``) and write it
        atomically.  Returns the store file's path, or None without a
        store."""
        target = TuneStore.open(store) if store is not None else self._store
        if target is None:
            return None
        wrote = False
        for region in self._regions.values():
            if region.tuned or region.cost.measured():
                self._persist_region(region, target)
                wrote = True
        if wrote or len(target) == 0:
            target.save()
        return target.path

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _zeros(self, specs: Tuple) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.zeros(shape, dtype=dtype, device=self.device)
                     for shape, dtype in specs)

    def _sample(self, region: _Region, fn: Callable[[], Any], path: str,
                size: int) -> List[float]:
        """``cost_samples`` timer samples of one launch program."""
        region.stats["measurement_launches"] += _launches(
            self.timer, self.device, self._cost_samples)
        return _samples(self.timer, fn, self.device, path, size,
                        self._cost_samples)

    # -- inner chunk and bucket cost measurement ---------------------------
    def _tune_chunk(self, region: _Region, parents: Sequence[torch.Tensor],
                    force: bool = False) -> None:
        """``inner_chunk="auto"``: time the body on the region's largest
        bucket that fits the parents over the chunks 0 (flat), 2, 4 and 8,
        each the fastest of 3 samples, and keep the fastest.  Memoized per
        (device, timer, body, bucket, task shapes); ``force`` (a retune's
        re-sweep) bypasses the memo and overwrites it."""
        n_parent = min(p.shape[0] for p in parents)
        b = max((x for x in region.buckets if x <= n_parent), default=0)
        if b < 2:
            return
        key = (_device_key(self.device), id(self.timer),
               id(region.batched_fn), b,
               tuple((tuple(p.shape[1:]), p.dtype) for p in parents))
        memo = _CHUNK_MEMO.get(key)
        if memo is not None and not force:
            self._set_chunk(region, memo[2])
            return
        stacked = tuple(torch.zeros((b,) + tuple(p.shape[1:]), dtype=p.dtype,
                                    device=self.device) for p in parents)
        best_chunk, best_t = 0, float("inf")
        for c in (0, 2, 4, 8):
            if c >= b or (c and b % c):
                continue
            # the program the drain would launch at this chunk (a graph on
            # the card, captured here and dropped after)
            prog = region.program(functools.partial(region.eval, chunk=c))
            region.stats["measurement_launches"] += _launches(
                self.timer, self.device, 3)
            t = min(_samples(self.timer, lambda p=prog: p(*stacked),
                             self.device, "chunk", c, 3))
            if t < best_t:
                best_chunk, best_t = c, t
        while len(_CHUNK_MEMO) >= _CHUNK_MEMO_MAX:
            _CHUNK_MEMO.pop(next(iter(_CHUNK_MEMO)))
        _CHUNK_MEMO[key] = (region.batched_fn, self.timer, best_chunk)
        self._set_chunk(region, best_chunk)

    @staticmethod
    def _set_chunk(region: _Region, chunk: int) -> None:
        region.chunk = chunk
        region.chunk_tuned = True
        region.stats["inner_chunk"] = chunk

    def _measure_region(self, region: _Region, buckets: Sequence[int],
                        parents: Sequence[torch.Tensor],
                        alt_paths: bool = True, ring: bool = False) -> None:
        """Time each bucket's program, the one the drain launches, into the
        region's cost model: the ``("prefix_aot", b, pk)`` program on
        ``parents`` (zero-filled; on the card the region's static parent
        of their shape), or with ``ring`` the ``("ring", b)`` program on
        the ring's buffers, at slot 0; buckets with samples already are
        skipped (and get no program).  ``alt_paths``: also the ``s2``
        widths and the whole-wave launch (:meth:`_measure_alt_paths`)."""
        n_slots = min(p.shape[0] for p in parents)
        if ring:
            launch = tuple(parents)
        else:
            pk = _pk(parents)
            launch = (region.statics_for(tuple(
                (tuple(p.shape), p.dtype) for p in parents))
                if region._graphs else tuple(parents))
        for b in sorted(set(buckets)):
            if b > n_slots or region.cost.time(b) is not None:
                continue
            if ring:
                region.aot_ring(b)
                prog = region.compiled[("ring", b)]
            else:
                region.aot_ref(b, pk)
                prog = region.compiled[("prefix_aot", b, pk)]
            for t in self._sample(
                    region, lambda p=prog: p(0, *launch), "s3", b):
                region.cost.record(b, t)
        if alt_paths:
            self._measure_alt_paths(region, parents)
        if region.cost.measured():
            region.stats["cost_model"] = region.cost.as_stats()
        if len(region.cost.paths()) > 1:
            region.stats["cost_model_paths"] = region.cost.as_stats_paths()

    def _measure_alt_paths(self, region: _Region,
                           parents: Sequence[torch.Tensor]) -> None:
        """Time the other strategies' launches for this family, so
        ``select_strategy`` compares measured times: the ``s2`` scatter per
        coalesce width (:func:`s2_width_candidates`) and the whole-wave
        body.  A family routed explicitly to ``"s3"`` or ``"fused"``
        probes nothing; one routed to ``"s2"`` only the widths (the ``s2``
        strategy sizes its launches from them)."""
        wave = min(p.shape[0] for p in parents)
        if not wave or region.breaker_state != "closed":
            # a family whose breaker is not closed is pinned to s3
            return
        route = resolve_family_option(self.config.family_strategies,
                                      region.signature.kernel, "auto")
        if route in ("auto", "s2") and not region.cost.measured("s2"):
            widths = measure_s2_widths(region.batched_fn, parents,
                                       s2_width_candidates(wave),
                                       samples=self._cost_samples,
                                       timer=self.timer)
            region.stats["measurement_launches"] += len(widths) * _launches(
                self.timer, self.device, self._cost_samples)
            for w, t in widths.items():
                region.cost.record(w, t, path="s2")
        if route == "auto" and not region.cost.measured("fused"):
            for t in self._sample(region,
                                  lambda: region.batched_fn(*parents),
                                  "fused", wave):
                region.cost.record(wave, t, path="fused")

    # -- per-family strategy selection -------------------------------------
    def strategy_costs(self, kernel: str) -> Dict[str, Any]:
        """Predicted milliseconds per wave of ``kernel``'s family under
        each measured strategy, and the ``s2`` width; empty before any
        measurement."""
        region = self._primary_region(kernel)
        if region is None:
            return {}
        wave = region.expected_peak() or region.warmup_wave
        if not wave:
            return {}
        out: Dict[str, Any] = {}
        if region.cost.has_data("s3"):
            ladder = [b for b in region.buckets
                      if b not in region.bad_buckets] or [1]
            out["s3"] = round(region.cost.predict_seq(
                greedy_decomposition(wave, ladder)) * 1e3, 4)
        s2 = region.cost.predict_s2_wave(wave)
        if s2 is not None:
            out["s2"] = round(s2[1] * 1e3, 4)
            out["s2_width"] = s2[0]
        if region.cost.has_data("fused"):
            out["fused"] = round(region.cost.predict(wave, "fused") * 1e3, 4)
        return out

    def select_strategy(self, kernel: str) -> str:
        """The cheapest measured strategy for ``kernel``'s wave (``"s3"``,
        ``"s2"`` or ``"fused"``; ties prefer ``"s3"``, then ``"s2"``);
        ``"s3"`` before any measurement, and while the family's breaker is
        not closed (only ``s3`` has the bucket-1 floor and bisection).
        The choice and its costs go into ``stats["regions"][fam]``."""
        costs = self.strategy_costs(kernel)
        order = ("s3", "s2", "fused")
        timed = [(costs[s], order.index(s)) for s in order if s in costs]
        selected = order[min(timed)[1] if timed else 0]
        if self.breaker_state(kernel) != "closed":
            selected = "s3"
        self._record(kernel, selected, costs)
        return selected

    def record_selection(self, kernel: str, selected: str) -> None:
        """Record an explicit route (``family_strategies``) in the region
        stats, beside whatever costs exist."""
        self._record(kernel, selected, self.strategy_costs(kernel))

    def _record(self, kernel: str, selected: str,
                costs: Dict[str, Any]) -> None:
        region = self._primary_region(kernel)
        if region is None:
            return
        region.stats["selected_strategy"] = selected
        if costs:
            region.stats["strategy_costs"] = costs

    def _primary_region(self, kernel: str) -> Optional[_Region]:
        """The region selection reasons about for a kernel: the one with
        the largest wave (one region per task shape)."""
        regs = [r for s, r in self._regions.items() if s.kernel == kernel]
        if not regs:
            return None
        return max(regs, key=lambda r: (r.expected_peak() or r.warmup_wave))

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
        if self._injector is not None:
            # ring site: this task's staged inputs go bad between
            # submission and launch
            bad = self._injector.corrupt_ring(kernel, region.waves,
                                              region._wave_submitted)
            if bad is not None:
                ring.poison(slot, bad)
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

    @property
    def writes_in_place(self) -> bool:
        """Whether by-reference launches read static parents, which a
        population can be written into (:meth:`population_buffers`)."""
        return self._graphs_on and self._staging == "device"

    def population_buffers(self, requests: Sequence[Tuple[
            str, Sequence[Any]]]) -> Optional[List[Tuple[torch.Tensor, ...]]]:
        """The tensors a wave's populations may be written into in place,
        so that their launches read them where they are, with no copy into
        a static parent: per request ``(kernel, parents)``, each parent a
        ``(shape, dtype)`` with the leading task axis or a tensor whose
        values never change, the static parent set of that family's region
        (:meth:`_Region.write_in_place`).  Populations of one region take
        static sets of their own, in request order.  The caller's current
        stream first waits for every launch still reading them; the caller
        writes them on that stream and submits them (``submit_range``)
        before the next request.  None where launches read no static
        parent (off the card, under host staging, inside a capture): the
        caller makes its own tensors."""
        if not self.writes_in_place or (
                self.device.type == "cuda"
                and torch.cuda.is_current_stream_capturing()):
            return None
        slots: Dict[Tuple, int] = {}
        out = []
        for kernel, parents in requests:
            specs = _specs(parents)
            region = self._region_of(TaskSignature.from_parents(
                self._resolve_kernel(kernel), specs))
            key = (id(region), _pk(specs))
            slot = slots[key] = slots.get(key, -1) + 1
            out.append(region.write_in_place(parents, slot))
        return out

    def _enqueue(self, region: _Region, entry: _Pending) -> None:
        self._check_mode(region, entry)
        # wave-relative task identity: the position in the current wave,
        # what payload specs and the quarantine list key on
        entry.wave_index = region._wave_submitted
        region._wave_submitted += entry.count
        region.queue.append(entry)
        region.queued_tasks += entry.count
        region._wave_peak = max(region._wave_peak, region.queued_tasks)
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
        reached, or when an executor is idle and the flush policy agrees
        that draining the partial queue now pays; otherwise keep
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
                      and self.pool.any_idle()
                      and self._idle_drain_pays(region, q)):
                    self._launch(region, self._largest_bucket(region, q))
                    progress = True

    def _policy_for(self, region: _Region) -> str:
        """The region's flush policy (per family for a mapping: exact
        kernel, the ``+epi`` twin's base, ``"*"``, then eager)."""
        return resolve_family_option(self._flush_policy,
                                     region.signature.kernel, "eager")

    def _idle_drain_pays(self, region: _Region, q: int) -> bool:
        """Should a partial queue of ``q`` tasks drain into an idle
        executor now?  ``eager``: always.  ``watermark``: only at or past
        the learned wave peak.  ``cost``: when the cost model predicts the
        split drain (q now, the rest later) no slower than the whole wave
        at once (eager without a model).  Every non-eager consultation is
        counted in ``stats["regions"][fam]["flush_decisions"]``."""
        policy = self._policy_for(region)
        if policy == "eager":
            return True
        trace = region.stats.setdefault(
            "flush_decisions", {"policy": policy, "consulted": 0,
                                "full_wave": 0, "drained_early": 0,
                                "held": 0})
        trace["consulted"] += 1
        peak = region.expected_peak()
        if not peak or q >= peak:
            trace["full_wave"] += 1
            return True
        if policy == "watermark":
            trace["held"] += 1
            return False
        if not region.cost.measured():
            trace["drained_early"] += 1
            return True
        split = (region.cost.predict_seq(
                     greedy_decomposition(q, region.buckets))
                 + region.cost.predict_seq(
                     greedy_decomposition(peak - q, region.buckets)))
        full = region.cost.predict_seq(
            greedy_decomposition(peak, region.buckets))
        pays = split <= full
        trace["drained_early" if pays else "held"] += 1
        return pays

    @staticmethod
    def _largest_bucket(region: _Region, k: int) -> int:
        if region.breaker_state == "open":
            # an open breaker drains at the never-banned bucket-1 floor
            return 1
        best = region.buckets[0]
        for b in region.buckets:
            # rungs banned by degraded launches are skipped; bucket 1 is
            # never banned
            if b <= k and b not in region.bad_buckets:
                best = b
        if best > k:
            raise RuntimeError(
                f"bucket {best} exceeds queue length {k} — ladder "
                f"{region.buckets} lacks a remainder bucket")
        return best

    @staticmethod
    def _take(region: _Region, k: int) -> List[_Pending]:
        """Pop k tasks' worth of entries off the queue, splitting a range
        entry at the bucket boundary."""
        taken, region.queue = _split_taken(region.queue, k)
        region.queued_tasks -= k
        return taken

    def _launch(self, region: _Region, k: int) -> None:
        tasks = self._take(region, k)
        mode = _entry_mode(tasks[0])
        self._launch_tasks(region, tasks, k, mode)
        if mode == "ring" and not region.queue:
            region.ring.swap()    # in-flight launches keep the old buffer
        if not region.queue:
            region.end_wave()
            self._wave_complete(region)

    def _stage(self, region: _Region, tasks: List[_Pending], k: int,
               mode: str):
        """One bucket's program and arguments, and the recipe that runs
        any subset of its positions again: ``(fn, call_args, parents,
        indices)``, the program looked up as the reference's ``_stage``
        does.  Ref: a contiguous slot run is ``("prefix_aot", k, pk)``
        (else ``("prefix", k)``) at its first slot, anything else
        ``("gather", k, pk)`` (else ``gather_jit``) by index, both over
        the region's static parents on the card; ring: ``("ring", k)`` at
        the run's first slot of the active ring buffer; host:
        ``("host", k)`` (else ``host_jit``) over the stacked bucket.  The
        recipe is built only under the guard (None otherwise): the
        submitted parents, the bucket's ring slice copied on the caller's
        stream (later writes into the ring are ordered after it), or the
        stacked batch."""
        guard = self._guard == "finite"
        if mode == "ring":
            first = tasks[0].slot
            rings = region.ring.buffers()
            recipe = (None, None)
            if guard:
                recipe = (tuple(r.narrow(0, first, k).clone() for r in rings),
                          list(range(k)))
            return (region.compiled_for(k, "ring"), (first,) + rings) + recipe
        if mode == "host":
            stacked = tuple(self._stack([t.args[j] for t in tasks])
                            for j in range(len(tasks[0].args)))
            return (region.compiled.get(("host", k), region.host_jit),
                    stacked, stacked, list(range(k)) if guard else None)
        indices: List[int] = []
        for t in tasks:
            i0 = t.views[0].index
            indices.extend(range(i0, i0 + t.count))
        parents = tuple(v.parent for v in tasks[0].views)
        region.remember(parents)
        pk = _pk(parents)
        launch = region.static_parents(parents)
        if indices == list(range(indices[0], indices[0] + k)):
            fn = (region.compiled.get(("prefix_aot", k, pk))
                  or region.compiled_for(k, "prefix"))
            return fn, (indices[0],) + launch, parents, indices
        idx = torch.tensor(indices, device=parents[0].device)
        fn = region.compiled.get(("gather", k, pk)) or region.gather_jit
        return fn, (idx,) + launch, parents, indices

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
                      mode: str, degraded: bool = False) -> None:
        """Stage and dispatch one bucket of taken tasks and fulfil their
        futures.  An injected payload fault and, under ``guard="finite"``,
        the bucket's finite reduction run on the launch's executor stream
        right after it (its completion event covers both); the launch is
        recorded for the audit at :meth:`flush`.  A compile or launch
        fault degrades the bucket (:meth:`_degrade`) instead of
        propagating."""
        with tracing.span("repro_torch.agg.launch", region.signature.kernel):
            t0 = time.perf_counter()
            with tracing.span("repro_torch.agg.stage"):
                fn, call_args, parents, indices = self._stage(region, tasks, k,
                                                              mode)
            self.stats["staging_s"] += time.perf_counter() - t0
            try:
                out, ex = self._dispatch(region, fn, call_args, k)
            except (BucketCompileError, LaunchFaultError,
                    LaunchTimeoutError) as err:
                self._degrade(region, tasks, k, mode, err)
                return
            if mode == "ring":
                region.ring.track_read(tasks[0].slot, tasks[0].slot + k,
                                       ex.last_event)
            elif mode == "ref":
                region.track_static_read(call_args[1:], ex.last_event)
            wave_ids: List[int] = []
            for t in tasks:
                wave_ids.extend(range(t.wave_index, t.wave_index + t.count))
            poisoned: Dict[int, str] = {}
            hit = {}
            if self._injector is not None:
                # payload site: the matched tasks' outputs go non-finite
                hit = self._injector.poison_positions(
                    region.signature.kernel, region.waves, wave_ids)
                poisoned = {wave_ids[p]: m for p, m in hit.items()}
            verdict = True
            if hit or self._guard == "finite":
                verdict = ex.follow(self._poison_and_check, out, hit,
                                    self._guard == "finite")
            slot = 0
            for t in tasks:
                if isinstance(t.future, RangeFuture):
                    t.future._fulfil_range(out, slot, t.fut_offset, t.count)
                else:
                    t.future._fulfil(out, slot)
                slot += t.count
            if self._guard == "finite":
                self._guard_records.append(_LaunchRecord(
                    region=region, out=out, k=k, parents=parents,
                    indices=indices, tasks=list(tasks), wave_ids=wave_ids,
                    wave=region.waves, poisoned=poisoned, verdict=verdict))
            self.stats["launches"] += 1
            hist = self.stats["aggregated_hist"]
            hist[k] = hist.get(k, 0) + 1
            region.stats["launches"] += 1
            rhist = region.stats["aggregated_hist"]
            rhist[k] = rhist.get(k, 0) + 1
            if degraded:
                region.stats["faults"]["degraded_launches"] += 1

    @staticmethod
    def _poison_and_check(out: torch.Tensor, hit: Dict[int, str],
                          check: bool):
        """On the launch's stream: poison the injected positions of a
        fresh output in place, then (``check``) issue its finite
        reduction."""
        if hit:
            poison_slots(out, sorted(hit), hit, inplace=True)
        return all_finite_async(out) if check else True

    def _dispatch(self, region: _Region, fn: Callable, call_args, k: int
                  ) -> Tuple[torch.Tensor, DeviceExecutor]:
        """One pool launch with the dispatch-site injection and bounded
        retries: launch faults and injected hangs are transient by
        assumption (retried with exponential backoff from
        ``retry_backoff_s``, each sleep capped at ``retry_backoff_max_s``),
        compile faults deterministic (never retried).  Under
        ``launch_timeout_s`` the launch's completion event is recorded for
        the watchdog at :meth:`flush`.  Only these three fault types are
        caught: a real build, load or launch error propagates unchanged.
        Returns the output and the executor it runs on."""
        kern = region.signature.kernel
        faults = region.stats["faults"]
        attempts = 0
        while True:
            try:
                inj = self._injector
                if inj is not None:
                    if inj.compile_fails(kern, k):
                        faults["compile_failures"] += 1
                        raise BucketCompileError(
                            f"injected compile failure: kernel {kern!r} "
                            f"bucket {k}")
                    lf = inj.launch_fault(kern, k)
                    if lf is not None:
                        self._injected_launch_fault(kern, k, faults, *lf)
                ex = self.pool.get()
                out = ex.launch(fn, *call_args, family=kern)
                if self._launch_timeout:
                    self._watchdog_records.append(
                        (time.monotonic() + self._launch_timeout,
                         ex.last_event, region, k))
                return out, ex
            except BucketCompileError:
                raise
            except (LaunchFaultError, LaunchTimeoutError):
                if attempts >= self._max_retries:
                    raise
                attempts += 1
                faults["retries"] += 1
                if self._retry_backoff:
                    time.sleep(min(
                        self._retry_backoff * (2 ** (attempts - 1)),
                        self._retry_backoff_max))

    def _injected_launch_fault(self, kern: str, k: int,
                               faults: Dict[str, Any], mode: str,
                               delay: float) -> None:
        """An injected launch fault: ``delay`` stalls the dispatch,
        ``hang`` raises :class:`LaunchTimeoutError` after a token wait
        (or, with no watchdog budget, :class:`RegionFaultError`: the
        stall would never end), ``fail`` raises
        :class:`LaunchFaultError`."""
        if mode == "delay":
            time.sleep(delay)
        elif mode == "hang":
            if not self._launch_timeout:
                raise RegionFaultError(
                    f"injected hang: kernel {kern!r} bucket {k} would stall "
                    f"the drain forever (no watchdog — set "
                    f"AggregationConfig.launch_timeout_s)")
            # the consumed budget, modelled without parking for all of it
            time.sleep(min(self._launch_timeout, 0.01))
            faults["timeouts"] += 1
            raise LaunchTimeoutError(
                f"launch of kernel {kern!r} bucket {k} hung past "
                f"launch_timeout_s={self._launch_timeout}")
        else:
            faults["launch_failures"] += 1
            raise LaunchFaultError(
                f"injected launch failure: kernel {kern!r} bucket {k}")

    def _degrade(self, region: _Region, tasks: List[_Pending], k: int,
                 mode: str, err: Exception) -> None:
        """Ban the failing rung and re-drain the taken tasks greedily
        through the remaining rungs, down to bucket 1.  A failure at
        bucket 1 has nowhere smaller to go: those tasks fail, with the
        dispatch error attached to their futures."""
        if k == 1:
            self._fail_tasks(region, tasks, err)
            return
        region.bad_buckets.add(k)
        remaining = list(tasks)
        n_left = sum(t.count for t in remaining)
        while n_left:
            good = [b for b in region.buckets
                    if b <= n_left and b not in region.bad_buckets]
            b = max(good) if good else 1
            head, remaining = _split_taken(remaining, b)
            self._launch_tasks(region, head, b, mode, degraded=True)
            n_left -= b

    def _fail_tasks(self, region: _Region, tasks: List[_Pending],
                    err: Exception) -> None:
        n = 0
        for t in tasks:
            ids = tuple(range(t.wave_index, t.wave_index + t.count))
            cause = TaskFailedError(
                f"task(s) {list(ids)} of {region.signature.describe()} "
                f"failed: {err}", task_ids=ids,
                kernel=region.signature.kernel)
            cause.__cause__ = err
            if isinstance(t.future, RangeFuture):
                t.future._fail_range(t.fut_offset, t.count, cause)
            else:
                t.future._fail(cause)
            n += t.count
        region.stats["faults"]["failed_tasks"] += n

    # -- the guard at flush: detection, bisection, containment -------------
    def _run_guard(self) -> None:
        """Read every recorded launch's verdict in one device-to-host copy
        (after the join, so the caller's stream is past every launch); a
        tripped launch's futures are retracted and resolved again by
        bisection."""
        records, self._guard_records = self._guard_records, []
        flags = [r.verdict for r in records
                 if isinstance(r.verdict, torch.Tensor)]
        read = iter(torch.stack(flags).cpu().tolist() if flags else ())
        for rec in records:
            ok = (next(read) if isinstance(rec.verdict, torch.Tensor)
                  else rec.verdict)
            if not ok:
                self._contain(rec)

    def _contain(self, rec: _LaunchRecord) -> None:
        """Isolate the offending slots of a tripped launch in O(log bucket)
        re-executions: quarantined repeat offenders run alone, everything
        else halves recursively; clean groups fulfil their futures again
        (bit-identical: the body is independent per slot), non-finite
        single positions fail."""
        region = rec.region
        faults = region.stats["faults"]
        faults["trips"] += 1
        for t in rec.tasks:
            if isinstance(t.future, RangeFuture):
                t.future._retract(rec.out)
            else:
                t.future._retract()
        # position -> (owning entry, the entry's first position)
        owner: Dict[int, Tuple[_Pending, int]] = {}
        pos = 0
        for t in rec.tasks:
            for p in range(pos, pos + t.count):
                owner[p] = (t, pos)
            pos += t.count
        quarantined = [p for p in range(rec.k)
                       if rec.wave_ids[p] in region.quarantine]
        rest = [p for p in range(rec.k)
                if rec.wave_ids[p] not in region.quarantine]
        # the root group is known bad only when no quarantined position
        # could carry the trip: then its own re-execution is skipped
        groups: List[Tuple[List[int], bool]] = [([p], False)
                                                for p in quarantined]
        if rest:
            groups.append((rest, not quarantined))
        culprits: List[int] = []
        while groups:
            grp, known_bad = groups.pop()
            if known_bad:
                if len(grp) == 1:
                    culprits.append(grp[0])
                else:
                    mid = len(grp) // 2
                    groups.append((grp[:mid], False))
                    groups.append((grp[mid:], False))
                continue
            out, ok = self._reexec(rec, grp)
            faults["bisection_launches"] += 1
            if ok:
                self._refulfil(rec, owner, grp, out)
            elif len(grp) == 1:
                culprits.append(grp[0])
            else:
                mid = len(grp) // 2
                groups.append((grp[:mid], False))
                groups.append((grp[mid:], False))
        for p in culprits:
            tid = rec.wave_ids[p]
            region.quarantine.record_offense(tid)
            faults["quarantined"] = region.quarantine.as_stats()
            err = TaskFailedError(
                f"non-finite output isolated to task {tid} of "
                f"{region.signature.describe()} (wave {rec.wave}, launch "
                f"bucket {rec.k})", task_ids=(tid,),
                kernel=region.signature.kernel)
            t, first = owner[p]
            if isinstance(t.future, RangeFuture):
                t.future._fail_range(t.fut_offset + (p - first), 1, err)
            else:
                t.future._fail(err)
        faults["failed_tasks"] += len(culprits)

    def _reexec(self, rec: _LaunchRecord, grp: List[int]
                ) -> Tuple[torch.Tensor, bool]:
        """Run one position subset again through the region's gather
        program; the injected payload poison is applied again by wave id
        (a property of the task), so bisection converges on it.  Returns
        the output and whether it is finite (one host read)."""
        region = rec.region
        idx = _index_tensor([rec.indices[p] for p in grp], self.device)
        ex = self.pool.get()
        out = ex.launch(region.apply_gathered, idx, *rec.parents,
                        family=region.signature.kernel)
        pois = {j: rec.poisoned[rec.wave_ids[p]]
                for j, p in enumerate(grp)
                if rec.wave_ids[p] in rec.poisoned}
        verdict = ex.follow(self._poison_and_check, out, pois, True)
        ex.join()
        return out, bool(verdict)

    @staticmethod
    def _refulfil(rec: _LaunchRecord, owner: Dict[int, Tuple[_Pending, int]],
                  grp: List[int], out: torch.Tensor) -> None:
        """Fulfil a clean re-executed group (groups stay contiguous
        position runs, so segment assembly stays slice-shaped)."""
        for j, p in enumerate(grp):
            t, first = owner[p]
            if isinstance(t.future, RangeFuture):
                t.future._fulfil_range(out, j, t.fut_offset + (p - first), 1)
            else:
                t.future._fulfil(out, j)

    # -- the launch watchdog and the circuit breakers ----------------------
    def _enforce_watchdog(self) -> None:
        """Bound the completion of every recorded launch by its deadline,
        with no polling: a daemon thread waits on each launch's completion
        event (``Event.synchronize`` releases the GIL) and sets a
        ``threading.Event``; the caller waits on that with the latest
        deadline as its timeout.  A stalled launch raises
        :class:`LaunchTimeoutError` naming its family within its budget,
        while the waiter stays parked on the stalled stream.  On the CPU a
        launch has completed when it returns (no event): nothing waits."""
        records, self._watchdog_records = self._watchdog_records, []
        pending = [ev for _, ev, _, _ in records
                   if ev is not None and not ev.query()]
        if not pending:
            return
        done = threading.Event()

        def _block():
            try:
                for ev in pending:
                    try:
                        ev.synchronize()
                    except Exception:    # the verdict read surfaces it
                        pass
            finally:
                done.set()

        threading.Thread(target=_block, daemon=True,
                         name="agg-watchdog").start()
        # one deadline per flush, the latest record's: each record's budget
        # started at its dispatch
        deadline = max(r[0] for r in records)
        if done.wait(max(0.0, deadline - time.monotonic())):
            return
        for _, ev, region, k in records:       # blame the stalled launch
            if ev is not None and not ev.query():
                region.stats["faults"]["timeouts"] += 1
                raise LaunchTimeoutError(
                    f"launch of kernel {region.signature.kernel!r} bucket "
                    f"{k} exceeded launch_timeout_s={self._launch_timeout}")

    def _update_breakers(self) -> None:
        """Advance every region's circuit breaker at flush time, after the
        guard's audit.  Faults (guard trips, launch failures, timeouts) are
        counted as the cumulative counters' delta over the waves completed
        since the last tick."""
        if not self._breaker_window:
            return
        for region in self._regions.values():
            elapsed = region.waves - region._breaker_wave_mark
            if not elapsed:
                continue
            region._breaker_wave_mark = region.waves
            f = region.stats["faults"]
            cum = f["trips"] + f["launch_failures"] + f["timeouts"]
            delta = cum - region._breaker_mark
            region._breaker_mark = cum
            if region.breaker_state == "closed":
                region._breaker_counts.extend(
                    [delta] + [0] * (elapsed - 1))
                del region._breaker_counts[:-self._breaker_window]
                if sum(region._breaker_counts) >= self._breaker_threshold:
                    self._trip_breaker(region)
            elif region.breaker_state == "open":
                region._breaker_open_waves += elapsed
                if region._breaker_open_waves >= self._breaker_cooldown:
                    # cooled down: the next wave runs the whole ladder as
                    # a probe; clean closes the breaker, faulty re-opens it
                    region.breaker_state = "half_open"
            else:                                         # half-open probe
                if delta:
                    self._trip_breaker(region)
                else:
                    region.breaker_state = "closed"
                    region._breaker_counts = []
            region.stats["breaker"] = region.breaker_state

    @staticmethod
    def _trip_breaker(region: _Region) -> None:
        region.breaker_state = "open"
        region._breaker_open_waves = 0
        region._breaker_counts = []
        region.stats["breaker"] = "open"
        region.stats["faults"]["breaker_trips"] += 1

    def breaker_state(self, kernel: str) -> str:
        """The breaker state of ``kernel``'s primary region (``"closed"``,
        ``"open"`` or ``"half_open"``; ``"closed"`` for an unknown
        family).  ``mixed`` pins a family that is not closed to ``s3``."""
        region = self._primary_region(kernel)
        return region.breaker_state if region is not None else "closed"

    def breaker_states(self) -> Dict[str, str]:
        """Per-family breaker states (a family with several shape regions
        reports its worst: open > half_open > closed), what
        ``ServingEngine.healthz()`` reports."""
        rank = {"closed": 0, "half_open": 1, "open": 2}
        out: Dict[str, str] = {}
        for sig, region in self._regions.items():
            prev = out.get(sig.kernel, "closed")
            if rank[region.breaker_state] >= rank[prev]:
                out[sig.kernel] = region.breaker_state
        return out

    # -- ladder auto-tuning ------------------------------------------------
    def _wave_complete(self, region: _Region) -> None:
        """A wave ended (its queue drained to zero): record its peak queue
        length and, past ``autotune_warmup`` waves, re-derive the ladder.
        A peak beyond what the last retune saw re-arms the tuner."""
        region._wave_submitted = 0        # wave-relative task ids restart
        region.stats["prior_hits"] = region.cost.prior_hits
        peak = region._wave_peak
        if peak:
            qh = region.stats["queue_hist"]
            qh[peak] = qh.get(peak, 0) + 1
            region.waves += 1
            region._wave_peak = 0
            if region.tuned and peak > region._retuned_peak:
                region.tuned = False
        if (self.config.autotune and not region.tuned
                and region.waves >= self.config.autotune_warmup):
            self._retune_region(region)

    def _retune_region(self, region: _Region) -> None:
        """Swap in the ladder minimizing the per-wave objective: expected
        launches, or under ``cost_model=True`` the predicted time, after
        re-sweeping ``inner_chunk="auto"`` and timing every candidate
        bucket's program (:func:`ladder_candidates`); real measurements
        retire the prior's seeds.  When the ladder or the chunk changed,
        the buckets the observed waves drain through under the new ladder
        get their programs, as the reference AOT-compiles them: the ring's
        (a ring-staged region) and each parent set's, captured on the card
        at every site of those drains.  With a tune store, the tuned state
        is written back (what process two restores)."""
        region._retuned_waves = region.waves
        region._retuned_peak = max(
            (k for k in region.stats["queue_hist"] if k > 0), default=0)
        chunk_changed = False
        cost_model = None
        if self._cost_on:
            chunk_changed = self._resweep_chunk(region)
            cost_model = self._measure_candidates(region)
        ladder = derive_ladder(region.stats["queue_hist"],
                               self.config.max_aggregated,
                               self.config.compile_budget, cost_model)
        region.tuned = True
        region.stats["tuned_by"] = ("measured" if cost_model is not None
                                    else "launches")
        if cost_model is not None:
            region.cost.clear_priors()
            region.stats["cost_sources"] = {
                p: dict(t) for p, t in region.cost.sources().items()}
        region.stats["prior_hits"] = region.cost.prior_hits
        changed = ladder != region.buckets or chunk_changed
        region.buckets = ladder
        region.stats["ladder"] = list(ladder)
        if changed:
            self._aot_used(region, ladder)
        if self._store is not None:
            self._persist_region(region)
            self._store.save()

    @staticmethod
    def _aot_used(region: _Region, ladder: Tuple[int, ...]) -> None:
        """The programs of the buckets the observed waves drain through
        under ``ladder``: the ring's (a ring-staged region; host staging
        keeps ``host_jit``) and each parent set's, captured on the card at
        the drains' sites."""
        used = set()
        for k in region.stats["queue_hist"]:
            used.update(greedy_decomposition(k, ladder))
        if region.ring is not None and region.ring_staged:
            for b in sorted(used):
                region.aot_ring(b)
        for pk, specs in region.parent_specs.items():
            n_parent = min(shape[0] for shape, _ in specs)
            for b in sorted(used):
                if b <= n_parent:
                    region.aot_ref(b, pk)
            for k in region.stats["queue_hist"]:
                if k <= n_parent:
                    region.prime(pk, _greedy_sites(k, ladder))

    def _resweep_chunk(self, region: _Region) -> bool:
        """A retune's ``inner_chunk="auto"`` re-sweep, past the memo.  A
        new chunk makes every program and every cost sample stale: they
        are dropped (``reset_compiled``).  Returns whether the chunk
        changed."""
        if not self._chunk_auto:
            return False
        parents = self._primary_parents(region)
        if parents is None:
            return False
        old = region.chunk
        self._tune_chunk(region, parents, force=True)
        if region.chunk == old:
            return False
        region.reset_compiled()
        region.cost.clear()
        region.stats.pop("cost_model", None)
        return True

    def _primary_parents(self, region: _Region
                         ) -> Optional[Tuple[torch.Tensor, ...]]:
        """Zero-filled parents for measurements: the deepest parent set
        seen (the biggest buckets fit), else the ring's buffers."""
        if region.parent_specs:
            specs = max(region.parent_specs.values(),
                        key=lambda sp: min(shape[0] for shape, _ in sp))
            return self._zeros(specs)
        if region.ring is not None:
            return region.ring.buffers()
        return None

    def _measure_candidates(self, region: _Region
                            ) -> Optional[BucketCostModel]:
        """Time every drain-reachable candidate bucket's program of the
        region's waves (buckets with samples are free) on each parent set
        seen and on the ring of a ring-staged region; the model, or None
        when nothing was measured."""
        cands = sorted(ladder_candidates(region.stats["queue_hist"],
                                         self.config.max_aggregated))
        for specs in list(region.parent_specs.values()):
            self._measure_region(region, cands, self._zeros(specs))
        if region.ring is not None and region.ring_staged:
            self._measure_region(region, cands, region.ring.buffers(),
                                 alt_paths=False, ring=True)
        return region.cost if region.cost.measured() else None

    def retune(self) -> Dict[str, Tuple[int, ...]]:
        """Retune every region with at least one new complete wave since
        its last retune; returns the ladders by family."""
        out = {}
        for region in self._regions.values():
            if (region.stats["queue_hist"]
                    and region.waves != region._retuned_waves):
                region.tuned = False
                self._retune_region(region)
            out[region.signature.describe()] = region.buckets
        return out

    def flush(self) -> None:
        """Launch everything still queued (greedy buckets; live regions
        round-robin) and make the caller's stream wait for every executor
        (on the device: the host does not block).  Then, in the reference's
        order: the watchdog bounds the launches' completion (before
        anything reads a result on the host), the guard reads its verdicts
        in one copy and contains what tripped, and the breakers advance."""
        with tracing.span("repro_torch.agg.flush"):
            live = [r for r in self._regions.values() if r.queue]
            while live:
                for region in live:
                    if region.queue:
                        self._launch(region, self._largest_bucket(
                            region, region.queued_tasks))
                live = [r for r in live if r.queue]
            self.pool.join()
            if self._watchdog_records:
                self._enforce_watchdog()
            if self._guard_records:
                self._run_guard()
            self._update_breakers()

    def map(self, task_args: Sequence[Tuple[Any, ...]],
            kernel: Optional[str] = None) -> List[torch.Tensor]:
        """Submit many tasks, flush, return their results in order."""
        futs = [self.submit(*a, kernel=kernel) for a in task_args]
        self.flush()
        return [f.result() for f in futs]


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


# ---------------------------------------------------------------------------
# The paper's "aggregation region": a named code region that compatible
# tasks may enter together, one executor (and executor pool) per name.
# ---------------------------------------------------------------------------

_REGIONS: Dict[str, AggregationExecutor] = {}


def aggregation_region(name: str, batched_fn: Callable,
                       config: Optional[AggregationConfig] = None,
                       **kw) -> AggregationExecutor:
    """Get or create the named region's executor (``kw`` go to
    :class:`AggregationExecutor` at creation)."""
    exe = _REGIONS.get(name)
    if exe is None:
        exe = AggregationExecutor(batched_fn, config or AggregationConfig(),
                                  name=name, **kw)
        _REGIONS[name] = exe
    return exe


def reset_regions() -> None:
    """Forget every named region."""
    _REGIONS.clear()
