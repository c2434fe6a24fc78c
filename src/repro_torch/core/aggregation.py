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

``make_s2_scatter`` builds the ``s2`` strategy's per-task launch.  The
reference's containment and tune store wait in ROADMAP.md (items 9, 10).
"""
from __future__ import annotations

import bisect
import statistics
import time
from dataclasses import dataclass
from typing import (
    Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple,
)

import torch

from repro_torch.configs.base import AggregationConfig, resolve_family_option
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


def _out_like(batched_fn: Callable, stacked: Sequence[torch.Tensor]
              ) -> torch.Tensor:
    """An empty output of the body over ``stacked`` (sized on meta
    tensors)."""
    spec = batched_fn(*(torch.empty(a.shape, dtype=a.dtype, device="meta")
                        for a in stacked))
    return torch.empty(spec.shape, dtype=spec.dtype,
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


class _Region:
    """One aggregation region: per-TaskSignature queue, bucket ladder, slot
    ring (made at the first per-task submission), the two staging
    programs (contiguous prefix, indexed gather), and its tuning state: the
    inner chunk, the wave count and queue-length histogram, the cost
    model, and the parent shapes its ranges read (which measurements
    replay)."""

    __slots__ = ("signature", "batched_fn", "queue", "queued_tasks",
                 "buckets", "stats", "ring", "chunk", "chunk_tuned",
                 "waves", "tuned", "_wave_peak", "cost", "_retuned_waves",
                 "_retuned_peak", "warmup_wave", "parent_specs", "_outs")

    def __init__(self, signature: TaskSignature, batched_fn: Callable,
                 buckets: Tuple[int, ...], chunk: int = 0):
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
        # parent shapes a range or warmup read, ((shape, dtype), ...) each
        self.parent_specs: set = set()
        self._outs: Dict[Tuple, Tuple] = {}   # chunked outputs' shapes
        self.stats = {"submitted": 0, "launches": 0, "aggregated_hist": {},
                      "queue_hist": {}, "ladder": list(buckets),
                      "measurement_launches": 0, "prior_hits": 0}

    def ensure_ring(self, capacity: int, example_args: Sequence[torch.Tensor],
                    device: torch.device) -> SlotRing:
        if self.ring is None:
            self.ring = SlotRing(capacity, example_args, device=device)
        return self.ring

    def remember(self, parents: Sequence[torch.Tensor]) -> None:
        self.parent_specs.add(tuple((tuple(p.shape), p.dtype)
                                    for p in parents))

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
    """

    def __init__(self, batched_fn: Optional[Callable] = None,
                 config: Optional[AggregationConfig] = None,
                 pool: Optional[ExecutorPool] = None, name: str = "region",
                 device: DeviceLike = None,
                 buffer_pool: Optional[BufferPool] = None,
                 timer: Optional[Callable] = None):
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
        self._bodies: Dict[str, Callable] = {}
        self._regions: Dict[TaskSignature, _Region] = {}
        self._default_kernel: Optional[str] = None
        self.stats = {"submitted": 0, "launches": 0, "aggregated_hist": {},
                      "staging_s": 0.0, "regions": {},
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
            region = _Region(sig, body, self._buckets, chunk=self._chunk)
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
    def warmup(self, parent_shapes: Sequence[Tuple[Tuple[int, ...],
                                                   torch.dtype]], *,
               kernel: Optional[str] = None,
               buckets: Optional[Sequence[int]] = None) -> None:
        """Launch each ladder bucket (or each of ``buckets``) once on every
        executor's stream, on zero-filled parents of the given ``(shape,
        dtype)``s (the shapes a range or a host-stacked bucket reads), and
        under device staging once more on the family's slot ring, which
        this makes: builds the kernel at first use and pays every
        first-launch cost (including each stream's first allocations)
        before the timed run.  Launch statistics are not touched.  Under
        ``inner_chunk="auto"`` this first times the chunks; under
        ``cost_model=True`` it then times the buckets and, for the
        ``mixed`` strategy's choice, the ``s2`` widths and the whole-wave
        launch."""
        kernel = self._resolve_kernel(kernel)
        parents = tuple(torch.zeros(shape, dtype=dtype, device=self.device)
                        for shape, dtype in parent_shapes)
        region = self._region_for(kernel, [SlotView(p, 0) for p in parents])
        region.remember(parents)
        n_parent = min(p.shape[0] for p in parents)
        region.warmup_wave = max(region.warmup_wave, n_parent)
        if self._chunk_auto and not region.chunk_tuned:
            self._tune_chunk(region, parents)
        want = region.buckets if buckets is None else tuple(sorted(buckets))
        ring = None
        if self._staging == "device":
            ring = region.ensure_ring(self.config.max_aggregated,
                                      [p[0] for p in parents], self.device)
        for ex in self.pool.executors:
            for b in want:
                if b <= n_parent:
                    ex.run(region.apply_prefix, 0, b, *parents)
                if ring is not None:
                    ex.run(region.apply_prefix, 0, b, *ring.buffers())
                    ring.track_read(0, b, ex.last_event)
        self._sync()
        if self._cost_on:
            self._measure_region(region, want, parents)

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
            region.stats["measurement_launches"] += _launches(
                self.timer, self.device, 3)
            t = min(_samples(self.timer,
                             lambda c=c: region.eval(*stacked, chunk=c),
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
                        alt_paths: bool = True) -> None:
        """Time each bucket's prefix launch on ``parents`` (zero-filled)
        into the region's cost model; buckets with samples already are
        skipped.  ``alt_paths``: also the ``s2`` widths and the whole-wave
        launch (:meth:`_measure_alt_paths`)."""
        n_slots = min(p.shape[0] for p in parents)
        for b in sorted(set(buckets)):
            if b > n_slots or region.cost.time(b) is not None:
                continue
            for t in self._sample(
                    region, lambda b=b: region.apply_prefix(0, b, *parents),
                    "s3", b):
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
        if not wave:
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
            out["s3"] = round(region.cost.predict_seq(
                greedy_decomposition(wave, region.buckets)) * 1e3, 4)
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
        ``"s3"`` before any measurement.  The choice and its costs go into
        ``stats["regions"][fam]``."""
        costs = self.strategy_costs(kernel)
        order = ("s3", "s2", "fused")
        timed = [(costs[s], order.index(s)) for s in order if s in costs]
        selected = order[min(timed)[1] if timed else 0]
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
        if not region.queue:
            self._wave_complete(region)

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
        region.remember(parents)
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

    # -- ladder auto-tuning ------------------------------------------------
    def _wave_complete(self, region: _Region) -> None:
        """A wave ended (its queue drained to zero): record its peak queue
        length and, past ``autotune_warmup`` waves, re-derive the ladder.
        A peak beyond what the last retune saw re-arms the tuner."""
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
        bucket (:func:`ladder_candidates`).  The bucket kernels need no
        compile, so the new ladder is live at once.  (Writing the tuned
        state to a tune store waits in ROADMAP.md, item 10.)"""
        region._retuned_waves = region.waves
        region._retuned_peak = max(
            (k for k in region.stats["queue_hist"] if k > 0), default=0)
        cost_model = None
        if self._cost_on:
            self._resweep_chunk(region)
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
        region.buckets = ladder
        region.stats["ladder"] = list(ladder)

    def _resweep_chunk(self, region: _Region) -> bool:
        """A retune's ``inner_chunk="auto"`` re-sweep, past the memo.  A
        new chunk makes every cost sample stale: they are dropped.  Returns
        whether the chunk changed."""
        if not self._chunk_auto:
            return False
        parents = self._primary_parents(region)
        if parents is None:
            return False
        old = region.chunk
        self._tune_chunk(region, parents, force=True)
        if region.chunk == old:
            return False
        region.cost.clear()
        region.stats.pop("cost_model", None)
        return True

    def _primary_parents(self, region: _Region
                         ) -> Optional[Tuple[torch.Tensor, ...]]:
        """Zero-filled parents for measurements: the deepest parent set
        seen (the biggest buckets fit), else the ring's buffers."""
        if region.parent_specs:
            specs = max(region.parent_specs,
                        key=lambda sp: min(shape[0] for shape, _ in sp))
            return self._zeros(specs)
        if region.ring is not None:
            return region.ring.buffers()
        return None

    def _measure_candidates(self, region: _Region
                            ) -> Optional[BucketCostModel]:
        """Time every drain-reachable candidate bucket of the region's
        waves (buckets with samples are free) on each parent set seen and
        on the ring; the model, or None when nothing was measured."""
        cands = sorted(ladder_candidates(region.stats["queue_hist"],
                                         self.config.max_aggregated))
        for specs in region.parent_specs:
            self._measure_region(region, cands, self._zeros(specs))
        if region.ring is not None:
            self._measure_region(region, cands, region.ring.buffers(),
                                 alt_paths=False)
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
        round-robin) and make the caller's stream wait for every executor."""
        live = [r for r in self._regions.values() if r.queue]
        while live:
            for region in live:
                if region.queue:
                    self._launch(region, self._largest_bucket(
                        region, region.queued_tasks))
            live = [r for r in live if r.queue]
        self.pool.join()

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
