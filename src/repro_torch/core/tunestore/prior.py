"""Analytical roofline prior for unmeasured bucket costs (DESIGN.md §13).

With an empty store, the measured tuner's only option is timing every
candidate bucket.  The prior replaces that first contact with arithmetic:
a bucket-``b`` launch of a kernel family is modelled as

    t(b) = t_launch + max(bytes_moved(b) / bandwidth,  flops(b) / peak)

the roofline plus the per-launch cost the bucket ladder exists to
amortise.  ``bytes_moved`` is the task's inputs read and outputs written
(the outputs sized by running the body's plain version on ``meta``
tensors, which launches nothing), times the bucket; ``flops`` is the
operation count of the family's kernel (``ops_per_task`` on the body,
from ``repro_torch.kernels.counts``, the count ``chip_smoke.py``'s bounds
use), else a fixed intensity per element.  Device figures come from a
table keyed by device name; an unknown device gets a micro-benchmark,
measured once per process.

The absolute numbers only need to be roughly right: ``derive_ladder``
consumes ratios between bucket sizes, and any overhead-plus-traffic model
already says that few big launches beat many small ones.  Every seeded
entry is tagged ``"prior"`` in the cost model and retired by the first
real retune.
"""
from __future__ import annotations

import math
import statistics
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

# device name substring (lowercased) -> (bytes/s, flop/s, launch seconds).
# "cpu" keeps the reference's row, so the prior's arithmetic on the CPU is
# the reference's and CPU runs never calibrate.  "h100": the H100 SXM data
# sheet's HBM3 bandwidth and fp32 rate outside the tensor cores (the
# figures chip_smoke.py divides by for its bounds), and the launch seconds
# :func:`microbenchmark` measured on an NVIDIA H100 80GB HBM3 at 700.00 W
# (chip_smoke.py's warm_start phase prints it): a one-element op timed by
# CUDA events, the host's dispatch included, as a launch costs a wave.
DEVICE_PEAKS: Dict[str, Tuple[float, float, float]] = {
    "cpu":  (2.0e10, 5.0e10, 2.0e-5),
    "h100": (3.35e12, 67e12, 4.566400125622749e-05),
}

# flops per element for a body without an operation count: a band between
# pure streaming (~1) and stencil bodies (tens)
FALLBACK_FLOPS_PER_ELEM = 16.0

# measured-once calibration: backend key -> (bytes/s, flop/s, launch s)
_CALIBRATION: Dict[Tuple[str, ...], Tuple[float, float, float]] = {}


def _lookup_peaks(device_name: str) -> Optional[Tuple[float, float, float]]:
    name = (device_name or "").lower()
    for key, peaks in DEVICE_PEAKS.items():
        if key in name:
            return peaks
    return None


def microbenchmark(device: torch.device, runs: int = 5
                   ) -> Tuple[float, float, float]:
    """(bytes/s, flop/s, launch seconds) of ``device``: a streaming op over
    16 MiB (one read, one write), a 512 x 512 fp32 matmul and a launch on
    one element, each the median of ``runs`` timed calls after a warm one
    (CUDA events around each call on the card, the host clock
    elsewhere)."""
    on_card = device.type == "cuda"

    def timed(fn):
        fn()
        ts = []
        for _ in range(runs):
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                end.synchronize()
                ts.append(start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    n = 1 << 22
    x = torch.zeros(n, dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    bw = 2 * n * 4 / max(timed(lambda: torch.mul(x, 2.0, out=y)), 1e-9)
    m = 512
    a = torch.zeros((m, m), dtype=torch.float32, device=device)
    c = torch.empty_like(a)
    flops = 2.0 * m ** 3 / max(timed(lambda: torch.mm(a, a, out=c)), 1e-9)
    s = torch.zeros(1, dtype=torch.float32, device=device)
    t = torch.empty_like(s)
    launch = timed(lambda: torch.add(s, 1.0, out=t))
    return bw, flops, max(launch, 1e-7)


def device_peaks(backend_key: Tuple[str, ...]
                 ) -> Tuple[float, float, float]:
    """(bytes/s, flop/s, launch seconds) of the keyed device: its table
    row by device-name substring, else the memoised micro-benchmark on
    that device (``backend_key[0]``, its first card)."""
    known = _lookup_peaks(backend_key[1])
    if known is not None:
        return known
    cal = _CALIBRATION.get(backend_key)
    if cal is None:
        cal = _CALIBRATION[backend_key] = microbenchmark(
            torch.device(backend_key[0]))
    return cal


def _nbytes(shape: Sequence[int], dtype: torch.dtype) -> float:
    return float(math.prod(shape) * dtype.itemsize)


class RooflinePrior:
    """Seconds per launch estimated from shapes, for one process's device
    (``backend_key``: ``(type, device name, "d<count>")``).  Memoises each
    family's per-task flops and output bytes, keyed on the body and the
    task specs ``((shape, dtype), ...)``."""

    def __init__(self, backend_key: Tuple[str, ...]):
        self.backend_key = tuple(backend_key)
        self.bandwidth, self.peak_flops, self.launch_overhead = \
            device_peaks(self.backend_key)
        # (body id, specs) -> (body, flops per task, out bytes per task);
        # the body rides along to keep its id valid
        self._family_memo: Dict[Tuple, Tuple[Any, float, float]] = {}

    @staticmethod
    def _spec_key(task_specs: Sequence[Tuple[Tuple[int, ...], torch.dtype]]
                  ) -> Tuple:
        return tuple((tuple(shape), dtype) for shape, dtype in task_specs)

    @staticmethod
    def _task_flops(batched_fn: Any) -> Optional[float]:
        """The family kernel's fp32 operations per task
        (``batched_fn.ops_per_task()``), or None for a body without one."""
        count = getattr(batched_fn, "ops_per_task", None)
        return None if count is None else float(count())

    def _analyze_family(self, batched_fn: Any, task_specs: Sequence[Any]
                        ) -> Tuple[float, float]:
        """(flops, output bytes) of ONE task of this family."""
        key = (id(batched_fn), self._spec_key(task_specs))
        memo = self._family_memo.get(key)
        if memo is not None:
            return memo[1], memo[2]
        in_elems = sum(math.prod(shape) for shape, _ in task_specs)
        try:
            out = batched_fn(*(torch.empty((1,) + tuple(shape), dtype=dtype,
                                           device="meta")
                               for shape, dtype in task_specs))
            leaves = out if isinstance(out, (tuple, list)) else (out,)
            out_bytes = sum(_nbytes(o.shape, o.dtype) for o in leaves)
            out_elems = sum(math.prod(o.shape) for o in leaves)
        except (TypeError, ValueError, RuntimeError, NotImplementedError):
            # a body that does not run on meta tensors: charge it as
            # write-what-you-read streaming
            out_bytes = sum(_nbytes(shape, dtype)
                            for shape, dtype in task_specs)
            out_elems = in_elems
        flops = self._task_flops(batched_fn)
        if flops is None:
            flops = FALLBACK_FLOPS_PER_ELEM * max(in_elems, out_elems, 1)
        self._family_memo[key] = (batched_fn, float(flops), out_bytes)
        return float(flops), out_bytes

    def predict(self, batched_fn: Any, task_specs: Sequence[Any],
                bucket: int) -> float:
        """Predicted seconds of ONE launch of ``bucket`` tasks of this
        family: launch overhead plus the roofline of the bucket's traffic,
        per-task flops and bytes scaled linearly in the bucket."""
        flops1, out_bytes1 = self._analyze_family(batched_fn, task_specs)
        in_bytes1 = sum(_nbytes(shape, dtype) for shape, dtype in task_specs)
        b = max(1, int(bucket))
        return self.launch_overhead + max(
            b * (in_bytes1 + out_bytes1) / self.bandwidth,
            b * flops1 / self.peak_flops)
