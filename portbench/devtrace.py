"""What the benchmark reads from ``torch.profiler``'s trace of a traced
sub-window: the device's busy intervals, kernel time by family, the
device operations that took most time, and the idle gaps by what the host
was doing.

Events are read raw (``kineto_results.events()``): building the
profiler's function events costs seconds per 10^5 kernels.  Busy time is
the union of every device interval (kernels, copies, fills) over all
streams, so concurrent streams count once.  A family's kernels are found
by the name fragments in ``kernel_names/<family>/*.txt``, so a program
that replaces a kernel adds its names in a file of its own.
"""
from __future__ import annotations

import heapq
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch

NAMES_DIR = Path(__file__).resolve().parent / "kernel_names"
SPAN_PREFIX = "portbench."
TOP = 10
NAME_CHARS = 120     # a device operation's name as listed, cut to this


def family_names(family: str, names_dir: Path = NAMES_DIR) -> Tuple[str, ...]:
    """Every name fragment listed under ``kernel_names/<family>/``."""
    frags = []
    for f in sorted((names_dir / family).glob("*.txt")):
        frags += [ln.strip() for ln in f.read_text().splitlines()
                  if ln.strip() and not ln.lstrip().startswith("#")]
    return tuple(dict.fromkeys(frags))


def families(names_dir: Path = NAMES_DIR) -> Tuple[str, ...]:
    return tuple(sorted(p.name for p in names_dir.iterdir() if p.is_dir()))


def _matches(name: str, frags: Sequence[str]) -> bool:
    return any(f in name for f in frags)


def union_ns(intervals: Sequence[Tuple[int, int]]) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def merged(intervals: Sequence[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class DeviceTrace:
    """The device side of one profiled sub-window of ``steps`` steps that
    lasted ``window_s`` on the host clock."""

    def __init__(self, prof, steps: int, window_s: float):
        self.steps, self.window_s = steps, window_s
        self.ops: List[Tuple[str, int, int]] = []      # (name, start, end)
        self.host: List[Tuple[int, int, str, int]] = []
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    self.ops.append((e.name(), e.start_ns(), e.end_ns()))
            else:
                self.host.append((e.start_ns(), e.end_ns(), e.name(),
                                  e.start_thread_id()))

    @property
    def busy_s(self) -> float:
        return union_ns([(s, e) for _, s, e in self.ops]) / 1e9

    def family_count(self, frags: Sequence[str]) -> int:
        return sum(1 for n, _, _ in self.ops if _matches(n, frags))

    def family_union_s(self, frags: Sequence[str]) -> float:
        return union_ns([(s, e) for n, s, e in self.ops
                         if _matches(n, frags)]) / 1e9

    def top_ops(self) -> List[List]:
        by = defaultdict(int)
        for n, s, e in self.ops:
            by[n[:NAME_CHARS]] += e - s
        return [[n, t / 1e9] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[List]:
        """Idle device time inside the window (the benchmark's
        ``portbench.window`` span), summed by what the host was doing at
        each gap's middle: the benchmark's span and the innermost host
        operation on its thread."""
        win = [h for h in self.host if h[2] == SPAN_PREFIX + "window"]
        if not win:
            return []
        w0, w1, _, thread = win[0]
        busy = merged([(max(s, w0), min(e, w1)) for _, s, e in self.ops
                       if e > w0 and s < w1])
        gaps, t = [], w0
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < w1:
            gaps.append((t, w1))
        host = sorted((s, e, n) for s, e, n, th in self.host
                      if th == thread and n != SPAN_PREFIX + "window")
        by = defaultdict(int)
        active: List[Tuple[int, int, str]] = []      # heap on end
        i = 0
        for g0, g1 in sorted(gaps, key=lambda g: (g[0] + g[1]) // 2):
            mid = (g0 + g1) // 2
            while i < len(host) and host[i][0] <= mid:
                heapq.heappush(active, (host[i][1], host[i][0], host[i][2]))
                i += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            cover = [(s, n) for e, s, n in active if s <= mid <= e]
            span = next((n for s, n in sorted(cover)
                         if n.startswith(SPAN_PREFIX)), "outside spans")
            inner = max(cover)[1] if cover else "no host op"
            if inner.startswith(SPAN_PREFIX):
                inner = "Python between operations"
            by[f"{span} > {inner}"] += g1 - g0
        return [[n, t / 1e9] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]


def kernel_count_mismatch(trace: DeviceTrace, replayed: Dict[str, int],
                          names_dir: Path = NAMES_DIR) -> Optional[str]:
    """None when, for every kernel family, the trace holds as many of its
    kernels as the bucket programs' replays launched in the sub-window
    (``replayed``: kernel name -> launches); else what differs.  A family
    with no replays launched eagerly or not at all, and the profiler
    records eager launches as they come."""
    for fam in families(names_dir):
        frags = family_names(fam, names_dir)
        want = sum(c for n, c in replayed.items() if _matches(n, frags))
        got = trace.family_count(frags)
        if want and got != want:
            return (f"family {fam}: the trace holds {got} kernels, the "
                    f"replays launched {want}")
    return None
