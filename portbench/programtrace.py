"""The program's own spans (``repro_torch.tracing``) laid over the
device-only traced sub-window.

The extent is the sub-window's device activity, from its first operation's
start to its last one's end, on the clock the spans share with the
profiler.  The spans kept are those of the thread that ran the
``repro_torch.rk3_step`` spans there; the split holds only when those steps
are as many as the sub-window's.  Each idle instant of the extent (the
extent less the union of the device's operations) goes to the innermost
program span over it, in one of five parts: the Courant dt, the scenario,
the aggregation executor, the runner itself (``rk3_step`` and ``stage``
outside their children), and outside every program span (the benchmark's
loop and its dt read).  The parts sum to the extent's idle exactly.

A program without the tracer, and a run without device operations, give
None.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from portbench.devtrace import merged

PARTS = ("dt", "scenario", "executor", "runner", "outside")
STEP = "repro_torch.rk3_step"


def part_of(name: str) -> str:
    """The part of the step a program span's name belongs to."""
    if name == "repro_torch.courant_dt":
        return "dt"
    if name.startswith("repro_torch.scenario."):
        return "scenario"
    if name.startswith(("repro_torch.agg.", "repro_torch.graphs.")):
        return "executor"
    return "runner"


def labelled(spans: Sequence[Tuple[int, int, str]], x0: int, x1: int
             ) -> List[Tuple[int, int, str]]:
    """``[x0, x1)`` cut into runs, each labelled with the part of the
    innermost span over it (``outside`` where none is).  ``spans`` are
    ``(start, end, part)`` of one thread, which nest; one that would
    outlast its parent is cut at the parent's end."""
    runs: List[Tuple[int, int, str]] = []
    stack: List[Tuple[int, str]] = []       # (end, part), innermost last
    t = x0

    def upto(u: int) -> None:
        nonlocal t
        if u > t:
            runs.append((t, u, stack[-1][1] if stack else "outside"))
            t = u

    for s, e, part in sorted(spans, key=lambda x: (x[0], -x[1])):
        s, e = max(s, x0), min(e, x1)
        if e <= s:
            continue
        while stack and stack[-1][0] <= s:
            upto(stack[-1][0])
            stack.pop()
        upto(s)
        if stack:
            e = min(e, stack[-1][0])
        stack.append((e, part))
    while stack:
        upto(stack[-1][0])
        stack.pop()
    upto(x1)
    return runs


def idle_by_part(runs: Sequence[Tuple[int, int, str]],
                 busy: Sequence[Tuple[int, int]], x0: int, x1: int
                 ) -> Dict[str, int]:
    """Nanoseconds of ``[x0, x1)`` outside the merged ``busy`` intervals,
    by the label of ``runs`` (which cover ``[x0, x1)``)."""
    idle, t = [], x0
    for s, e in busy:
        if s > t:
            idle.append((t, min(s, x1)))
        t = max(t, e)
    if t < x1:
        idle.append((t, x1))
    out = dict.fromkeys(PARTS, 0)
    i = 0
    for g0, g1 in idle:
        while i < len(runs) and runs[i][1] <= g0:
            i += 1
        j = i
        while j < len(runs) and runs[j][0] < g1:
            r0, r1, part = runs[j]
            out[part] += min(r1, g1) - max(r0, g0)
            j += 1
    return out


def split(ops: Sequence[Tuple[str, int, int]], spans: Sequence,
          steps: int) -> Optional[dict]:
    """The five idle parts (ns), the extent's idle, and the ``copy_bytes``
    of the selected steps' span trees; None without device operations or
    when the ``rk3_step`` spans over the extent are not ``steps``."""
    if not ops or steps <= 0:
        return None
    x0 = min(s for _, s, _ in ops)
    x1 = max(e for _, _, e in ops)
    roots = [sp for sp in spans if sp.name == STEP and sp.parent is None
             and sp.end_ns > x0 and sp.start_ns < x1]
    threads = {sp.thread for sp in roots}
    if len(roots) != steps or len(threads) != 1:
        return None
    thread = threads.pop()
    mine = [sp for sp in spans if sp.thread == thread]
    busy = merged([(max(s, x0), min(e, x1)) for _, s, e in ops])
    runs = labelled([(sp.start_ns, sp.end_ns, part_of(sp.name))
                     for sp in mine if sp.end_ns > x0 and sp.start_ns < x1],
                    x0, x1)
    parts = idle_by_part(runs, busy, x0, x1)
    by_index = {sp.index: sp for sp in mine}
    chosen = {sp.index for sp in roots}

    def root(sp) -> int:
        while sp.parent is not None and sp.parent in by_index:
            sp = by_index[sp.parent]
        return sp.index

    copy_bytes = sum(sp.counts.get("copy_bytes", 0) for sp in mine
                     if sp.counts and root(sp) in chosen)
    idle = (x1 - x0) - sum(e - s for s, e in busy)
    return {"parts": parts, "idle_ns": idle, "copy_bytes": copy_bytes,
            "steps": steps}


def program_spans() -> Optional[list]:
    """The program's spans, or None where the program has no tracer."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.spans()


def of_run(run) -> Optional[dict]:
    """:func:`split` of a traced run's device-only sub-window, or None."""
    tr = getattr(run, "trace", None)
    if tr is None or not tr.ops:
        return None
    spans = program_spans()
    if not spans:
        return None
    return split(tr.ops, spans, tr.steps)
