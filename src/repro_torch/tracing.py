"""The port's own spans, stamped on ``torch.profiler``'s clock.

``span(name, tag=None)`` marks one layer boundary of a step (every name
starts with ``repro_torch.``); ``add(key, n)`` adds a count (the program
adds ``copy_bytes``) to the calling thread's innermost open span.
The root of each span tree is one ``repro_torch.rk3_step`` or one
``repro_torch.courant_dt``.

The tracer is off unless :func:`enable` was called or a ``torch.profiler``
profile is running (the profiler's own Python flag).  Off, ``span``
returns one shared null context: it allocates nothing, reads no clock and
calls no torch op.  On, every finished span is kept in memory as a
:class:`Span`, at most :data:`LIMIT` of them (:func:`dropped` counts the
rest), until :func:`clear`.  Each span is stamped with :data:`clock`, the
clock of the profiler's kineto events, so a span can be laid over the
device's activity in a trace.  While a profiler runs, each span also
opens a profiler range ``name`` (``name[tag]`` with a tag) inside its own
interval, so the profiler's trace holds it on the host where the profiler
records the host's operations; a device-only profile records none.

:func:`device_intervals` and :func:`union_ns` give a profile's device
busy time: the union of every kernel, copy and fill over all streams.
"""
from __future__ import annotations

import itertools
import threading
import time
from contextlib import nullcontext
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.autograd.profiler as _profiler

LIMIT = 1_000_000
# the clock of torch.profiler's kineto events (Unix nanoseconds)
clock = time.time_ns


class Span(NamedTuple):
    index: int                 # the order the span opened in
    name: str
    tag: Optional[str]
    start_ns: int
    end_ns: int
    parent: Optional[int]      # the enclosing span's index
    thread: int                # threading.get_ident()
    counts: Optional[Dict[str, int]]


# a profiler range that the profiler records only where it records the
# host's operations (a ``record_function``, which opens a dispatcher op,
# costs ~10 µs a span on the card's host even in a device-only profile)
_mirror = getattr(torch._C._profiler, "_RecordFunctionFast",
                  _profiler.record_function)
_enabled = False
_spans: List[tuple] = []       # Span fields, kept as plain tuples
_dropped = 0
_next = itertools.count()
_local = threading.local()
_NULL = nullcontext()


class _Open:
    __slots__ = ("name", "tag", "index", "parent", "start", "counts",
                 "mirror", "stack")

    def __init__(self, name: str, tag: Optional[str]):
        self.name, self.tag = name, tag
        self.counts = self.mirror = None

    def __enter__(self):
        try:
            stack = _local.stack
        except AttributeError:
            stack = _local.stack = []
        self.stack = stack
        self.parent = stack[-1].index if stack else None
        self.index = next(_next)
        stack.append(self)
        self.start = clock()
        if _profiler._is_profiler_enabled:
            self.mirror = _mirror(self.name if self.tag is None
                                  else f"{self.name}[{self.tag}]")
            self.mirror.__enter__()
        return self

    def __exit__(self, *exc):
        if self.mirror is not None:
            self.mirror.__exit__(*exc)
        end = clock()
        self.stack.pop()
        if len(_spans) < LIMIT:
            _spans.append((self.index, self.name, self.tag, self.start, end,
                           self.parent, threading.get_ident(), self.counts))
        else:
            global _dropped
            _dropped += 1
        return False


def on() -> bool:
    """Whether spans are recorded: :func:`enable` was called or a
    ``torch.profiler`` profile is running.  A count that takes work to
    reckon is reckoned only where this holds."""
    return _enabled or _profiler._is_profiler_enabled


def span(name: str, tag: Optional[str] = None):
    """A context manager around one layer boundary: a recorded span when
    the tracer is on, else the shared null context."""
    if _enabled or _profiler._is_profiler_enabled:
        return _Open(name, tag)
    return _NULL


def add(key: str, n: int) -> None:
    """Add ``n`` to count ``key`` of the calling thread's innermost open
    span (nothing when the tracer is off or none is open)."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return
    stack = getattr(_local, "stack", None)
    if stack:
        top = stack[-1]
        if top.counts is None:
            top.counts = {}
        top.counts[key] = top.counts.get(key, 0) + n


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def spans() -> List[Span]:
    """The finished spans, in the order they closed."""
    return [Span._make(s) for s in _spans]


def dropped() -> int:
    """Spans not kept since the last :func:`clear`, past :data:`LIMIT`."""
    return _dropped


def clear() -> None:
    global _dropped, _next
    _spans.clear()
    _dropped = 0
    _next = itertools.count()


def nbytes(tensors: Sequence[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def device_intervals(prof) -> List[Tuple[int, int]]:
    """``(start_ns, end_ns)`` of every device operation (kernel, copy,
    fill) in a finished ``torch.profiler`` profile, read from its raw
    kineto events; the device-side ranges of ``record_function`` spans are
    left out."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.start_ns(), e.end_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and not e.is_user_annotation()]


def union_ns(intervals: Sequence[Tuple[int, int]]) -> int:
    """The length of the union of ``(start, end)`` intervals: concurrent
    streams count once."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total
