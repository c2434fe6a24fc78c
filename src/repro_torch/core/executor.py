"""Device executors and the pre-allocated executor pool (CPPuddle analogue).

On the card a ``DeviceExecutor`` is one CUDA stream.  A launch waits for
the work the caller's stream has queued (the producer of its inputs), runs
on the executor's stream and records an event; ``busy()`` asks that event
whether the stream is still working — the paper's launch criterion for
strategy 3 — and ``join()`` makes the caller's stream wait for it without
a host sync.  Unlike XLA:TPU executors, CUDA streams do overlap on the
device.

On the CPU an executor has no stream: launches run inline and it is never
busy, so a wave drains exactly as on an idle card.
"""
from __future__ import annotations

import itertools
import time
from typing import Callable, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device


class DeviceExecutor:
    """One launch queue: a CUDA stream on the card, inline on the CPU."""

    def __init__(self, index: int, device: DeviceLike = None):
        self.index = index
        self.device = resolve_device(device)
        on_card = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if on_card else None
        self._event = None            # last launch's completion event
        self.launches = 0             # statistics
        self.launches_by_family: dict = {}   # kernel-family tag -> count
        self.dispatch_s = 0.0         # host time spent enqueueing launches

    def run(self, fn: Callable, *args) -> torch.Tensor:
        """Run ``fn(*args) -> tensor`` on this executor's stream, uncounted.

        The stream first waits for the caller's stream, which produced the
        inputs.  Inputs are recorded on this stream and outputs on the
        caller's, so the caching allocator reuses neither before the
        stream that reads it is done.
        """
        if self.stream is None:
            return fn(*args)
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            out = fn(*args)
        for a in args:
            if isinstance(a, torch.Tensor):
                a.record_stream(self.stream)
        out.record_stream(caller)
        self._event = self.stream.record_event()
        return out

    def launch(self, fn: Callable, *args, family: Optional[str] = None,
               count: int = 1) -> torch.Tensor:
        """:meth:`run`, counted as ``count`` launches (a program that
        replays several bucket launches counts each; a raising ``fn``
        counts none)."""
        t0 = time.perf_counter()
        try:
            out = self.run(fn, *args)
        finally:
            self.dispatch_s += time.perf_counter() - t0
        self.launches += count
        if family is not None:
            self.launches_by_family[family] = \
                self.launches_by_family.get(family, 0) + count
        return out

    def follow(self, fn: Callable, *args):
        """Run ``fn(*args)`` on this executor's stream after its last
        launch, uncounted (the guard's poison and finite reduction): the
        stream does not wait for the caller's, and the completion event is
        recorded again, so :meth:`join` and :attr:`last_event` cover it.
        A tensor result is recorded on the caller's stream, as a launch's
        output is."""
        if self.stream is None:
            return fn(*args)
        with torch.cuda.stream(self.stream):
            out = fn(*args)
        if isinstance(out, torch.Tensor):
            out.record_stream(torch.cuda.current_stream(self.device))
        self._event = self.stream.record_event()
        return out

    @property
    def last_event(self):
        """The completion event of the last launch (None on the CPU or
        before any launch)."""
        return self._event

    def busy(self) -> bool:
        return self._event is not None and not self._event.query()

    def join(self) -> None:
        """Make the caller's current stream wait for every launch so far
        (device-side; the host does not block)."""
        if self._event is not None:
            torch.cuda.current_stream(self.device).wait_event(self._event)

    def drain(self) -> None:
        """Block the host until every launch on this executor is done."""
        if self.stream is not None:
            self.stream.synchronize()


class ExecutorPool:
    """Pre-allocated pool of executors (CPPuddle's ``executor_pool``
    analogue), handed out round robin, or under ``scheduling="load"`` the
    first idle one (its last event done), else the next round robin."""

    SCHEDULES = ("round_robin", "load")

    def __init__(self, n_executors: int = 1, device: DeviceLike = None,
                 scheduling: str = "round_robin"):
        if n_executors < 1:
            raise ValueError(f"n_executors must be >= 1, got {n_executors}")
        if scheduling not in self.SCHEDULES:
            raise ValueError(f"unknown scheduling {scheduling!r}; valid: "
                             f"{self.SCHEDULES}")
        dev = resolve_device(device)
        self.executors = [DeviceExecutor(i, dev) for i in range(n_executors)]
        self.scheduling = scheduling
        self._rr = itertools.cycle(range(n_executors))

    def __len__(self) -> int:
        return len(self.executors)

    def get(self) -> DeviceExecutor:
        if self.scheduling == "load":
            for e in self.executors:
                if not e.busy():
                    return e
        return self.executors[next(self._rr)]

    def any_idle(self) -> bool:
        return any(not e.busy() for e in self.executors)

    def join(self) -> None:
        for e in self.executors:
            e.join()

    def drain(self) -> None:
        for e in self.executors:
            e.drain()

    @property
    def total_launches(self) -> int:
        return sum(e.launches for e in self.executors)

    @property
    def total_dispatch_s(self) -> float:
        """Host seconds spent enqueueing launches, summed over executors."""
        return sum(e.dispatch_s for e in self.executors)

    @property
    def launches_by_family(self) -> dict:
        """Pool-wide launch counts per kernel family tag."""
        out: dict = {}
        for e in self.executors:
            for k, v in e.launches_by_family.items():
                out[k] = out.get(k, 0) + v
        return out
