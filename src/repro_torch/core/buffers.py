"""Staging buffers: the device-resident slot ring and the host slab
recycler.

* ``SlotRing`` — CPPuddle's pre-allocated aggregation buffer on the
  device: one ``(capacity, *task_shape)`` tensor per kernel argument,
  double-buffered.  ``write`` queues a task's inputs host-side; ``commit``
  materialises every pending slot with ONE ``copy_`` per argument of the
  stacked block, and a bucket launch reads the filled prefix as a
  ``narrow`` of the ring, with no staging copy.
* ``BufferPool`` — the host slab recycler of ``staging="host"``: CPU slabs
  recycled by ``(shape, dtype)``, pinned when the device is the card, so
  one non-blocking H2D copy moves a whole bucket.

Unlike the reference's donated JAX buffers, a ring buffer here is written
in place on the caller's stream while bucket launches on other streams may
still read it.  ``record_stream`` only delays freeing a block; it does not
order a later write after those reads.  So every launch that reads a
buffer leaves an event (``track_read``), and each write into the buffer
makes the writing stream wait for the events of the slots it overwrites —
on the device, without a host sync.  Likewise a pinned slab goes back to
the pool only with the event of its H2D copy, and is handed out again once
that event has completed.
"""
from __future__ import annotations

import math
import threading
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device


class BufferPool:
    """Slab recycler: ``acquire`` hands out a released CPU slab of the same
    ``(shape, dtype)`` if one is free, else allocates (the "malloc").
    ``pinned`` slabs are page-locked, for non-blocking copies to the card.
    A slab released with an event is free only once the event completes
    (its copy to the card has finished reading it)."""

    def __init__(self, pinned: bool = False):
        self.pinned = pinned
        self._free: Dict[Tuple, List[torch.Tensor]] = defaultdict(list)
        self._in_flight: List[Tuple[Any, torch.Tensor]] = []
        self._lock = threading.Lock()
        self.allocations = 0        # statistics: actual allocations
        self.reuses = 0

    @staticmethod
    def _key(shape: Sequence[int], dtype: torch.dtype) -> Tuple:
        return tuple(shape), dtype

    def _reclaim(self) -> None:
        """Move slabs whose copy has completed back to the free lists."""
        pending = []
        for event, slab in self._in_flight:
            if event.query():
                self._free[self._key(slab.shape, slab.dtype)].append(slab)
            else:
                pending.append((event, slab))
        self._in_flight = pending

    def acquire(self, shape: Sequence[int], dtype: torch.dtype
                ) -> torch.Tensor:
        key = self._key(shape, dtype)
        with self._lock:
            self._reclaim()
            if self._free[key]:
                self.reuses += 1
                return self._free[key].pop()
        self.allocations += 1
        return torch.empty(tuple(shape), dtype=dtype, pin_memory=self.pinned)

    def release(self, slab: torch.Tensor, event=None) -> None:
        """Return a slab; with ``event`` (a ``torch.cuda.Event`` recorded
        after the copy that reads it), only once the event has completed."""
        with self._lock:
            if event is None:
                self._free[self._key(slab.shape, slab.dtype)].append(slab)
            else:
                self._in_flight.append((event, slab))

    @property
    def in_flight(self) -> int:
        """Slabs released whose copy may still be running."""
        with self._lock:
            return len(self._in_flight)

    def stage(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Stack per-task CPU tensors into one recycled slab."""
        slab = self.acquire((len(parts),) + tuple(parts[0].shape),
                            parts[0].dtype)
        torch.stack(list(parts), out=slab)
        return slab


def _bad_value(mode: str) -> float:
    return math.nan if mode == "nan" else math.inf


class SlotRing:
    """Double-buffered device staging ring for aggregated task inputs.

    One ring per kernel argument, each ``(capacity, *task_shape)``.  Tasks
    claim consecutive slots; a bucket launch reads ``[first, first + k)``
    of the active buffers in place.  After a launch drains the queue the
    caller ``swap``s to the other buffer, so new writes do not land in a
    buffer an in-flight launch is reading (and the write that would, two
    waves later, waits for that launch's event on the device).

    ``write`` only records the task's inputs; ``commit`` (implicit in
    ``buffers`` and ``compact``) writes every pending slot with one
    ``copy_`` per argument of the stacked block.  When the active buffer is
    full while a remainder is still queued (watermark-triggered partial
    launches), ``compact`` rolls the live suffix to the front, as the
    reference's ``jnp.roll`` does, through a temporary (the move overlaps
    itself).
    """

    def __init__(self, capacity: int, example_args: Sequence[torch.Tensor],
                 n_buffers: int = 2, device: DeviceLike = None):
        if capacity < 1 or n_buffers < 1:
            raise ValueError(f"capacity and n_buffers must be >= 1, got "
                             f"{capacity} and {n_buffers}")
        self.capacity = capacity
        self.device = resolve_device(device)
        self._specs = [(tuple(a.shape), a.dtype) for a in example_args]
        self._bufs = [
            [torch.zeros((capacity,) + shape, dtype=dtype,
                         device=self.device)
             for shape, dtype in self._specs]
            for _ in range(n_buffers)]
        # per buffer: (lo, hi, event) of launches that may still read it
        self._readers: List[List[Tuple[int, int, Any]]] = [
            [] for _ in range(n_buffers)]
        self._active = 0
        self._pending: List[Tuple[torch.Tensor, ...]] = []
        self._committed = 0           # slots written on the device
        self.fill = 0                 # next free slot (pending included)
        self.writes = 0               # statistics: logical slot writes
        self.commits = 0              # block copies (one per commit)
        self.compactions = 0
        self.swaps = 0

    @property
    def n_args(self) -> int:
        return len(self._specs)

    def buffers(self) -> Tuple[torch.Tensor, ...]:
        """The active ring buffers (one per argument), every pending write
        committed."""
        self.commit()
        return tuple(self._bufs[self._active])

    def all_buffers(self) -> List[Tuple[torch.Tensor, ...]]:
        """Every buffer's tensors (one per argument), active or not: the
        fixed inputs a captured ring program reads."""
        return [tuple(bufs) for bufs in self._bufs]

    def track_read(self, lo: int, hi: int, event) -> None:
        """A launch reading slots ``[lo, hi)`` of the active buffers ends at
        ``event`` (recorded on its stream); a later write into those slots
        waits for it.  No-op off the card (``event`` is None)."""
        if event is not None:
            self._readers[self._active].append((lo, hi, event))

    def _before_write(self, lo: int, hi: int) -> None:
        """Make the current stream wait for every tracked launch that reads
        slots ``[lo, hi)`` of the active buffers (device-side)."""
        readers = self._readers[self._active]
        if not readers:
            return
        stream = torch.cuda.current_stream(self.device)
        keep = []
        for r_lo, r_hi, event in readers:
            if r_lo < hi and lo < r_hi:
                stream.wait_event(event)
            else:
                keep.append((r_lo, r_hi, event))
        self._readers[self._active] = keep

    def write(self, args: Sequence[torch.Tensor]) -> int:
        """Claim the next free slot for one task's inputs; returns the slot.
        The write is deferred to the next ``commit``.  Compact or swap
        before writing to a full ring."""
        if self.fill >= self.capacity:
            raise RuntimeError("ring full — compact first")
        if len(args) != self.n_args:
            raise ValueError(f"ring takes {self.n_args} arguments per task, "
                             f"got {len(args)}")
        slot = self.fill
        self._pending.append(tuple(args))
        self.fill += 1
        self.writes += 1
        return slot

    def commit(self) -> None:
        """Write the pending slots: one ``copy_`` per argument of the
        stacked block into ``[committed, fill)``."""
        if not self._pending:
            return
        lo, hi = self._committed, self.fill
        self._before_write(lo, hi)
        for j, buf in enumerate(self._bufs[self._active]):
            parts = [p[j] for p in self._pending]
            block = (parts[0].unsqueeze(0) if len(parts) == 1
                     else torch.stack(parts))
            buf.narrow(0, lo, hi - lo).copy_(block, non_blocking=True)
        self._committed = hi
        self._pending.clear()
        self.commits += 1

    def poison(self, slot: int, mode: str = "nan") -> None:
        """Corrupt one claimed slot's staged inputs (a fault-injection site:
        a bad copy or a stale buffer handed to the wrong task).  A pending
        write is replaced before it reaches the device; a committed slot is
        overwritten in place.  Integer arguments are left intact."""
        if not 0 <= slot < self.fill:
            raise ValueError(f"slot {slot} is not claimed (fill {self.fill})")
        val = _bad_value(mode)
        if slot >= self._committed:
            i = slot - self._committed
            self._pending[i] = tuple(
                torch.full_like(a, val) if a.is_floating_point() else a
                for a in self._pending[i])
            return
        self._before_write(slot, slot + 1)
        for buf in self._bufs[self._active]:
            if buf.is_floating_point():
                buf[slot].fill_(val)

    def compact(self, start: int) -> None:
        """Renumber the live slots ``[start, fill)`` down to ``[0, fill -
        start)``: the whole buffer rolled by ``-start``."""
        self.commit()
        self._before_write(0, self.capacity)
        for buf in self._bufs[self._active]:
            buf.copy_(torch.roll(buf, -start, 0))
        self.fill -= start
        self._committed = self.fill
        self.compactions += 1

    def swap(self) -> None:
        """Switch to the other buffer and reset the fill cursor (called when
        the queue drains, so the just-launched buffer stays untouched)."""
        self.commit()                 # never strand writes on the old buffer
        self._active = (self._active + 1) % len(self._bufs)
        self.fill = 0
        self._committed = 0
        self.swaps += 1
