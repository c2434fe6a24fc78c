"""Fault injection and containment primitives of the aggregation runtime.

Aggregation widens the damage one bad task can do: a NaN sub-grid, a
failed bucket or a stalled launch takes a whole bucket of slots down with
it.  This module provides

* a deterministic fault-injection harness, :class:`FaultSpec` and
  :class:`FaultInjector`, that injects failures at configurable sites
  (non-finite task payloads, simulated bucket-compile failures, delayed,
  failed or hanging launches, corrupted ring slots), seeded and
  composable, so tests replay exact failure schedules.  Schedules are the
  reference package's JSON format, and the same specs and seed fire the
  same log in either package;
* the error taxonomy and the tensor helpers the containment machinery in
  ``core/aggregation.py`` builds on: the per-bucket finite check
  (:func:`all_finite_async`, dispatched on the current stream without a
  host sync, and the blocking :func:`all_finite`), slot poisoning
  (:func:`poison_slots`) and the exceptions a failed task's future
  carries.

With no injector attached (the default) the hot path runs no extra device
work; with one attached but no spec matching, only host-side predicates
run.  Detection (``AggregationConfig(guard="finite")``), bisection,
quarantine, the launch watchdog and the circuit breakers live in
``AggregationExecutor``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch


# ---------------------------------------------------------------------------
# Error taxonomy
# ---------------------------------------------------------------------------

class FaultError(RuntimeError):
    """Base class for every fault the containment layer recognises."""


class BucketCompileError(FaultError):
    """A bucket program failed to build (simulated).  Building is
    deterministic per process, so the executor degrades the ladder: it
    never retries the same bucket size."""


class LaunchFaultError(FaultError):
    """A launch failed at dispatch (transient by assumption: the executor
    retries with bounded backoff before degrading to smaller buckets)."""


class LaunchTimeoutError(FaultError):
    """A dispatched launch did not complete within the per-launch budget
    (``AggregationConfig.launch_timeout_s``).  Raised by the watchdog; an
    injected hang is handled like a transient launch failure (bounded
    retries, then a rung ban and a re-drain through smaller buckets)."""


class TaskFailedError(FaultError):
    """Raised when reading the result of a task the guard marked failed.
    ``task_ids`` carries the wave-relative indices of the culprits."""

    def __init__(self, msg: str, task_ids: Sequence[int] = (),
                 kernel: str = ""):
        super().__init__(msg)
        self.task_ids = tuple(task_ids)
        self.kernel = kernel


class RegionFaultError(FaultError):
    """A fault that cannot be contained, re-raised with the region and
    bucket named (an injected hang with no watchdog budget)."""


class NonFiniteStateError(FaultError):
    """A guarded strategy without containment machinery (``fused``,
    ``s2``) produced a non-finite iterate: detection without bisection."""


# ---------------------------------------------------------------------------
# Fault specifications
# ---------------------------------------------------------------------------

SITES = ("payload", "compile", "launch", "ring")
PAYLOAD_MODES = ("nan", "inf")
LAUNCH_MODES = ("fail", "delay", "hang")


@dataclass(frozen=True)
class FaultSpec:
    """One deterministic injection rule.  ``None`` fields match anything.

    site="payload"  — the matched task's output slot becomes NaN/Inf in
                      every launch that contains it (re-executions
                      included: the poison is a property of the task, so
                      bisection finds it at any bucket size).  Matched by
                      (kernel, task, wave); ``rate`` draws a seeded coin
                      per (kernel, wave, task) instead.
    site="ring"     — the matched task's slot-ring input is poisoned at
                      submission (it flows through the kernel into a
                      non-finite output).
    site="compile"  — building the matched (kernel, bucket) program raises
                      :class:`BucketCompileError`.
    site="launch"   — dispatch of the matched (kernel, bucket) launch fails
                      (``mode="fail"``), is delayed by ``delay_s``
                      (``mode="delay"``), or hangs past any finite budget
                      (``mode="hang"``: only the watchdog ends it, with
                      :class:`LaunchTimeoutError`).  ``times`` bounds how
                      often the spec fires.
    """

    site: str
    kernel: Optional[str] = None      # kernel family id (None = any family)
    task: Optional[int] = None        # wave-relative task index
    wave: Optional[int] = None        # region wave counter (None = every)
    bucket: Optional[int] = None      # bucket size (compile/launch sites)
    mode: Optional[str] = None        # payload: nan|inf; launch: fail|...
    times: Optional[int] = None       # max fires (None = unbounded)
    rate: Optional[float] = None      # payload: seeded per-task coin
    delay_s: float = 0.0              # launch "delay" mode: seconds

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} — valid "
                             f"sites: {', '.join(SITES)}")
        if self.site in ("payload", "ring"):
            if self.mode is not None and self.mode not in PAYLOAD_MODES:
                raise ValueError(f"payload/ring mode must be one of "
                                 f"{PAYLOAD_MODES}, got {self.mode!r}")
            if self.task is None and self.rate is None:
                raise ValueError(f"{self.site} spec needs 'task' or 'rate' "
                                 f"— an unconditional poison would fail "
                                 f"every task")
        if self.site == "launch" and self.mode not in LAUNCH_MODES:
            raise ValueError(f"launch mode must be one of {LAUNCH_MODES}, "
                             f"got {self.mode!r}")
        if self.rate is not None and not (0.0 <= self.rate <= 1.0):
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.times is not None and self.times < 1:
            raise ValueError(f"times must be >= 1, got {self.times}")


def _coin(seed: int, *key) -> float:
    """Deterministic draw in [0, 1) from (seed, *key): stable across
    processes and call order, so a ``rate`` schedule replays exactly."""
    h = hashlib.blake2b(repr((seed,) + key).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "big") / 2.0 ** 64


class FaultInjector:
    """Deterministic, composable fault schedule over many
    :class:`FaultSpec` rules.  Attach to an executor with
    ``AggregationExecutor.set_fault_injector`` (or ``fault_injector=`` at
    construction), to a ``StrategyRunner`` or a ``ServingEngine`` the same
    way.

    Every fired injection is appended to ``log`` as a ``(site, kernel,
    wave, detail)`` tuple: the replayable record a test asserts against,
    which a second injector with the same specs and seed reproduces.
    """

    def __init__(self, specs: Sequence[FaultSpec], seed: int = 0):
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self.seed = int(seed)
        self._fired: Dict[int, int] = {}
        self.log: List[Tuple[str, str, Optional[int], Any]] = []

    # -- matching ----------------------------------------------------------
    @staticmethod
    def _field_ok(want, got) -> bool:
        return want is None or want == got

    def _fire(self, i: int, spec: FaultSpec, kernel: str,
              wave: Optional[int], detail) -> bool:
        n = self._fired.get(i, 0)
        if spec.times is not None and n >= spec.times:
            return False
        self._fired[i] = n + 1
        self.log.append((spec.site, kernel, wave, detail))
        return True

    # -- sites -------------------------------------------------------------
    def poison_positions(self, kernel: str, wave: int,
                         wave_ids: Sequence[int]) -> Dict[int, str]:
        """Which positions of a launch (0..k-1, identified by their
        wave-relative task ids) carry a payload fault now; returns
        ``{position: mode}``.  Called on every launch and every bisection
        re-execution: the poison follows the task."""
        out: Dict[int, str] = {}
        for i, spec in enumerate(self.specs):
            if spec.site != "payload":
                continue
            if not (self._field_ok(spec.kernel, kernel)
                    and self._field_ok(spec.wave, wave)):
                continue
            mode = spec.mode or "nan"
            for pos, tid in enumerate(wave_ids):
                if pos in out:
                    continue
                if spec.task is not None:
                    if spec.task == tid and self._fire(i, spec, kernel, wave,
                                                       ("task", tid)):
                        out[pos] = mode
                elif spec.rate is not None:
                    if (_coin(self.seed, "payload", kernel, wave, tid)
                            < spec.rate
                            and self._fire(i, spec, kernel, wave,
                                           ("task", tid))):
                        out[pos] = mode
        return out

    def corrupt_ring(self, kernel: str, wave: int,
                     task_id: int) -> Optional[str]:
        """Should this task's ring slot be poisoned at submission?"""
        for i, spec in enumerate(self.specs):
            if spec.site != "ring":
                continue
            if not (self._field_ok(spec.kernel, kernel)
                    and self._field_ok(spec.wave, wave)):
                continue
            hit = (spec.task == task_id if spec.task is not None
                   else _coin(self.seed, "ring", kernel, wave,
                              task_id) < (spec.rate or 0.0))
            if hit and self._fire(i, spec, kernel, wave, ("task", task_id)):
                return spec.mode or "nan"
        return None

    def compile_fails(self, kernel: str, bucket: int) -> bool:
        """Does building the (kernel, bucket) program fail?"""
        for i, spec in enumerate(self.specs):
            if (spec.site == "compile"
                    and self._field_ok(spec.kernel, kernel)
                    and self._field_ok(spec.bucket, bucket)
                    and self._fire(i, spec, kernel, None,
                                   ("bucket", bucket))):
                return True
        return False

    def launch_fault(self, kernel: str,
                     bucket: int) -> Optional[Tuple[str, float]]:
        """Launch-site injection: ``(mode, delay_s)`` of the first matching
        spec (``"fail"``, ``"delay"`` or ``"hang"``); None when clean."""
        for i, spec in enumerate(self.specs):
            if (spec.site == "launch"
                    and self._field_ok(spec.kernel, kernel)
                    and self._field_ok(spec.bucket, bucket)
                    and self._fire(i, spec, kernel, None,
                                   ("bucket", bucket))):
                return (spec.mode, spec.delay_s)
        return None

    # -- schedule round trip -----------------------------------------------
    def save_schedule(self, path: str) -> str:
        """Write the schedule (specs and seed) and the fired log as JSON:
        ``FaultInjector.from_schedule(path)`` rebuilds an injector that,
        driven through the same run, fires the same sequence."""
        payload = {
            "version": 1,
            "seed": self.seed,
            "specs": [dataclasses.asdict(s) for s in self.specs],
            "log": [list(entry) for entry in self.log],
        }
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
        return path

    @classmethod
    def from_schedule(cls, path: str) -> "FaultInjector":
        """Rebuild an injector from a ``save_schedule`` file (fresh fire
        counters: replaying the run reproduces the saved ``log``)."""
        with open(path) as f:
            payload = json.load(f)
        specs = [FaultSpec(**d) for d in payload["specs"]]
        return cls(specs, seed=payload["seed"])


# ---------------------------------------------------------------------------
# Tensor helpers (the executor's guard, the runner's and the engine's)
# ---------------------------------------------------------------------------

Tensors = Union[torch.Tensor, Sequence[torch.Tensor]]


def _inexact(x: Tensors) -> List[torch.Tensor]:
    """The floating (or complex) tensors of a tensor or a sequence."""
    xs = (x,) if isinstance(x, torch.Tensor) else tuple(x)
    return [t for t in xs
            if isinstance(t, torch.Tensor)
            and (t.is_floating_point() or t.is_complex())]


def all_finite_async(x: Tensors):
    """Are all floating entries finite?  A 0-dim bool tensor, issued on the
    current stream without a host sync (``torch.isfinite(x).all()``, one
    more ``logical_and`` per further tensor), or plain True when nothing
    is checkable.  The guard issues it right after each launch, on the
    launch's stream, and reads every verdict of a flush at once."""
    leaves = _inexact(x)
    if not leaves:
        return True
    acc = torch.isfinite(leaves[0]).all()
    for t in leaves[1:]:
        acc = acc & torch.isfinite(t).all()
    return acc


def all_finite(x: Tensors) -> bool:
    """The blocking form of :func:`all_finite_async`: one scalar per
    checked tensor set (per bucket, not per slot: bisection recovers slot
    resolution in O(log bucket) launches only when a bucket trips)."""
    verdict = all_finite_async(x)
    return verdict if isinstance(verdict, bool) else bool(verdict)


def poison_slots(out: torch.Tensor, positions: Sequence[int],
                 modes: Optional[Dict[int, str]] = None,
                 inplace: bool = False) -> torch.Tensor:
    """Overwrite the given slot positions of a batched output with NaN (or
    +Inf for positions whose mode is ``"inf"``), on the current stream.
    A copy unless ``inplace`` (for an output nothing else has read yet,
    on the stream that produced it).  Integer outputs cannot carry the
    poison and are returned untouched."""
    if not positions or not (out.is_floating_point() or out.is_complex()):
        return out
    modes = modes or {}
    if not inplace:
        out = out.clone()
    for mode in ("nan", "inf"):
        pos = [p for p in positions if modes.get(p, "nan") == mode]
        if pos:
            idx = torch.tensor(pos, dtype=torch.long).to(out.device,
                                                         non_blocking=True)
            out.index_fill_(0, idx, math.nan if mode == "nan" else math.inf)
    return out


def poison_args(args: Sequence[torch.Tensor],
                mode: str = "nan") -> Tuple[torch.Tensor, ...]:
    """NaN/Inf-filled copies of one task's floating arguments (integer
    ones kept): the ring-corruption site's payload."""
    val = math.nan if mode == "nan" else math.inf
    return tuple(torch.full_like(a, val)
                 if a.is_floating_point() or a.is_complex() else a
                 for a in args)


# ---------------------------------------------------------------------------
# Quarantine
# ---------------------------------------------------------------------------

@dataclass
class QuarantineList:
    """Per-region repeat-offender memory: wave-relative task indices whose
    outputs tripped the guard ``threshold`` times are quarantined.  A
    quarantined index short-circuits bisection on later trips: it is
    re-executed on its own, so a known offender costs O(1) extra launches
    instead of O(log bucket)."""

    threshold: int = 2
    offenses: Dict[int, int] = field(default_factory=dict)
    members: set = field(default_factory=set)

    def record_offense(self, task_id: int) -> bool:
        """Count one guard trip against ``task_id``; True when the index
        just crossed the threshold (newly quarantined)."""
        n = self.offenses.get(task_id, 0) + 1
        self.offenses[task_id] = n
        if n >= self.threshold and task_id not in self.members:
            self.members.add(task_id)
            return True
        return False

    def __contains__(self, task_id: int) -> bool:
        return task_id in self.members

    def as_stats(self) -> List[int]:
        return sorted(self.members)


__all__ = [
    "FaultError", "BucketCompileError", "LaunchFaultError",
    "LaunchTimeoutError", "TaskFailedError", "RegionFaultError",
    "NonFiniteStateError",
    "FaultSpec", "FaultInjector", "QuarantineList",
    "all_finite", "all_finite_async", "poison_slots", "poison_args", "SITES",
]
