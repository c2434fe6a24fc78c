"""One run of one cell: set-up, the timed window, the traced sub-windows,
the comparison with the plain reference, and the result line.

The timed loop is a simulation's own: each step takes the program's
Courant dt, runs ``StrategyRunner.rk3_step`` and reads dt on the host
(as a run that stops at a set time, or reduces dt across nodes, must).
That read ends the step: the host clock there gives each step's wall
time, and the loop makes no other synchronisation.  Every
``restart_every`` steps (the mix's, from the physics: the blast stays in
the domain, and in the refined patch) the state is reassigned to the
initial one, outside every step's time.

A traced run (``trace=True``) runs the same window with the benchmark's
spans around the dt, the step and the dt read, then two profiled
sub-windows from the initial state: ``trace_steps`` steps with the
device's activity alone (busy time, kernel time, the device operations
with most time), kept only when its kernels are as many as the bucket
programs replayed (retaken once, else the run fails), and a short one
with the host's activity too (the idle gaps by what the host was doing).
"""
from __future__ import annotations

import gc
import importlib
import json
import math
import random
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, List, Optional

import torch

from portbench import compare, devtrace
from portbench import manifest as mf

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
HOST_TRACED_STEPS = 8


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names of ``modules`` (``sys.modules``) that the run must
    not load, compared whole (``repro_torch`` is not ``repro``)."""
    names = list(sys.modules if modules is None else modules)
    return sorted({m.partition(".")[0] for m in names} & set(FORBIDDEN))


@dataclass
class Window:
    times: List[float]        # each step's wall seconds
    seconds: float            # first step's start to the last dt read
    failed: int               # steps whose dt read was not finite and > 0
    kept: Optional[list]      # (dt, state) of one segment's first steps

    @property
    def steps(self) -> int:
        return len(self.times)

    def p95_s(self) -> float:
        ordered = sorted(self.times)
        return ordered[math.ceil(0.95 * len(ordered)) - 1]


def drive(prog, u0, restart_every: int, check_steps: int, rng,
          seconds: Optional[float] = None, steps: Optional[int] = None,
          spans: bool = False) -> Window:
    """The timed loop, until ``seconds`` have passed at a step's end (and
    one segment has reached ``check_steps``) or ``steps`` steps are done.
    Keeps the first ``check_steps`` outputs of one restart segment, drawn
    uniformly from the seed (``rng``) among the segments that reached
    them."""
    from torch.profiler import record_function
    span = record_function if spans else (lambda name: nullcontext())
    courant, step = prog.courant, prog.step
    times: List[float] = []
    failed, segments = 0, 0
    kept, first = None, []
    u, k = u0, 0
    start = prev = time.perf_counter()
    deadline = math.inf if seconds is None else start + seconds
    while True:
        with span("portbench.dt"):
            dt = courant(u)
        with span("portbench.rk3_step"):
            u = step(u, dt)
        with span("portbench.dt_read"):
            dt_host = dt.item()
        now = time.perf_counter()
        times.append(now - prev)
        prev = now
        if not (math.isfinite(dt_host) and dt_host > 0):
            failed += 1
        k += 1
        if k <= check_steps:
            first.append((dt, u))
            if k == check_steps:
                segments += 1
                if rng.randrange(segments) == 0:
                    kept = first
                first = []
        # a timed window closes at a step's end past the deadline, once a
        # segment's checked steps are in
        if ((now >= deadline and kept is not None)
                or (steps is not None and len(times) >= steps)):
            return Window(times, now - start, failed, kept)
        if k == restart_every:
            u, k, first = u0, 0, []
            prev = time.perf_counter()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _counters(runner) -> dict:
    exe = runner.executor
    return {"enqueue_s": runner.pool.total_dispatch_s,
            "launches": runner.stats["kernel_launches"],
            "captures": exe.stats.get("captures", 0) if exe else 0,
            "graph_bytes": exe.stats.get("graph_bytes", 0) if exe else 0,
            "exchange_graphs": len(getattr(runner.scenario,
                                           "exchange_graphs", {}))}


def _replayed() -> dict:
    from repro_torch.core.graphs import replayed_kernels
    return replayed_kernels()


def _profiled(prog, u0, mix, check_steps, device, host: bool, steps: int):
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CUDA if device.type == "cuda"
            else ProfilerActivity.CPU]
    if host and device.type == "cuda":
        acts.append(ProfilerActivity.CPU)
    _sync(device)
    with profile(activities=acts) as prof:
        with record_function(devtrace.SPAN_PREFIX + "window"):
            w = drive(prog, u0, mix["restart_every"], check_steps,
                      random.Random(0), steps=steps, spans=True)
    return devtrace.DeviceTrace(prof, w.steps, w.seconds)


def _trace(prog, u0, mix, check_steps, device, log):
    """The device-only sub-window, checked against the replays' kernels
    and retaken once; then the host-traced one for the idle gaps."""
    for attempt in (1, 2):
        before = _replayed()
        tr = _profiled(prog, u0, mix, check_steps, device, host=False,
                       steps=mix["trace_steps"])
        after = _replayed()
        delta = {k: v - before.get(k, 0) for k, v in after.items()
                 if v != before.get(k, 0)}
        bad = devtrace.kernel_count_mismatch(tr, delta)
        log(f"traced sub-window {attempt}: {tr.steps} steps, "
            f"{tr.window_s:.6f} s, replayed kernels {delta}")
        if bad is None:
            break
        log(f"traced sub-window {attempt} lost kernels: {bad}")
    else:
        raise RuntimeError(f"the trace lost kernels twice: {bad}")
    gaps = _profiled(prog, u0, mix, check_steps, device, host=True,
                     steps=HOST_TRACED_STEPS).idle_gaps()
    return tr, gaps


def run_cell(wl: dict, config: dict, mix: dict, seed: int, seconds: float,
             trace: bool, device: torch.device, manifest: dict,
             t0: float, log: Callable[[str], None] = print,
             here: Path = mf.HERE, program: Optional[Callable] = None
             ) -> dict:
    """One run; returns the result line's object (``checks`` last), and
    ``phases`` (kept out of the line) for the run's file.  ``program``
    swaps in another program for the cell (the tests' faults and
    control)."""
    phases = {"imports_s": time.perf_counter() - t0}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    scenario = importlib.import_module(
        f"portbench.scenarios.{config['scenario']}")
    cell = scenario.Cell(config, mix, device)
    check_steps = config["check"]["steps"]
    if not 1 <= check_steps <= mix["restart_every"]:
        raise ValueError("check.steps must lie in 1 .. restart_every")
    u0 = cell.initial_state(seed)
    _sync(device)
    phases["state_s"] = time.perf_counter() - t0
    prog = (program or cell.program)()
    _sync(device)
    phases["program_s"] = time.perf_counter() - t0
    # one untimed step: the bucket programs a warmup leaves are made here
    dt = prog.courant(u0)
    prog.step(u0, dt)
    dt.item()
    _sync(device)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    phases["setup_s"] = setup_s

    runner = getattr(prog, "runner", None)
    before = _counters(runner) if runner is not None else None
    window = drive(prog, u0, mix["restart_every"], check_steps,
                   random.Random(seed), seconds=seconds, spans=trace)
    _sync(device)
    after = _counters(runner) if runner is not None else None
    counters = ({k: after[k] - before[k] for k in after}
                if runner is not None else {})
    tr = gaps = None
    if trace:
        tr, gaps = _trace(prog, u0, mix, check_steps, device, log)
    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    ordered = sorted(window.times)
    phases.update(window_steps=window.steps, window_s=window.seconds,
                  step_ms_p50=ordered[len(ordered) // 2] * 1e3,
                  step_ms_max=ordered[-1] * 1e3,
                  counters=counters, memory_peak_bytes=memory_peak,
                  graph_bytes=after["graph_bytes"] if after else 0,
                  captures=after["captures"] if after else 0)

    # the program is freed before the reference runs
    kept = window.kept
    del prog, runner
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    if kept is None:
        nums = dict.fromkeys(compare.NAMES, math.inf)
    else:
        ref = compare.reference_steps(cell.reference(), cell.levels(u0),
                                      check_steps)
        nums = compare.numbers([(d, cell.levels(s)) for d, s in kept], ref,
                               cell.levels(u0), cell.config["subgrid"])
    _sync(device)
    phases["reference_s"] = time.perf_counter() - t_ref
    limits = config["check"]["limits"]
    correct = compare.verdict(nums, limits) and window.failed == 0

    run = SimpleNamespace(cell=cell, window=window, counters=counters,
                          setup_s=setup_s, trace=tr)
    metrics = mf.read_metrics(manifest, wl["name"], run, here,
                              "per_layer" if trace else "end_to_end")
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": memory_peak}
    result = {"correct": correct, "attempted": window.steps,
              "failed": window.failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": gaps}
    result["checks"] = {k: {"value": nums[k], "limit": limits[k]}
                        for k in compare.NAMES}
    result["phases"] = phases
    return result


def main(argv=None, t0: Optional[float] = None) -> int:
    import argparse

    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    manifest = mf.load()
    wl = mf.workload(manifest, args.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the card only")
        return 4
    if torch.cuda.device_count() < wl["chips"]:
        log(f"{wl['name']} needs {wl['chips']} cards, "
            f"{torch.cuda.device_count()} visible")
        return 4
    if not (mf.ROOT / "src" / "repro_torch").is_dir():
        log("the program (src/repro_torch) is not in this checkout")
        return 4
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(wl, mf.config(wl["config"]), mf.mix(wl["traffic"]),
                      args.seed, args.seconds, bool(args.trace), device,
                      manifest, t0, log)
    phases = result.pop("phases")
    found = forbidden_modules()
    if found:
        log(f"the run loaded {found}: the benchmark runs the port alone")
        return 5
    out = mf.ROOT / ".portbench" / "runs"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{wl['name']}.{args.seed}.trace{args.trace}.json").write_text(
        json.dumps({"result": result, "phases": phases}, indent=1))
    for k, v in phases.items():
        log(f"phase {k} {v!r}")
    for k, c in result["checks"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0
