#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results/chip_smoke.json]

1. Prints the card's name and power limit, then builds the hand-written
   CUDA kernel ``src/repro_torch/csrc/hydro_rhs.cu`` with nvcc for sm_90a.
2. Holds the kernel against its plain PyTorch version on the card, with
   atol scaled per slot and field: on the main path's own input (the Sedov
   IC's 512 padded sub-grids, (512, 5, 14, 14, 14) fp32) with a scalar
   width and with per-slot widths, on smooth random states, and on a cold
   flow that holds every pressure on its floor.  Times the kernel on the
   main path's input against its plain version and its bound.
3. Drives the main path — uniform Sedov ``CONFIG`` (512 sub-grids of 8^3)
   stepped by TVD-RK3 through ``StrategyRunner`` — under ``fused``, ``s3``
   (caps 32 and 512) and ``s2+s3`` (4 streams, cap 32), counting the
   kernel's launches in each run; every strategy must equal ``fused`` bit
   for bit and agree with the plain PyTorch path on the card.
4. Prints one JSON line of kernels, the card line, and as its last line
   ``{"ok": true, "device": {...}}``.

Any failed check raises, so the run exits non-zero and prints no result;
so does a host without a CUDA device, or a directory without the repo.
"""
import argparse
import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet: HBM3 bandwidth and fp32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# the reference's kernel tolerance (tests/test_kernels.py)
RTOL, ATOL_SCALE = 2e-5, 2e-6
STEPS = 3            # RK3 steps of the main path per strategy


class CheckFailed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sync():
    torch.cuda.synchronize()


def time_cuda_ms(fn, reps, warm=2):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events around the run, after ``warm`` untimed calls)."""
    for _ in range(warm):
        fn()
    sync()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


FIELDS = ("rho", "Sx", "Sy", "Sz", "E")


def slot_field_max(x):
    """max |x| over each slot and field: (n, F, ...) -> (n, F)."""
    return x.abs().flatten(2).amax(2)


def compare(label, got, want, scale, atol_scale, rtol):
    """Hold ``got`` to ``want`` elementwise, |got - want| <= atol + rtol *
    |want|, with atol = atol_scale * scale taken per slot and field, so the
    blast slots do not set the tolerance of the ambient ones.  Prints the
    errors and, per field, the atol used beside the median |want|; raises
    if any element is outside.  Returns (max abs err, max rel err)."""
    diff = (got - want).abs()
    atol = atol_scale * scale[:, :, None, None, None]
    rel = float(torch.where(diff > 0, diff / torch.maximum(want.abs(), atol),
                            torch.zeros_like(diff)).max())
    print(f"{label}: max abs err {float(diff.max()):.3e}, max rel err "
          f"{rel:.3e} (atol {atol_scale:g} x max|want| per slot and field, "
          f"rtol {rtol:g})", flush=True)
    for f, name in enumerate(FIELDS):
        a = atol_scale * scale[:, f]
        print(f"  {name}: atol median {float(a.median()):.3e} (max "
              f"{float(a.max()):.3e}); median |want| "
              f"{float(want[:, f].abs().median()):.3e}; max abs err "
              f"{float(diff[:, f].max()):.3e}", flush=True)
    check(bool(torch.isfinite(got).all()), f"{label}: output not finite")
    check(bool((diff <= atol + rtol * want.abs()).all()),
          f"{label}: outside the tolerance")
    return float(diff.max()), rel


def random_slots(n, p, device, seed):
    """Smooth random states, as the reference's kernel tests draw them."""
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.3 * rng.random((n, 1, p, p, p))
    vel = 0.2 * rng.standard_normal((n, 3, p, p, p))
    pr = 1.0 + 0.5 * rng.random((n, 1, p, p, p))
    en = pr / 0.4 + 0.5 * rho * np.sum(vel * vel, axis=1, keepdims=True)
    return torch.from_numpy(np.concatenate([rho, rho * vel, en], axis=1)
                            .astype(np.float32)).to(device)


def cold_flow_slots(n, p, device, seed):
    """Pressureless flow: density 1 + 0.3U, velocity 0.2N and zero total
    energy, so every state the kernel reconstructs sits on the pressure
    floor (P_FLOOR) and its sound speed comes from the floor alone."""
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.3 * rng.random((n, 1, p, p, p))
    vel = 0.2 * rng.standard_normal((n, 3, p, p, p))
    return torch.from_numpy(np.concatenate(
        [rho, rho * vel, np.zeros_like(rho)], axis=1).astype(np.float32)
    ).to(device)


def hydro_rhs_ops(n, subgrid, ghost=3):
    """fp32 operations the function needs for n slots: the reference's
    branch-free formulas with every distinct value computed once (add,
    sub, mul, div, sqrt, min, max, compare each one; selects and index
    arithmetic not counted).  Per field:

    * each PPM interface value once, shared by the two cells beside it: 5;
    * each (pair, cell) the consumed faces read: extremum test 4, du 1,
      u6 4, du*du and du*u6 2; then each side used, 5 toward +d, 4
      toward -d;

    per reconstructed state, primitives 14 and sound speed 3; per face
    point, signal speeds 8, physical fluxes 14, span and test 2, KNP flux
    39 (the span > 1e-12 branch: the pressure floor keeps the sound speed,
    and so the span, above it for any density below 1e12); per face, 9
    weights and 8 accumulating adds per field; per cell, field and axis,
    3 for the divergence.
    """
    from repro_torch.hydro.flux import FACE_QUAD
    from repro_torch.hydro.ppm import DIR_PAIRS

    states, face_points = set(), 0
    for a in range(3):
        span = [range(ghost - 1, ghost + subgrid) if d == a
                else range(ghost, ghost + subgrid) for d in range(3)]
        for (_, pl, sl, pr, sr) in FACE_QUAD[a]:
            for c in itertools.product(*span):
                right = tuple(c[d] + (d == a) for d in range(3))
                states.add((pl, sl, c))
                states.add((pr, sr, right))
            face_points += (subgrid + 1) * subgrid * subgrid
    recon = {(pair, c) for (pair, _, c) in states}
    faces = set()
    for pair, c in recon:
        d = DIR_PAIRS[pair]
        faces.add((pair, c))
        faces.add((pair, tuple(c[k] - d[k] for k in range(3))))
    plus = sum(1 for (_, side, _) in states if side)
    per_field = (5 * len(faces) + 11 * len(recon) + 5 * plus
                 + 4 * (len(states) - plus))
    per_slot = (5 * per_field + 17 * len(states) + 63 * face_points
                + 85 * 3 * (subgrid + 1) * subgrid * subgrid
                + 3 * 3 * 5 * subgrid ** 3)
    return n * per_slot


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernel(cfg, dev, results):
    from repro_torch.hydro.state import extract_subgrids, sedov_init
    from repro_torch.kernels import hydro_rhs as kern

    kw = dict(gamma=cfg.gamma, ghost=cfg.ghost, subgrid=cfg.subgrid)
    h = cfg.domain / (cfg.grids_per_edge * cfg.subgrid)
    tol = dict(atol_scale=ATOL_SCALE, rtol=RTOL)
    # the main path's own first input: the Sedov IC's padded sub-grids
    u = extract_subgrids(sedov_init(cfg, device=dev).u, cfg.subgrid,
                         cfg.ghost)
    n = u.shape[0]
    got = kern.hydro_rhs_cuda(u, h=h, **kw)
    want = kern.hydro_rhs_plain(u, h=h, **kw)
    errs = [compare(f"kernel vs plain, Sedov IC sub-grids {tuple(u.shape)}",
                    got, want, slot_field_max(want), **tol)]

    # per-slot widths (the traced-h twin): alternate 2h and h
    hs = torch.where(torch.arange(n, device=dev) % 2 == 0,
                     torch.tensor(2 * h, device=dev),
                     torch.tensor(h, device=dev)).float().contiguous()
    got_h = kern.hydro_rhs_cuda(u, h_slots=hs, **kw)
    want_h = kern.hydro_rhs_plain(u, h_slots=hs, **kw)
    errs.append(compare("kernel vs plain, h_slots (2h, h alternating)",
                        got_h, want_h, slot_field_max(want_h), **tol))
    check(torch.equal(got_h[1::2], got[1::2]),
          "h_slots slots of width h differ from the scalar-h launch")
    # a slot's result does not depend on the bucket it was launched in
    check(torch.equal(kern.hydro_rhs_cuda(u[32:64], h=h, **kw), got[32:64]),
          "a 32-slot launch differs from the same slots in a 512 launch")

    ur = random_slots(64, cfg.padded, dev, seed=1)
    want_r = kern.hydro_rhs_plain(ur, h=0.01, **kw)
    errs.append(compare("kernel vs plain, random smooth states (64 slots)",
                        kern.hydro_rhs_cuda(ur, h=0.01, **kw), want_r,
                        slot_field_max(want_r), **tol))
    # the floor branch: every reconstructed pressure on P_FLOOR
    uc = cold_flow_slots(n, cfg.padded, dev, seed=2)
    want_c = kern.hydro_rhs_plain(uc, h=h, **kw)
    errs.append(compare(f"kernel vs plain, cold flow on the pressure floor "
                        f"({n} slots)", kern.hydro_rhs_cuda(uc, h=h, **kw),
                        want_c, slot_field_max(want_c), **tol))

    ms = time_cuda_ms(lambda: kern.hydro_rhs_cuda(u, h=h, **kw), reps=50)
    ms_32 = time_cuda_ms(lambda: kern.hydro_rhs_cuda(u[:32], h=h, **kw),
                         reps=50)
    plain_ms = time_cuda_ms(lambda: kern.hydro_rhs_plain(u, h=h, **kw),
                            reps=3, warm=1)
    ms_h = time_cuda_ms(lambda: kern.hydro_rhs_cuda(u, h_slots=hs, **kw),
                        reps=50)
    ms_cold = time_cuda_ms(lambda: kern.hydro_rhs_cuda(uc, h=h, **kw),
                           reps=50)
    n_bytes = (u.numel() + got.numel()) * 4
    n_ops = hydro_rhs_ops(n, cfg.subgrid, cfg.ghost)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    print(f"kernel time on the Sedov IC, {n} slots: {ms:.4f} ms; plain "
          f"version {plain_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by}: "
          f"{n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.3f} GFLOP), so the "
          f"kernel takes {ms / b_ms:.1f}x its bound; 32 slots {ms_32:.4f} "
          f"ms; h_slots mode {ms_h:.4f} ms; cold flow {ms_cold:.4f} ms",
          flush=True)
    results["kernel"] = dict(
        name="hydro_rhs", route="cuda",
        source="src/repro_torch/csrc/hydro_rhs.cu",
        replaces="src/repro/kernels/hydro_rhs.py:140",
        max_abs_err=max(e[0] for e in errs), ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    results["kernel_detail"] = dict(
        slots=n, input="Sedov IC sub-grids", ms_32_slots=ms_32,
        ms_h_slots=ms_h, ms_cold_flow=ms_cold, bytes=n_bytes, flop=n_ops,
        bound_over_ms=b_ms / ms, max_rel_err=max(e[1] for e in errs),
        achieved_tflops=n_ops / (ms * 1e-3) / 1e12)


def blocks(u, cfg):
    """A global state (F, N, N, N) as its sub-grids, (n, F, S, S, S)."""
    g, s = cfg.grids_per_edge, cfg.subgrid
    return (u.reshape(u.shape[0], g, s, g, s, g, s)
            .permute(1, 3, 5, 0, 2, 4, 6).reshape(g ** 3, u.shape[0], s, s, s))


def block_scale(ub):
    """max |u| per sub-grid and field, with each momentum at least
    sqrt(2 max rho max E), the momentum the sub-grid's energy could carry:
    a sub-grid the blast has barely reached is held to that scale, not to
    the rounding noise of its momentum."""
    m = slot_field_max(ub)
    carry = torch.sqrt(2.0 * m[:, 0] * m[:, 4])[:, None]
    return torch.cat([m[:, :1], torch.maximum(m[:, 1:4], carry), m[:, 4:]],
                     dim=1)


def phase_main_path(cfg, dev, steps, results):
    from repro_torch.configs.base import AggregationConfig
    from repro_torch.core import StrategyRunner, UniformSedovScenario
    from repro_torch.core.aggregation import greedy_decomposition
    from repro_torch.hydro.state import sedov_init
    from repro_torch.hydro.stepper import courant_dt, total_conserved
    from repro_torch.kernels import hydro_rhs as kern
    from repro_torch.kernels.hydro_rhs import hydro_rhs_plain

    u0 = sedov_init(cfg, device=dev).u
    h = cfg.domain / u0.shape[-1]

    # the plain PyTorch path on the card: the reference the kernel path is
    # held to, and the source of the dts every strategy then reuses
    def plain_body(x):
        return hydro_rhs_plain(x, h=h, gamma=cfg.gamma, ghost=cfg.ghost,
                               subgrid=cfg.subgrid)

    plain = StrategyRunner(UniformSedovScenario(cfg, batched_body=plain_body),
                           AggregationConfig(strategy="fused"), device=dev)
    u_ref, dts = u0, []
    for _ in range(steps):
        dts.append(courant_dt(u_ref, cfg))
        u_ref = plain.rk3_step(u_ref, dts[-1])
    sync()

    runs = [("fused", AggregationConfig(strategy="fused")),
            ("s3 cap 32", AggregationConfig(strategy="s3",
                                            max_aggregated=32)),
            ("s3 cap 512", AggregationConfig(strategy="s3",
                                             max_aggregated=512)),
            ("s2+s3 4 streams cap 32", AggregationConfig(
                strategy="s2+s3", n_executors=4, max_aggregated=32))]
    outs, rows = {}, {}
    for label, agg in runs:
        runner = StrategyRunner(UniformSedovScenario(cfg), agg, device=dev)
        runner.warmup()
        runner.rk3_step(u0, dts[0])                # one untimed step
        per_stage = (1 if agg.strategy == "fused" else len(
            greedy_decomposition(cfg.n_subgrids, agg.bucket_sizes())))
        before = runner.stats["kernel_launches"]
        sync()
        kern.hydro_rhs_cuda.launches = 0           # the main path's count
        t0 = time.perf_counter()
        u = u0
        for dt in dts:
            u = runner.rk3_step(u, dt)
        sync()
        wall = time.perf_counter() - t0
        launches = kern.hydro_rhs_cuda.launches
        path_launches = runner.stats["kernel_launches"] - before
        print(f"main path {label}: {wall / steps * 1e3:.3f} ms/step, "
              f"{path_launches / steps:g} launches/step, hydro_rhs kernel "
              f"launches {launches} over {steps} steps", flush=True)
        check(launches > 0, f"{label}: the kernel was never launched")
        check(launches == path_launches == 3 * steps * per_stage,
              f"{label}: kernel launches {launches}, runner {path_launches},"
              f" greedy decomposition {3 * steps * per_stage}")
        outs[label] = u
        rows[label] = dict(ms_per_step=wall / steps * 1e3,
                           launches_per_step=path_launches / steps,
                           kernel_launches=launches)

    fused = outs["fused"]
    for label, u in outs.items():
        check(torch.equal(u, fused), f"{label} is not bit-identical to fused")
    check(not bool(torch.isnan(fused).any()), "the solution went NaN")
    # the kernel path against the plain path, sub-grid by sub-grid: the
    # per-stage kernel tolerance compounded over 3 stages per step
    ref = blocks(u_ref, cfg)
    diff, _ = compare(f"kernel path vs plain path after {steps} steps, per "
                      f"sub-grid", blocks(fused, cfg), ref, block_scale(ref),
                      atol_scale=1e-6, rtol=1e-5)
    c0, c1 = total_conserved(u0, h), total_conserved(fused, h)
    mass = abs(float((c1[0] - c0[0]) / c0[0]))
    energy = abs(float((c1[4] - c0[4]) / c0[4]))
    print(f"conservation after {steps} steps: mass drift {mass:.2e}, "
          f"energy drift {energy:.2e}", flush=True)
    check(mass < 1e-5 and energy < 1e-5, "conservation drift too large")
    results["main_path"] = dict(steps=steps, runs=rows,
                                plain_path_max_abs_diff=diff,
                                mass_drift=mass, energy_drift=energy)
    results["kernel"]["launches"] = rows["s3 cap 32"]["kernel_launches"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.configs.sedov import CONFIG
    from repro_torch.kernels import _build
    from repro_torch.kernels import hydro_rhs as kern

    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)})",
          flush=True)
    t0 = time.perf_counter()
    kern.build()
    info = _build.BUILD_LOG["hydro_rhs"]
    built = (f"built in {info['seconds']:.1f} s" if info["seconds"]
             is not None else "cached build")
    print(f"build: csrc/hydro_rhs.cu, nvcc sm_90a, {built}, loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    results = {"card": card, "device": torch.cuda.get_device_name(0),
               "torch": torch.__version__, "cuda": torch.version.cuda}
    phase_kernel(CONFIG, dev, results)
    phase_main_path(CONFIG, dev, STEPS, results)

    k = results["kernel"]
    print(f"kernels: hydro_rhs (cuda, {k['source']}, replaces "
          f"{k['replaces']} and its h_slots twin :146)", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: k[key] for key in keys}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
