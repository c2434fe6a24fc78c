#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results/chip_smoke.json]

1. Prints the card's name and power limit, then builds the hand-written
   CUDA kernels ``src/repro_torch/csrc/{hydro_rhs,gravity,hydro_split,
   hydro_rhs_lane,decode_attention,grouped_gemm,extract}.cu`` with nvcc
   for sm_90a, all seven at once.
2. Holds the fused hydro kernel (one thread-block cluster per slot)
   against its plain PyTorch version on the card, with atol scaled per slot
   and field: on the main path's own input (the Sedov IC's 512 padded
   sub-grids, (512, 5, 14, 14, 14) fp32) with a scalar width and with
   per-slot widths, on smooth random states, and on a cold flow that holds
   every pressure on its floor; checks that every slot equals its result
   from buckets of 1, 3 and 32.  Times the kernel on the main path's input
   against its plain version and its bound, and at the bucket ladder's
   sizes 1, 8, 32, 128 and 512 (CUDA-graph replays and back to back),
   with the cluster size, CTAs per launch and resident CTAs per SM.  Holds
   it at odd sub-grids (5^3 and 7^3, whose slots start off 16-byte
   boundaries in turn) and on a tensor one float past a 16-byte boundary
   against its plain version, its buckets and the lane kernel (bit for
   bit).  At 16^3 (``CONFIG_16``'s 64 slots of the Sedov IC and 64 random
   slots, two x-slabs per slot, a cluster of 6 CTAs) with a scalar width
   and per-slot widths: within tolerance of its plain version, every slot
   equal to its buckets of 1, 3 and 32 and to the lane kernel bit for bit;
   15^3 at each float offset of a 16-byte unit; 64, 32 and 1 slots timed
   by graph replay beside the lane kernel, the plain version and the
   bound, with resident CTAs per SM.
3. Drives the main path — uniform Sedov ``CONFIG`` (512 sub-grids of 8^3)
   stepped by TVD-RK3 through ``StrategyRunner`` — under ``fused``, ``s3``
   (caps 32 and 512) and ``s2+s3`` (4 streams, cap 32), counting the
   kernel's launches in each run, and the extraction kernel's (one a
   stage) and the parents copied into static ones (none: each stage's
   population is written in place); every strategy must equal ``fused``
   bit for bit and agree with the plain PyTorch path on the card.  Then
   the sub-grid extraction kernel against its plain version, bit for bit,
   at the benchmark cells' shapes (4,096 and 32,768 slots of 14^3, both
   levels of the two-level c16 exchange) and where each thread stores its
   own elements (15^3, 5^3 interiors), each timed against its plain
   version and its bound; the c16 scenario under ``s3`` cap 512 launches
   it 6 times a step and copies no parent.
4. Holds the gravity kernel and the split pair (Reconstruct, Flux) against
   their plain versions at 512 slots of the Sedov IC and on random slots,
   and times each against its plain version and its bound, 512 slots back
   to back (gravity, shorter than its wrapper's host time, by CUDA-graph
   replays, the back-to-back time beside it) and 32 by replays.  The
   gravity kernel must equal its plain version bit for bit at 8^3 (widths
   h and 2h, h), 5^3 and 16^3 (each also timed by graph replay), and
   Reconstruct be within tolerance at 5^3 (odd P) and on an input and an
   output 4 B past a 16-byte boundary;
   every slot of both equals its result from other buckets (gravity 1, 3,
   32; Reconstruct 1, 33, 512).
5. Path A: the self-gravitating Sedov blast at the paper's grid
   (``GravityHydroConfig(hydro=CONFIG)``, 512 sub-grids), hydro (``h_slots``
   mode) and gravity as two families through one executor, under the same
   four strategy rows, and the repo's ``configs/gravity.CONFIG`` (64
   sub-grids) under ``s3``; per-family launches must equal the greedy
   decomposition, every row equal ``fused`` bit for bit and agree with the
   plain bodies on the card.
6. Path B: uniform Sedov ``CONFIG`` with the split pair as the batched body,
   under ``fused`` and ``s3`` (caps 32 and 512), bit-identical across rows
   and in agreement with the fused-kernel path.
7. Holds the lane kernel (the slot_lane layout, tasks across each warp)
   against its plain version at 512 x 8^3 (scalar and per-slot widths) and
   64 x 16^3, against the slot_grid kernel at 8^3, and checks that every
   slot equals its result from buckets of 1, 3 and 32 slots; checks that
   it equals the slot_grid kernel in every element; times it beside the
   two transposes and its bound, its 32-task launches by CUDA-graph
   replays, with its tile plan and resident CTAs.
8. Path C: the two-level AMR blast, ``AMRSedovScenario`` at 1,024 tasks
   per iteration (a 64^3 coarse level and a 64^3 fine patch, 512 sub-grids
   of 8^3 each, one family) on each layout under the four strategy rows,
   and the repo's ``configs/amr_sedov`` ``CONFIG`` and ``CONFIG_MIXED``
   (two families, a 16^3 and an 8^3 one, also under ``s2+s3``), each on
   both layouts: every row bit-identical to ``fused`` on both levels,
   launches equal to the greedy decomposition, each level in agreement
   with the plain bodies, the layouts with each other, and physical.
9. Path D: uniform Sedov on the lane kernel at ``CONFIG`` and ``CONFIG_16``
   (64 sub-grids of 16^3) under ``fused``, ``s3`` cap 32 and ``s2+s3``:
   bit-identical rows, conservation, agreement with the slot_grid main
   path (``CONFIG``) or the plain path (``CONFIG_16``); and ``CONFIG_16``
   on the slot_grid kernel (the paper's strategy 1) under the same rows,
   equal to the lane kernel's path in every element.
10. Staging: the Sedov IC's 512 padded sub-grids submitted one at a time
   as concrete tensors, 3 waves in a row, through the slot ring on 4
   streams at cap 32 (watermark 1 and 10^9), each executor stream's
   launches delayed by ``torch.cuda._sleep``: every slot equal to the fused
   body bit for bit, the ring's counters printed; ``hydro_rhs_prefix`` at
   offsets 0, 1 and 31 of a ring equal to the kernel bit for bit; the main
   path under host staging (s3 cap 32) bit-identical to ``fused``.
   ``s2`` with 4 streams on the main path (3 steps) and Paths A, B, C
   (slot_lane, 1,024 tasks) and D (1 step each): bit-identical to
   ``fused``, 3 x tasks launches per step in every family.  The
   epilogue-fused stages (``fuse_epilogue``) on the main path, Path A and
   Path C under ``fused``, ``s3`` cap 32 and ``s2+s3`` 4 x 32: the
   aggregated rows bit-identical to the fused stage reference, all within
   rtol 1e-5, atol 1e-5 x max|u| of the generic combine, each ``+epi``
   family launching the greedy decomposition; ``s2`` declines
   ``fuse_epilogue``.  Each row prints host ms per step and launches per
   step beside the card's name and power limit.  Measured tuning and
   routing: the main path under ``s3`` cap 32, then autotuned with the cost
   model under the ``cost`` flush policy with ``inner_chunk="auto"`` and
   under ``watermark``, then ``s3`` cap 32 again; ``s2`` at its measured
   width; ``mixed`` on Path A (``{hydro_rhs: s3, gravity: fused}`` and
   measured) and on Path C ``CONFIG_MIXED`` (slot_grid, measured): every
   row bit-identical to ``fused``, the autotuned rows launching the greedy
   decomposition of their derived ladder; each prints its ladder, cost
   table, routes, flush decisions, launches, host ms and device busy per
   step.  The compiled bucket programs (``bucket_graphs``): the main path
   under ``s3`` caps 32 and 512, ``s2+s3`` (4 streams, cap 32), host
   staging and the fused stages, ``s3`` on Paths A-D, Path C on both
   layouts and ``CONFIG_16``, and 4 tenants under ``s4``, each run with
   the programs as CUDA graphs and again with them eager
   (``eager_programs``): both bit-identical to ``fused``, no eager launch
   outside a capture in the graph run's timed steps, the replays' kernel
   nodes equal to the eager run's launches; prints the captures, the
   graphs' memory, the device-to-device copies, host, enqueue and busy ms
   per step of both, and the device time of a population's write into
   its static parent and of a bucket's output copy.
11. The whole trajectory as one CUDA graph: ``rk3_trajectory`` under
   ``fused``, 3 steps, on the main path, Path A (512 x 8^3 and
   ``configs/gravity.CONFIG``), Path B, Path C (``amr_sedov_1024``, both
   layouts) and Path D (512 x 8^3, 64 x 16^3): bit-equal to three
   ``rk3_step`` calls at two dts with one capture, the caller's state
   kept, an eager step after the capture equal to a fresh runner's, and
   one replay's kernel launches, counted from the captured graph's own
   kernel nodes (``CapturedCall.kernel_names``), equal to 3 x steps x the
   path's launches per stage; prints host ms/step against the step loop,
   device busy and device ops per step (``torch.profiler``, whose count of
   a replay's kernels is printed as a note where it differs from the
   graph's) and peak memory.  Crash-consistent resume: a
   child process runs the main path under ``s3`` cap 32 with a checkpoint
   after each of 4 steps and dies by SIGKILL after checkpoint 2; the
   resumed run equals an uninterrupted one bit for bit; so does Path C's
   ``(uc, uf)`` under ``s2+s3``, resumed in process.  The captured AMR
   exchange: Path C under ``s3``, ``s2+s3``, ``s2``, host staging and the
   fused stages, each executor stream's launches delayed, bit-equal to
   the eager exchange; prints the ops of one exchange and host ms/step,
   captured and eager.
12. Containment: (1) the main path under ``s3`` cap 32 and ``s2+s3`` (4
   streams, cap 32) with ``guard="finite"`` and ``launch_timeout_s=1.0``
   bit-equal to fused, host ms and device busy per step with both off,
   on, on, off; (2) a payload NaN on task 17 of the main path's hydro wave:
   only 17 fails, 2 log2(32) = 10 bisection launches through the slot_grid
   kernel at buckets 16, 8, 4, 2, 1, survivors bit-equal, the runner's
   error naming the task; (3) per-task ring staging on 4 delayed streams,
   3 waves of 512 before one flush with a ring poison in wave 0 and a
   payload poison in wave 2, and a compaction between guarded launches and
   their audit: exactly the poisoned tasks fail, survivors bit-equal;
   (4) a compile fault at bucket 32 and a transient launch fault: the
   degraded counters, bit-equal; (5) a real stall (``torch.cuda._sleep``
   of ~10 budgets before the kernel) under ``launch_timeout_s=0.02``:
   ``LaunchTimeoutError`` naming the family within a few budgets, then a
   clean wave bit-equal to fused; (6) Path A under ``mixed``: gravity's
   breaker opens on payload faults, gravity runs under ``s3`` (bucket 1)
   until a clean half-open probe closes it, then returns to ``fused``;
   (7) ``fused`` and ``s2`` raise ``NonFiniteStateError`` on a NaN state;
   (8) qwen2-moe-a2.7b at published widths and 4 layers, 8 requests: a
   poisoned request evicted and its slot reused, the others' tokens equal
   a fault-free run, ``healthz`` reporting a shared executor's breakers.
13. Warm start: this process tunes the main path under ``s3`` cap 32 with
   the cost model and autotune into a tune store (the retune writes it
   back); a fresh child process warms up from it: tuned by the store, 0
   measurement launches, the saved ladder and cost table, no library
   built, 3 steps bit-identical to ``fused``; a fresh process under
   ``prior="roofline"`` seeds its ladder before any measurement launch,
   steps bit-identical to ``fused``, its ladder's predicted wave time
   within 1.5x of the tuned ladder's, every cost source measured after
   the retune; ``run(checkpoint_every=1)`` writes the store at the first
   checkpoint.  Prints the warmup host seconds, cold and warm, and the
   prior's micro-benchmark of the card.
14. Tenancy: 1, 2, 4, 8 and 16 tenants of ``CONFIG`` through a
   ``TenantBatcher`` under ``s4`` caps 32 and 512, 3 steps: every tenant
   bit-identical to its solo ``s3`` run, 3 merged waves per step, the
   captured extract and assemble phases live (no eager fallback); prints
   launches, host ms per step per tenant against 1 tenant, device busy,
   the graphs' copies and the peak memory.  Two AMR tenants
   (``configs/amr_sedov``), staged and eager, bit-identical to the solo
   run.  Then ``distributed``: ``CONFIG`` under ``s4`` cap 32 on a mesh
   of 4 shards (over ``min(4, cards)`` cards when two or more are
   visible, else 4 shards on the one card, each on its own stream; a line
   says which), 3 steps bit-identical to ``fused``, the hydro_rhs
   launches counted from the replayed graphs' kernel nodes equal to the
   greedy decomposition per shard, occupancy, the copies, host and busy
   ms per step beside ``s3`` cap 32; 4 tenants on the mesh, each equal to
   its solo step, every shard equally filled; ``halo_exchange`` (a one-
   block roll) and ``ghost_gather``; a one-rank NCCL group (a
   ``FileStore``): reduced granite-8b, 3 steps of ``make_dp_train_step``
   (``compress=False``) bit-identical to ``make_train_step`` under
   ``launch.train.deterministic``, then one bf16 ``compress=True`` step of
   h2o-danube-1.8b at published widths and depth, seq 4,096, at the first
   batch of 4, 2, 1 that fits (ms, peak, loss at init against ln V);
   ``resilient_loop`` around the training loop's step and checkpoints with
   a ``SimulatedFailure`` after step 2's update: restored and replayed,
   bit-identical to a straight run; ``restore_resharded`` of its last
   checkpoint onto the card equal to the run's weights.
15. Holds the serving kernels (``csrc/decode_attention.cu``,
   ``csrc/grouped_gemm.cu``) against their plain versions at the full-width
   qwen2-moe-a2.7b shapes in bf16 (8 requests, a 1,024-position cache with
   ragged lengths 1 to 1,024; 60 experts of (2048, 1408) and (1408, 2048)
   routed by a full-width router), in fp32 and at granite-8b's GQA shape;
   checks that each request and each expert row is independent of the rest
   of its launch bit for bit, that NaN past cache_len is never read and
   that rows past group_len are exactly 0; times each against its plain
   version, one PyTorch call and its bound, decode attention by CUDA-graph
   replays with L2 cold (as the serving path finds a layer's cache) and
   warm, beside SDPA at B 1, 2, 4 and 8 in the same call.  Then the same
   checks and times at the shapes the families of item 17 give the two
   kernels (``FAMILY_DA_ROWS``: h2o-danube's D 80, seamless's MHA at D 64,
   starcoder2's group of 12, dbrx's group of 6, llama-vision's cross
   attention over 6,404 positions at full length, zamba2's shared block
   at MHA 32/32, D 80; dbrx's (16, C, 6144) @ (16, 6144, 10752) and (16,
   C, 10752) @ (16, 10752, 6144) expert GEMMs).
16. The serving path: qwen2-moe-a2.7b at full width and depth in bf16
   (14.3 B weights from a seeded generator on the card) behind
   ``ServingEngine(max_batch=8, max_len=1024)`` on 12 requests (prompts of
   8-96 tokens and one of 640, 8-24 new tokens each): every request done,
   the kernels launched 24x and 72x per engine launch, buckets 1-8 used;
   each emitted token replayed alone is the replay's argmax unless its
   top-2 margin is below ``LOGIT_TOL`` x max|logit|.  Three of the replays
   run again through ``decode_step``'s kernels hook: with every kernel
   launch held to its plain version on the same inputs; with the plain
   versions alone (the bf16 divergence is printed: a rounding difference
   that flips a top-4 routing choice moves the rest of a replay); and in
   fp32 at full width and ``F32_LAYERS`` layers, where the plain versions'
   logits must stay within ``F32_LOGIT_TOL`` of the kernels'.
   Prints tokens/s, ms per launch by bucket, the cache gather and scatter
   copies' device time and peak memory.
17. The families.  First the recurrent mixers, one layer each at
   published width in fp32 (Mamba2 at zamba2-2.7b's, mLSTM and sLSTM at
   xlstm-125m's): the chunked forward over 512 tokens (2 chunks of 256)
   against 512 decode steps, within the reference's decode-equals-forward
   tolerance (atol 2e-4, rtol 2e-3).  Then h2o-danube-1.8b,
   starcoder2-15b, seamless-m4t-large-v2, xlstm-125m, zamba2-2.7b
   (published depths), qwen1.5-32b (32 of 64 layers), dbrx-132b (4 of 40)
   and llama-3.2-vision-90b (10 of 100, the full 6,404 stub vision tokens)
   at published widths in bf16, one after the other, each freed before the
   next (``FAMILY_DEPTHS`` says why each cut), behind
   ``ServingEngine(max_batch=8, max_len=256)`` on 6 requests (prompts of
   4-32 tokens, 8 new tokens each): every request done, decode_attention
   launched once per attention read of each engine launch (two per
   seamless decoder layer, one per application of zamba2's shared block,
   none for xlstm) and grouped_gemm 3x per dbrx layer; each emitted token
   its solo replay's argmax within ``LOGIT_TOL``; one replay with every
   kernel launch held to its plain version; fp32 at ``F32_LAYERS`` layers
   (one whole group for vlm, ssm and hybrid) with the plain versions'
   logits within ``F32_LOGIT_TOL`` of the kernels'.  Prints tokens/s, host
   ms per launch by bucket, device busy and idle share per launch at
   buckets 1 and 8 from ``torch.profiler``, the cache gather per launch
   and peak memory.
18. Training (``repro_torch.launch``; no kernel on its path, and no
   wrapper counts a launch): every architecture reduced, fp32, TF32 off:
   one step on the card against the same step on the CPU (loss and
   gradient norm within rtol 1e-4), then 30 steps of ``launch.train`` (seq 64,
   batch 8, lr 3e-3, warmup 5, 50 total steps) whose loss falls, granite-8b
   at 2 layers by the reference's 0.2; one architecture per family resumed
   after a child process is SIGKILLed at checkpoint 3 of 6, equal to the
   straight run in every weight, ``m``, ``v`` and ``step``; one bf16 step
   per architecture at published widths, remat on, seq 4,096, batch 4 in 2
   microbatches, at ``TRAIN_DEPTHS`` (or a printed reason): host and busy
   ms/step, tokens/s, the model-FLOPs share, peak memory, the loss at
   initialisation within rel 0.35 of ln V.
19. Prints one line naming the kernels, one JSON line of kernels, the card
   line, and as its last line ``{"ok": true, "device": {...}}``.

Any failed check raises, so the run exits non-zero and prints no result;
so does a host without a CUDA device (exit 2), or a directory without the
repo's ``src/repro_torch`` beside the script (exit 1).
"""
import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# read when cuBLAS first runs in the process: the training phase's
# resumed runs take torch.use_deterministic_algorithms(True), which needs it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data sheet: HBM3 bandwidth, fp32 rate outside the tensor cores
# and the dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
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


def time_graph_ms(fn, reps, warm=2):
    """Device time of one call of ``fn``: ``reps`` calls captured in one CUDA
    graph, the best of 3 replays (CUDA events around each) over ``reps``.
    Unlike ``time_cuda_ms`` it leaves out the host's dispatch, which paces
    back-to-back calls of a kernel shorter than its Python wrapper.  ``fn``
    may be a list of calls, captured in turn (``l2_cold_calls``)."""
    fns = fn if isinstance(fn, list) else [fn]
    for _ in range(warm):
        for f in fns:
            f()
    sync()
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), torch.cuda.graph(graph, stream=side):
        for i in range(reps):
            fns[i % len(fns)]()
    sync()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    best = None
    for _ in range(3):
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        t = a.elapsed_time(b) / reps
        best = t if best is None else min(best, t)
    del graph
    return best


def l2_cold_calls(make_call, tensors, touched_bytes, cap=64):
    """Calls ``make_call(*copy)`` on enough copies of ``tensors`` (the first
    being ``tensors`` itself, at most ``cap``) that replaying them in turn
    passes at least twice the card's L2 between two calls on one copy, each
    call touching ``touched_bytes``: so each call finds its inputs evicted
    from L2, as the serving path finds a layer's cache when it comes back to
    that layer.  Returns the calls and whether L2 was exceeded."""
    l2 = torch.cuda.get_device_properties(0).L2_cache_size
    n = min(cap, 1 + -(-2 * l2 // max(touched_bytes, 1)))
    copies = [tensors] + [tuple(t.clone() for t in tensors)
                          for _ in range(n - 1)]
    return ([make_call(*c) for c in copies],
            (n - 1) * touched_bytes >= 2 * l2)


FIELDS = ("rho", "Sx", "Sy", "Sz", "E")
GRAVITY_FIELDS = ("phi", "gx", "gy", "gz")


def slot_field_max(x):
    """max |x| over each slot and field: (n, F, ...) -> (n, F)."""
    return x.abs().flatten(2).amax(2)


def compare(label, got, want, scale, atol_scale, rtol, names=FIELDS):
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
    for f, name in enumerate(names):
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


def alternating_widths(n, h, dev):
    """Widths 2h, h, 2h, ... (n,), as two refinement levels in one bucket."""
    return torch.where(torch.arange(n, device=dev) % 2 == 0,
                       torch.tensor(2 * h, device=dev),
                       torch.tensor(h, device=dev)).float().contiguous()


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


def bound_ms(n_bytes, n_ops, flop_per_s=FP32_FLOP_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / flop_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def phase_kernel(cfg, dev, results):
    from repro_torch.hydro.state import extract_subgrids, sedov_init
    from repro_torch.kernels import hydro_rhs as kern
    from repro_torch.kernels.counts import hydro_rhs_ops

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
    hs = alternating_widths(n, h, dev)
    got_h = kern.hydro_rhs_cuda(u, h_slots=hs, **kw)
    want_h = kern.hydro_rhs_plain(u, h_slots=hs, **kw)
    errs.append(compare("kernel vs plain, h_slots (2h, h alternating)",
                        got_h, want_h, slot_field_max(want_h), **tol))
    check(torch.equal(got_h[1::2], got[1::2]),
          "h_slots slots of width h differ from the scalar-h launch")
    # a slot's result does not depend on the bucket it was launched in
    check_grid_buckets("kernel, Sedov IC", u, got, h, **kw)
    check_grid_buckets("kernel, widths 2h, h", u, got_h, hs, **kw)

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

    errs += odd_and_misaligned_slots(cfg, dev)

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
    # the bucket ladder's sizes: device time (graph replays) and
    # back-to-back calls (host dispatch included)
    per_sm, resident = kern.occupancy(dev, cfg.subgrid)
    ladder = {}
    for m in (1, 8, 32, 128, 512):
        x = u[:m]
        ladder[m] = dict(
            ctas=m * kern.CLUSTER,
            graph_ms=time_graph_ms(lambda: kern.hydro_rhs_cuda(x, h=h, **kw),
                                   reps=50),
            events_ms=time_cuda_ms(lambda: kern.hydro_rhs_cuda(x, h=h, **kw),
                                   reps=50))
        print(f"hydro_rhs ladder, {m} slots: {ladder[m]['ctas']} CTAs in "
              f"clusters of {kern.CLUSTER} x {kern.CTA_THREADS} threads; "
              f"{ladder[m]['graph_ms']:.4f} ms (graph replay), "
              f"{ladder[m]['events_ms']:.4f} ms back to back", flush=True)
    print(f"hydro_rhs occupancy: {per_sm} CTAs per SM, {resident} clusters "
          f"resident on the card ({kern.smem_bytes(cfg.subgrid)} B of shared "
          f"memory per CTA)", flush=True)
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
        achieved_tflops=n_ops / (ms * 1e-3) / 1e12, cluster=kern.CLUSTER,
        cta_threads=kern.CTA_THREADS, ctas_per_sm=per_sm,
        resident_clusters=resident, ladder=ladder)


def odd_and_misaligned_slots(cfg, dev):
    """The slot_grid kernel where a slot's bulk copy needs a head and a
    tail: 512 sub-grids of 5^3 and 7^3 (a padded slot of 5 P^3 floats, P
    odd, so the slots start at every float offset of a 16-byte unit in
    turn; the Sedov IC and random states) and the main path's input in a
    tensor one float past a 16-byte boundary.  Each within the tolerance of
    the plain version, each slot equal to its result from buckets of 1, 3
    and 32, and to the lane kernel's, bit for bit.  Returns the errors."""
    from repro_torch.configs.base import HydroConfig
    from repro_torch.hydro.state import extract_subgrids, sedov_init
    from repro_torch.kernels import hydro_rhs as kern

    tol = dict(atol_scale=ATOL_SCALE, rtol=RTOL)
    errs = []
    for s in (5, 7):
        c = HydroConfig(subgrid=s, levels=cfg.levels)
        kw = dict(gamma=c.gamma, ghost=c.ghost, subgrid=s)
        h = c.domain / (c.grids_per_edge * s)
        u = extract_subgrids(sedov_init(c, device=dev).u, s, c.ghost)
        ur = random_slots(u.shape[0], c.padded, dev, seed=6)
        for label, x in (("Sedov IC", u), ("random smooth states", ur)):
            got = kern.hydro_rhs_cuda(x, h=h, **kw)
            want = kern.hydro_rhs_plain(x, h=h, **kw)
            errs.append(compare(f"kernel vs plain at odd S, {label} "
                                f"{tuple(x.shape)}", got, want,
                                slot_field_max(want), **tol))
            check_grid_buckets(f"kernel at {s}^3, {label}", x, got, h, **kw)
            lane = kern.hydro_rhs_lane_cuda(lane_major(x), h=h, **kw)
            check(torch.equal(slot_major(lane), got),
                  f"the lane kernel and the slot_grid kernel differ at "
                  f"{s}^3 ({label})")
        print(f"kernel at {s}^3: equals the lane kernel in every element",
              flush=True)
    kw = dict(gamma=cfg.gamma, ghost=cfg.ghost, subgrid=cfg.subgrid)
    h = cfg.domain / (cfg.grids_per_edge * cfg.subgrid)
    u = extract_subgrids(sedov_init(cfg, device=dev).u, cfg.subgrid,
                         cfg.ghost)
    buf = torch.empty(u.numel() + 1, device=dev)
    off = buf[1:].view(u.shape)
    off.copy_(u)
    check(off.data_ptr() % 16 == 4, "the tensor is not 4 B past 16")
    got = kern.hydro_rhs_cuda(off, h=h, **kw)
    want = kern.hydro_rhs_plain(u, h=h, **kw)
    errs.append(compare(f"kernel vs plain, slots 4 B past a 16-byte "
                        f"boundary {tuple(u.shape)}", got, want,
                        slot_field_max(want), **tol))
    check(torch.equal(got, kern.hydro_rhs_cuda(u, h=h, **kw)),
          "misaligned slots differ from the same slots aligned")
    check_grid_buckets("kernel, slots 4 B past a 16-byte boundary", off,
                       got, h, **kw)
    return errs


def phase_kernel_16(cfg16, dev, results):
    """The slot_grid kernel at 16^3, two x-slabs per slot (a cluster of 6
    CTAs): 64 slots of the Sedov IC (``CONFIG_16``) and 64 random smooth
    slots, each with a scalar width and with per-slot widths, against the
    plain version; every slot equal to its result from buckets of 1, 3 and
    32 and to the lane kernel's, bit for bit; 15^3 (odd, every field's slab
    off a 16-byte boundary in turn) in a tensor at each float offset of a
    16-byte unit, equal to the aligned launch.  Times the 64-, 32- and
    1-slot launches by graph replay beside the lane kernel's replay, the
    plain version and the bound, with the resident CTAs per SM."""
    from repro_torch.configs.base import HydroConfig
    from repro_torch.hydro.state import extract_subgrids, sedov_init
    from repro_torch.kernels import hydro_rhs as kern
    from repro_torch.kernels.counts import hydro_rhs_ops

    s = cfg16.subgrid
    kw = dict(gamma=cfg16.gamma, ghost=cfg16.ghost, subgrid=s)
    h = cfg16.domain / (cfg16.grids_per_edge * s)
    tol = dict(atol_scale=ATOL_SCALE, rtol=RTOL)
    plan = kern.slab_plan(s)
    u = extract_subgrids(sedov_init(cfg16, device=dev).u, s, cfg16.ghost)
    n = u.shape[0]
    errs = []
    for label, x in (("Sedov IC", u),
                     ("random smooth states",
                      random_slots(n, cfg16.padded, dev, seed=7))):
        hs = alternating_widths(n, h, dev)
        for wlabel, widths in (("h", h), ("2h, h", hs)):
            wk = (dict(h_slots=widths) if isinstance(widths, torch.Tensor)
                  else dict(h=widths))
            got = kern.hydro_rhs_cuda(x, **wk, **kw)
            want = kern.hydro_rhs_plain(x, **wk, **kw)
            errs.append(compare(f"kernel vs plain at {s}^3, {label}, widths "
                                f"{wlabel} {tuple(x.shape)}", got, want,
                                slot_field_max(want), **tol))
            check_grid_buckets(f"kernel at {s}^3, {label}, widths {wlabel}",
                               x, got, widths, **kw)
            lane = kern.hydro_rhs_lane_cuda(lane_major(x), **wk, **kw)
            check(torch.equal(slot_major(lane), got),
                  f"the lane kernel and the slot_grid kernel differ at "
                  f"{s}^3 ({label}, widths {wlabel})")
    print(f"kernel at {s}^3: equals the lane kernel in every element "
          f"(Sedov IC and random states, widths h and 2h/h)", flush=True)
    c15 = HydroConfig(subgrid=15, levels=cfg16.levels)
    kw15 = dict(kw, subgrid=15)
    h15 = c15.domain / (c15.grids_per_edge * 15)
    u15 = extract_subgrids(sedov_init(c15, device=dev).u, 15, c15.ghost)
    got15 = kern.hydro_rhs_cuda(u15, h=h15, **kw15)
    want15 = kern.hydro_rhs_plain(u15, h=h15, **kw15)
    errs.append(compare(f"kernel vs plain at 15^3 {tuple(u15.shape)}",
                        got15, want15, slot_field_max(want15), **tol))
    check(torch.equal(slot_major(kern.hydro_rhs_lane_cuda(
        lane_major(u15), h=h15, **kw15)), got15),
          "the lane kernel and the slot_grid kernel differ at 15^3")
    buf = torch.empty(u15.numel() + 4, device=dev)
    for off in range(4):
        x = buf[off:off + u15.numel()].view(u15.shape)
        x.copy_(u15)
        check(x.data_ptr() % 16 == 4 * off, "offset tensor misplaced")
        check(torch.equal(kern.hydro_rhs_cuda(x, h=h15, **kw15), got15),
              f"15^3 slots {4 * off} B past a 16-byte boundary differ from "
              f"the aligned launch")
    print("kernel at 15^3: within tolerance of the plain version, equal to "
          "the lane kernel and to itself at every float offset of a "
          "16-byte unit", flush=True)

    got = kern.hydro_rhs_cuda(u, h=h, **kw)
    ut = lane_major(u)
    times = {m: time_graph_ms(lambda x=u[:m]: kern.hydro_rhs_cuda(
        x, h=h, **kw), reps=20) for m in (n, 32, 1)}
    lane_ms = time_graph_ms(lambda: kern.hydro_rhs_lane_cuda(ut, h=h, **kw),
                            reps=20)
    plain_ms = time_cuda_ms(lambda: kern.hydro_rhs_plain(u, h=h, **kw),
                            reps=2, warm=1)
    n_bytes = (u.numel() + got.numel()) * 4
    n_ops = hydro_rhs_ops(n, s, cfg16.ghost)
    b_ms, b_by = bound_ms(n_bytes, n_ops)
    per_sm, resident = kern.occupancy(dev, s)
    ms = times[n]
    print(f"kernel at {s}^3, {n} slots (graph replay): {ms:.4f} ms, 32 slots "
          f"{times[32]:.4f} ms, 1 slot {times[1]:.4f} ms; lane kernel "
          f"{lane_ms:.4f} ms; plain version {plain_ms:.3f} ms; bound "
          f"{b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB, "
          f"{n_ops / 1e9:.3f} GFLOP), so {ms / b_ms:.1f}x its bound; "
          f"{plan.slabs} x-slabs of {plan.width} cells, "
          f"{kern.ctas_per_slot(s)} CTAs per cluster, {plan.smem} B of "
          f"shared memory per CTA, {per_sm} CTAs per SM, {resident} clusters "
          f"resident", flush=True)
    results["kernel_16"] = dict(
        name="hydro_rhs (16^3, 2 x-slabs)", route="cuda",
        source="src/repro_torch/csrc/hydro_rhs.cu",
        replaces="src/repro/kernels/hydro_rhs.py:140",
        max_abs_err=max(e[0] for e in errs), ms=ms, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    results["kernel_16_detail"] = dict(
        slots=n, ms_32_slots=times[32], ms_1_slot=times[1],
        lane_kernel_ms=lane_ms, bytes=n_bytes, flop=n_ops,
        max_rel_err=max(e[1] for e in errs), slabs=plan.slabs,
        slab_width=plan.width, smem=plan.smem,
        cluster=kern.ctas_per_slot(s), ctas_per_sm=per_sm,
        resident_clusters=resident)


def check_slot_buckets(label, n, whole, launch, sizes=(1, 3, 32)):
    """Every slot of an n-slot launch ``whole`` equals that slot from
    launches of each size (ragged tails included), bit for bit; ``launch(a,
    m)`` launches the m slots from a."""
    for size in sizes:
        for a in range(0, n, size):
            b = min(a + size, n)
            check(torch.equal(launch(a, b - a), whole[a:b]),
                  f"{label}: slots [{a}, {b}) launched as a bucket of "
                  f"{b - a} differ from the same slots in a {n}-slot launch")
    print(f"{label}: every slot equals its result from buckets of "
          f"{', '.join(map(str, sizes))} slots ({n} slots)", flush=True)


def check_grid_buckets(label, u, want, widths, **kw):
    """Every slot of a whole-wave slot_grid launch equals that slot from
    launches of 1, 3 and 32 slots (ragged tails included), bit for bit."""
    from repro_torch.kernels import hydro_rhs as kern

    def launch(a, m):
        wk = (dict(h_slots=widths[a:a + m])
              if isinstance(widths, torch.Tensor) else dict(h=widths))
        return kern.hydro_rhs_cuda(u[a:a + m], **wk, **kw)

    check_slot_buckets(label, u.shape[0], want, launch)


def blocks(u, s):
    """A global state (F, N, N, N) as its sub-grids of s^3, (n, F, S, S,
    S)."""
    g = u.shape[-1] // s
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
    from repro_torch.kernels import extract as ext
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
        exe = runner.executor
        copies0 = exe.stats["static_parent_copies"] if exe else 0
        sync()
        zero_launch_counts()                       # the main path's count
        ext.extract_cuda.launches = 0
        t0 = time.perf_counter()
        u = u0
        for dt in dts:
            u = runner.rk3_step(u, dt)
        sync()
        wall = time.perf_counter() - t0
        launches = kernel_launches(kern.hydro_rhs_cuda)
        extracts = ext.extract_cuda.launches
        copies = (exe.stats["static_parent_copies"] - copies0 if exe
                  else 0)
        path_launches = runner.stats["kernel_launches"] - before
        print(f"main path {label}: {wall / steps * 1e3:.3f} ms/step, "
              f"{path_launches / steps:g} launches/step, hydro_rhs kernel "
              f"launches {launches}, extraction kernel launches {extracts}, "
              f"parents copied into static ones {copies} over {steps} "
              f"steps", flush=True)
        check(launches > 0, f"{label}: the kernel was never launched")
        check(launches == path_launches == 3 * steps * per_stage,
              f"{label}: kernel launches {launches}, runner {path_launches},"
              f" greedy decomposition {3 * steps * per_stage}")
        check(extracts == 3 * steps, f"{label}: extraction kernel launches "
              f"{extracts}, want one a stage ({3 * steps})")
        check(copies == 0, f"{label}: {copies} parents copied into static "
              f"ones: a population was not written in place")
        outs[label] = u
        rows[label] = dict(ms_per_step=wall / steps * 1e3,
                           launches_per_step=path_launches / steps,
                           kernel_launches=launches,
                           extract_launches=extracts,
                           static_parent_copies=copies)

    fused = outs["fused"]
    for label, u in outs.items():
        check(torch.equal(u, fused), f"{label} is not bit-identical to fused")
    check(not bool(torch.isnan(fused).any()), "the solution went NaN")
    # the kernel path against the plain path, sub-grid by sub-grid: the
    # per-stage kernel tolerance compounded over 3 stages per step
    ref = blocks(u_ref, cfg.subgrid)
    diff, _ = compare(f"kernel path vs plain path after {steps} steps, per "
                      f"sub-grid", blocks(fused, cfg.subgrid), ref,
                      block_scale(ref),
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
    return dts, fused


# ---------------------------------------------------------------------------
# the sub-grid extraction kernel against its plain version
# ---------------------------------------------------------------------------

def same_bits(a, b):
    """Equal shapes, dtypes and bytes (NaN included)."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(torch.uint8),
                            b.contiguous().view(torch.uint8)))


def extract_level(n, seed, dev):
    """A random (5, n, n, n) fp32 level on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((5, n, n, n), generator=g, device=dev)


def phase_extract_kernel(dev, card, results):
    """The sub-grid extraction kernel (``csrc/extract.cu``) against its
    plain version (``F.pad`` and ``unfold``) bit for bit, allocating and
    into a caller's ``out``, at the benchmark cells' shapes: 4,096 and
    32,768 slots of 14^3 (128^3 and 256^3 levels, outflow; 128^3 also
    periodic), both levels of the two-level c16 exchange (the coarse
    128^3 level after restriction, outflow, and the fine 134^3 level after
    its ghosts are prolongated, padded) and, where each thread stores its
    own elements, 15^3 (512 slots of 9^3, ghost 3) and 5^3 (512 interiors
    of 5^3).  Each timed by graph replay against its plain version and its
    bound: the bytes written plus the level read once, over HBM bandwidth.
    Then the c16 scenario under ``s3`` cap 512 on the card: one step
    launches the kernel 6 times (each stage's exchange graph holds 2
    extraction nodes) and copies no parent into a static one."""
    from repro_torch.configs.base import AggregationConfig, AMRHydroConfig
    from repro_torch.core import AMRSedovScenario, StrategyRunner
    from repro_torch.hydro.state import (
        _fine_fill_ghosts, amr_sedov_init, sync_coarse,
    )
    from repro_torch.hydro.stepper import amr_courant_dt
    from repro_torch.kernels import extract as ext

    acfg = AMRHydroConfig(name="amr_sedov_c16", coarse_grids_per_edge=16,
                          cover=64)
    st = amr_sedov_init(acfg, device=dev)
    ucs = sync_coarse(st.uc, st.uf, acfg)
    cases = (("l4 128^3 outflow", extract_level(128, 1, dev), 8, 3,
              "outflow"),
             ("l4 128^3 periodic", extract_level(128, 2, dev), 8, 3,
              "periodic"),
             ("l5 256^3 outflow", extract_level(256, 3, dev), 8, 3,
              "outflow"),
             ("c16 coarse 128^3 outflow", ucs, acfg.coarse_subgrid,
              acfg.ghost, "outflow"),
             ("c16 fine 134^3 padded", _fine_fill_ghosts(ucs, st.uf, acfg),
              acfg.fine_subgrid, acfg.ghost, "padded"),
             ("15^3 per element", extract_level(72, 4, dev), 9, 3,
              "outflow"),
             ("5^3 interiors per element", extract_level(40, 5, dev), 5, 0,
              "outflow"))
    rows = {}
    for label, src, s, g, boundary in cases:
        want = ext.extract_plain(src, s, g, boundary)
        got = ext.extract_cuda(src, s, g, boundary)
        out = torch.full_like(want, float("nan"))
        ext.extract_cuda(src, s, g, boundary, out=out)
        check(same_bits(got, want) and same_bits(out, want),
              f"extract {label}: the kernel differs from its plain version")
        ms = time_graph_ms(
            lambda: ext.extract_cuda(src, s, g, boundary, out=out), reps=20)
        plain_ms = time_cuda_ms(
            lambda: ext.extract_plain(src, s, g, boundary, out=out), reps=5,
            warm=1)
        n_bytes = (out.numel() + src.numel()) * out.element_size()
        b_ms, b_by = bound_ms(n_bytes, 0)
        rows[label] = dict(slots=out.shape[0], p=out.shape[-1], ms=ms,
                           plain_ms=plain_ms, bound_ms=b_ms, bytes=n_bytes,
                           written_tb_per_s=out.numel() * out.element_size()
                           / (ms * 1e-3) / 1e12)
        print(f"extract ({card}): {label}, {out.shape[0]} slots of "
              f"{out.shape[-1]}^3: bit-equal to the plain version, "
              f"allocating and into out=; {ms:.4f} ms (graph replay), plain "
              f"version {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}: "
              f"{n_bytes / 1e6:.1f} MB), {ms / b_ms:.2f}x its bound, "
              f"{rows[label]['written_tb_per_s']:.2f} TB/s written",
              flush=True)
        del want, got, out
    del cases, ucs

    # the c16 exchange on its path: launches per step, no parent copied
    sc = AMRSedovScenario(acfg)
    runner = StrategyRunner(sc, AggregationConfig(strategy="s3",
                                                  max_aggregated=512),
                            device=dev)
    runner.warmup()
    state = (st.uc, st.uf)
    dt = amr_courant_dt(st.uc, st.uf, acfg)
    state = runner.rk3_step(state, dt)           # one untimed step
    sync()
    calls = []
    exchange = sc.exchange
    sc.exchange = lambda *a, **kw: (calls.append(1), exchange(*a, **kw))[1]
    copies0 = runner.executor.stats["static_parent_copies"]
    ext.extract_cuda.launches = 0
    runner.rk3_step(state, dt)
    sync()
    # every exchange graph (one per state shape and output pair) holds
    # the same nodes
    (nodes,) = {sum("extract_kernel" in k for k in g.kernel_names())
                for g in sc.exchange_graphs.values()}
    launches = ext.extract_cuda.launches + len(calls) * nodes
    copies = runner.executor.stats["static_parent_copies"] - copies0
    print(f"extract ({card}): c16 under s3 cap 512, one step: "
          f"{len(calls)} exchanges of {nodes} extraction nodes, "
          f"{ext.extract_cuda.launches} eager launches: {launches} "
          f"launches; {copies} parents copied into static ones", flush=True)
    check(ext.extract_cuda.launches == 0 and nodes == 2 and launches == 6,
          f"extract c16: {launches} launches a step, want 6")
    check(copies == 0, f"extract c16: {copies} parents copied a step")
    del runner, sc, st, state
    first = rows["l4 128^3 outflow"]
    results["extract_kernel"] = dict(
        name="extract", route="cuda", source="src/repro_torch/csrc/extract.cu",
        replaces="src/repro/hydro/state.py:96 (jnp.pad and XLA's gather; no "
                 "TPU kernel)",
        max_abs_err=0.0, ms=first["ms"], plain_ms=first["plain_ms"],
        bound_ms=first["bound_ms"], bound_by="bytes", library_ms=None)
    results["extract_detail"] = dict(rows=rows, c16_launches_per_step=launches,
                                     c16_static_parent_copies=copies)


# ---------------------------------------------------------------------------
# the gravity kernel and the split pair against their plain versions
# ---------------------------------------------------------------------------

def flux_sector_bytes(n, subgrid, ghost=3):
    """Bytes of the 32-byte sectors holding the values Flux must read (the
    memory's unit of transfer): a face reads rows of S floats at P-float
    strides, so most sectors it touches hold values it does not need.  n
    slots; each (pair, side, field) plane starts on a sector boundary."""
    from repro_torch.kernels.hydro_split import flux_read_states

    p = subgrid + 2 * ghost
    sectors = {((((pair * 2 + side) * 5 + f) * p + c[0]) * p * p
                + c[1] * p + c[2]) * 4 // 32
               for (pair, side, c) in flux_read_states(subgrid, ghost)
               for f in range(5)}
    return n * len(sectors) * 32


def recon_by_field(recon):
    """(n, 13, 2, F, P, P, P) -> (n, F, 26 P, P, P), so ``compare`` takes
    its scale per slot and field over every pair, side and cell."""
    n, _, _, f, p = recon.shape[:5]
    return recon.permute(0, 3, 1, 2, 4, 5, 6).reshape(n, f, 26 * p, p, p)


def kernel_entry(name, source, replaces, errs, ms, plain_ms, n_bytes,
                 n_ops, flop_per_s=FP32_FLOP_PER_S, library_ms=None):
    b_ms, b_by = bound_ms(n_bytes, n_ops, flop_per_s)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=max(e[0] for e in errs), ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=library_ms)


def print_timing(name, n, ms, ms_32, plain_ms, entry, n_bytes, n_ops,
                 how=""):
    print(f"{name} time on the Sedov IC, {n} slots{how}: {ms:.4f} ms (32 "
          f"slots {ms_32:.4f} ms by graph replay); plain version "
          f"{plain_ms:.3f} ms; bound {entry['bound_ms']:.4f} ms "
          f"({entry['bound_by']}: "
          f"{n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.4f} GFLOP), so the kernel "
          f"takes {ms / entry['bound_ms']:.1f}x its bound", flush=True)


def gravity_other_sizes(gcfg, dev, errs):
    """The gravity kernel at 5^3 (512 sub-grids, P = 11: the 2-cell
    instance) and 16^3 (64 sub-grids, ``CONFIG_16``: the 16-cell instance),
    on the Sedov IC with widths 2h, h: bit-equal to the plain version and
    every slot equal to its result from buckets of 1, 3 and 32; each timed
    by graph replay.  Returns the differing elements and the ms per
    size."""
    from repro_torch.configs.base import HydroConfig
    from repro_torch.hydro.state import extract_subgrids, sedov_init
    from repro_torch.kernels import gravity as grav

    differ, times = {}, {}
    for s in (5, 16):
        c = HydroConfig(subgrid=s, levels=2 if s == 16 else
                        gcfg.hydro.levels)
        kw = dict(ghost=c.ghost, subgrid=s, g_const=gcfg.g_const,
                  n_iter=gcfg.relax_iters)
        u = extract_subgrids(sedov_init(c, device=dev).u, s, c.ghost)
        n = u.shape[0]
        hs = alternating_widths(n, c.domain / (c.grids_per_edge * s), dev)
        got = grav.gravity_cuda(u, hs, **kw)
        want = grav.gravity_plain(u, hs, **kw)
        errs.append(compare(f"gravity kernel vs plain at {s}^3, widths 2h, "
                            f"h {tuple(u.shape)}", got, want,
                            slot_field_max(want), ATOL_SCALE, RTOL,
                            names=GRAVITY_FIELDS))
        differ[s] = int((got != want).sum())
        check(differ[s] == 0, f"gravity at {s}^3: {differ[s]} elements "
                              f"differ from the plain version")
        check_slot_buckets(f"gravity at {s}^3", n, got,
                           lambda a, m: grav.gravity_cuda(
                               u[a:a + m], hs[a:a + m], **kw))
        times[s] = time_graph_ms(lambda: grav.gravity_cuda(u, hs, **kw),
                                 reps=20)
        print(f"gravity at {s}^3: {n} slots {times[s]:.4f} ms by graph "
              f"replay", flush=True)
    print(f"gravity at 5^3 and 16^3: elements that differ from the plain "
          f"version {differ}", flush=True)
    return differ, times


def phase_gravity_kernel(gcfg, dev, results):
    from repro_torch.hydro.state import extract_subgrids, sedov_init
    from repro_torch.kernels import gravity as grav
    from repro_torch.kernels import hydro_rhs as kern
    from repro_torch.kernels.counts import gravity_ops

    hc = gcfg.hydro
    kw = dict(ghost=hc.ghost, subgrid=hc.subgrid, g_const=gcfg.g_const,
              n_iter=gcfg.relax_iters)
    h = hc.domain / (hc.grids_per_edge * hc.subgrid)
    tol = dict(atol_scale=ATOL_SCALE, rtol=RTOL)
    u = extract_subgrids(sedov_init(hc, device=dev).u, hc.subgrid, hc.ghost)
    n = u.shape[0]
    hs = torch.full((n,), h, dtype=torch.float32, device=dev)
    got = grav.gravity_cuda(u, hs, **kw)
    want = grav.gravity_plain(u, hs, **kw)
    tol = dict(tol, names=GRAVITY_FIELDS)
    errs = [compare(f"gravity kernel vs plain, Sedov IC sub-grids "
                    f"{tuple(u.shape)}", got, want, slot_field_max(want),
                    **tol)]
    differ = int((got != want).sum())
    hs2 = alternating_widths(n, h, dev)
    got2 = grav.gravity_cuda(u, hs2, **kw)
    want2 = grav.gravity_plain(u, hs2, **kw)
    errs.append(compare("gravity kernel vs plain, widths 2h, h alternating",
                        got2, want2, slot_field_max(want2), **tol))
    differ2 = int((got2 != want2).sum())
    check(torch.equal(got2[1::2], got[1::2]),
          "gravity: slots of width h differ between the two launches")
    check_slot_buckets("gravity, Sedov IC", n, got,
                       lambda a, m: grav.gravity_cuda(u[a:a + m], hs[a:a + m],
                                                      **kw))
    check_slot_buckets("gravity, widths 2h, h", n, got2,
                       lambda a, m: grav.gravity_cuda(u[a:a + m],
                                                      hs2[a:a + m], **kw))
    differ_sizes, ms_sizes = gravity_other_sizes(gcfg, dev, errs)
    rng = np.random.default_rng(3)
    ur = torch.from_numpy(rng.standard_normal(
        (64,) + tuple(u.shape[1:])).astype(np.float32))
    ur[:, 0] = torch.from_numpy(
        (0.5 + rng.random((64,) + tuple(u.shape[2:]))).astype(np.float32))
    ur = ur.to(dev)
    hr = torch.full((64,), h, dtype=torch.float32, device=dev)
    want_r = grav.gravity_plain(ur, hr, **kw)
    got_r = grav.gravity_cuda(ur, hr, **kw)
    errs.append(compare("gravity kernel vs plain, random positive "
                        "densities (64 slots)", got_r, want_r,
                        slot_field_max(want_r), **tol))
    differ_r = int((got_r != want_r).sum())
    print(f"gravity: elements that differ from the plain version: {differ} "
          f"(uniform h), {differ2} (2h, h), {differ_r} (random), of "
          f"{got.numel()}, {got2.numel()}, {got_r.numel()}", flush=True)
    check(differ == differ2 == differ_r == 0,
          "gravity: the kernel is not bit-equal to its plain version")

    # the kernel is shorter than its wrapper's host time, so back-to-back
    # calls time the host: its time is the graph replay's, the back-to-back
    # reading is printed beside it
    ms_b2b = time_cuda_ms(lambda: grav.gravity_cuda(u, hs, **kw), reps=50)
    ms = time_graph_ms(lambda: grav.gravity_cuda(u, hs, **kw), reps=20)
    ms_32 = time_graph_ms(lambda: grav.gravity_cuda(u[:32], hs[:32], **kw),
                          reps=50)
    plain_ms = time_cuda_ms(lambda: grav.gravity_plain(u, hs, **kw), reps=5,
                            warm=1)
    p, s = hc.padded, hc.subgrid
    n_bytes = n * (4 * p ** 3 + 4 + 4 * 4 * s ** 3)
    n_ops = gravity_ops(n, s, hc.ghost, gcfg.relax_iters)
    entry = kernel_entry("gravity", "src/repro_torch/csrc/gravity.cu",
                         "src/repro/kernels/gravity.py:130", errs, ms,
                         plain_ms, n_bytes, n_ops)
    print_timing("gravity kernel", n, ms, ms_32, plain_ms, entry, n_bytes,
                 n_ops, how=" by graph replay")
    print(f"gravity kernel: {n} slots {ms_b2b:.4f} ms back to back, "
          f"{ms:.4f} ms by graph replay", flush=True)
    # Path A's hydro family: the fused hydro kernel in h_slots mode on the
    # same input, against its plain version
    hkw = dict(gamma=hc.gamma, ghost=hc.ghost, subgrid=hc.subgrid)
    ms_h = time_cuda_ms(lambda: kern.hydro_rhs_cuda(u, h_slots=hs, **hkw),
                        reps=50)
    plain_h = time_cuda_ms(
        lambda: kern.hydro_rhs_plain(u, h_slots=hs, **hkw), reps=3, warm=1)
    print(f"hydro_rhs kernel, h_slots mode, on Path A's input ({n} slots): "
          f"{ms_h:.4f} ms; plain version {plain_h:.3f} ms", flush=True)
    results["gravity_kernel"] = entry
    results["gravity_kernel_detail"] = dict(
        slots=n, ms_32_slots=ms_32, ms_back_to_back=ms_b2b, bytes=n_bytes,
        flop=n_ops, elements_differing=[differ, differ2, differ_r],
        elements_differing_by_size=differ_sizes, ms_by_size=ms_sizes,
        hydro_rhs_h_slots_ms=ms_h, hydro_rhs_h_slots_plain_ms=plain_h)


def reconstruct_odd_and_misaligned(cfg, dev, u, rk):
    """Reconstruct at 5^3 (512 sub-grids, P = 11: each (pair, side, field)
    plane starts at its own offset within 16 bytes; the Sedov IC and random
    states), and on the main path's input ``u`` read from, and written to,
    tensors one float past a 16-byte boundary: within the tolerance of the
    plain version at every cell, frame included, every slot equal to its
    result from buckets of 1, 33 and 512, the misaligned launch equal to
    the aligned one ``rk``.  Returns the errors."""
    from repro_torch.configs.base import HydroConfig
    from repro_torch.hydro.state import extract_subgrids, sedov_init
    from repro_torch.kernels import hydro_split as split

    tol = dict(atol_scale=ATOL_SCALE, rtol=RTOL)
    errs = []
    c = HydroConfig(subgrid=5, levels=cfg.levels)
    u5 = extract_subgrids(sedov_init(c, device=dev).u, 5, c.ghost)
    for label, x in (("Sedov IC", u5),
                     ("random smooth states",
                      random_slots(u5.shape[0], c.padded, dev, seed=7))):
        got = split.hydro_reconstruct_cuda(x)
        want = split.hydro_reconstruct_plain(x)
        errs.append(compare(f"reconstruct kernel vs plain at 5^3, {label} "
                            f"{tuple(x.shape)}", recon_by_field(got),
                            recon_by_field(want),
                            slot_field_max(recon_by_field(want)), **tol))
        del want
        check_slot_buckets(f"reconstruct at 5^3, {label}", x.shape[0], got,
                           lambda a, m: split.hydro_reconstruct_cuda(
                               x[a:a + m]), sizes=(1, 33, 512))
        del got
    buf = torch.empty(u.numel() + 1, device=dev)
    off = buf[1:].view(u.shape)
    off.copy_(u)
    obuf = torch.full((rk.numel() + 1,), float("nan"), device=dev)
    out = obuf[1:].view(rk.shape)
    check(off.data_ptr() % 16 == 4 and out.data_ptr() % 16 == 4,
          "the tensors are not 4 B past 16")
    # the wrapper allocates its own output: the misaligned one goes to the
    # kernel through its library's launch
    lib, p = split.build(), u.shape[-1]
    split._ready(lib, u.device)
    err = lib.hydro_reconstruct_launch(
        off.data_ptr(), out.data_ptr(), u.shape[0], p,
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"reconstruct launch into an output 4 B past 16: "
                    f"{lib.hydro_split_error_string(err)}")
    want = split.hydro_reconstruct_plain(u)
    errs.append(compare(f"reconstruct kernel vs plain, input and output 4 B "
                        f"past a 16-byte boundary {tuple(u.shape)}",
                        recon_by_field(out), recon_by_field(want),
                        slot_field_max(recon_by_field(want)), **tol))
    del want
    check(torch.equal(out, rk),
          "reconstruct: misaligned input and output differ from the same "
          "slots aligned")
    check_slot_buckets("reconstruct, input 4 B past a 16-byte boundary",
                       u.shape[0], rk,
                       lambda a, m: split.hydro_reconstruct_cuda(off[a:a + m]),
                       sizes=(1, 33))
    return errs


def phase_split_kernels(cfg, dev, results):
    from repro_torch.hydro.state import extract_subgrids, sedov_init
    from repro_torch.kernels import hydro_rhs as kern
    from repro_torch.kernels.counts import flux_ops, reconstruct_ops
    from repro_torch.kernels import hydro_split as split

    kw = dict(gamma=cfg.gamma, ghost=cfg.ghost, subgrid=cfg.subgrid)
    h = cfg.domain / (cfg.grids_per_edge * cfg.subgrid)
    tol = dict(atol_scale=ATOL_SCALE, rtol=RTOL)
    u = extract_subgrids(sedov_init(cfg, device=dev).u, cfg.subgrid,
                         cfg.ghost)
    ur = random_slots(64, cfg.padded, dev, seed=4)
    errs_r, errs_f = [], []
    for label, x, hx in ((f"Sedov IC sub-grids {tuple(u.shape)}", u, h),
                         ("random smooth states (64 slots)", ur, 0.01)):
        rk = split.hydro_reconstruct_cuda(x)
        rp = split.hydro_reconstruct_plain(x)
        errs_r.append(compare(f"reconstruct kernel vs plain at every cell, "
                              f"{label}", recon_by_field(rk),
                              recon_by_field(rp),
                              slot_field_max(recon_by_field(rp)), **tol))
        del rk
        fk = split.hydro_flux_cuda(rp, h=hx, **kw)
        fp = split.hydro_flux_plain(rp, h=hx, **kw)
        errs_f.append(compare(f"flux kernel vs plain on the same "
                              f"reconstruction, {label}", fk, fp,
                              slot_field_max(fp), **tol))
        del rp
        pair = split.hydro_flux_cuda(split.hydro_reconstruct_cuda(x), h=hx,
                                     **kw)
        fused = kern.hydro_rhs_cuda(x, h=hx, **kw)
        compare(f"the pair vs the fused hydro_rhs kernel, {label}", pair,
                fused, slot_field_max(fused), atol_scale=3e-6, rtol=RTOL)
    rk = split.hydro_reconstruct_cuda(u)
    check_slot_buckets("reconstruct, Sedov IC", u.shape[0], rk,
                       lambda a, m: split.hydro_reconstruct_cuda(u[a:a + m]),
                       sizes=(1, 33, 512))
    errs_r += reconstruct_odd_and_misaligned(cfg, dev, u, rk)
    fk = split.hydro_flux_cuda(rk, h=h, **kw)
    check(torch.equal(split.hydro_flux_cuda(rk[32:64].contiguous(), h=h,
                                            **kw), fk[32:64]),
          "flux: a 32-slot launch differs from the same slots in a 512 "
          "launch")

    n, p, s = u.shape[0], cfg.padded, cfg.subgrid
    ms_r = time_cuda_ms(lambda: split.hydro_reconstruct_cuda(u), reps=50)
    ms_r32 = time_graph_ms(lambda: split.hydro_reconstruct_cuda(u[:32]),
                           reps=50)
    ms_f = time_cuda_ms(lambda: split.hydro_flux_cuda(rk, h=h, **kw),
                        reps=50)
    ms_f32 = time_graph_ms(
        lambda: split.hydro_flux_cuda(rk[:32], h=h, **kw), reps=50)
    f_per_sm, f_resident = split.flux_occupancy(dev, cfg.subgrid)
    ms_pair = time_cuda_ms(lambda: split.hydro_flux_cuda(
        split.hydro_reconstruct_cuda(u), h=h, **kw), reps=50)
    ms_fused = time_cuda_ms(lambda: kern.hydro_rhs_cuda(u, h=h, **kw),
                            reps=50)
    plain_r = time_cuda_ms(lambda: split.hydro_reconstruct_plain(u), reps=3,
                           warm=1)
    plain_f = time_cuda_ms(lambda: split.hydro_flux_plain(rk, h=h, **kw),
                           reps=3, warm=1)
    r_bytes = n * 5 * p ** 3 * 4 * (1 + 26)
    r_ops = reconstruct_ops(n, p)
    f_bytes = split.flux_read_bytes(n, s, cfg.ghost) + n * 5 * s ** 3 * 4
    f_ops = flux_ops(n, s, cfg.ghost)
    rec = kernel_entry("hydro_reconstruct",
                       "src/repro_torch/csrc/hydro_split.cu",
                       "src/repro/kernels/hydro_rhs.py:301", errs_r, ms_r,
                       plain_r, r_bytes, r_ops)
    flx = kernel_entry("hydro_flux", "src/repro_torch/csrc/hydro_split.cu",
                       "src/repro/kernels/hydro_rhs.py:327", errs_f, ms_f,
                       plain_f, f_bytes, f_ops)
    print_timing("reconstruct kernel", n, ms_r, ms_r32, plain_r, rec,
                 r_bytes, r_ops)
    print_timing("flux kernel", n, ms_f, ms_f32, plain_f, flx, f_bytes,
                 f_ops)
    f_sectors = flux_sector_bytes(n, s, cfg.ghost)
    print(f"flux: the 32-byte sectors holding its values are "
          f"{f_sectors / 1e6:.1f} MB ({f_sectors / f_bytes:.2f}x the bound's "
          f"bytes), {f_sectors / HBM_BYTES_PER_S * 1e3:.4f} ms at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s", flush=True)
    print(f"flux: {n * kern.CLUSTER} CTAs in clusters of {kern.CLUSTER} x {kern.CTA_THREADS} threads at "
          f"{n} slots, {split.flux_smem_bytes(s)} B of shared memory per "
          f"CTA, {f_per_sm} CTAs per SM, {f_resident} clusters resident",
          flush=True)
    print(f"split pair at {n} slots: {ms_pair:.4f} ms against the fused "
          f"hydro_rhs kernel's {ms_fused:.4f} ms in this call "
          f"({ms_pair / ms_fused:.2f}x); the reconstruction it stages is "
          f"{n * 26 * 5 * p ** 3 * 4 / 1e6:.1f} MB", flush=True)
    results["reconstruct_kernel"] = rec
    results["flux_kernel"] = flx
    results["split_detail"] = dict(
        slots=n, reconstruct_ms_32_slots=ms_r32, flux_ms_32_slots=ms_f32,
        flux_ctas_per_sm=f_per_sm, flux_resident_clusters=f_resident,
        pair_ms=ms_pair, fused_ms=ms_fused, reconstruct_bytes=r_bytes,
        reconstruct_flop=r_ops, flux_bytes=f_bytes, flux_flop=f_ops,
        flux_sector_bytes=f_sectors)


# ---------------------------------------------------------------------------
# the lane kernel (slot_lane layout) against its plain version
# ---------------------------------------------------------------------------

def lane_major(u):
    """(n, F, ...) -> (F, ..., n), contiguous: the lane kernel's input."""
    return u.permute(*range(1, u.dim()), 0).contiguous()


def slot_major(x):
    """(F, ..., n) -> (n, F, ...), a view: the lane kernel's output the way
    ``compare`` takes it (scale per slot and field)."""
    return x.permute(x.dim() - 1, *range(x.dim() - 1))


def check_lane_buckets(label, u, want_t, widths, **kw):
    """Every slot of a whole-wave launch equals that slot from launches of
    1, 3 and 32 slots (ragged tails included), bit for bit."""
    from repro_torch.kernels import hydro_rhs as kern

    def launch(a, m):
        wk = (dict(h_slots=widths[a:a + m])
              if isinstance(widths, torch.Tensor) else dict(h=widths))
        return slot_major(kern.hydro_rhs_lane_cuda(lane_major(u[a:a + m]),
                                                   **wk, **kw))

    check_slot_buckets(label, u.shape[0], slot_major(want_t), launch)


def phase_lane_kernel(cfg, cfg16, dev, results):
    """The lane kernel at 512 x 8^3 (static h and widths h, 2h) and at
    64 x 16^3 (the slot_grid kernel's two-slab size): against its
    plain version, against the slot_grid kernel at 8^3, bucket independence,
    and its times beside the two transposes and its bound."""
    from repro_torch.hydro.state import extract_subgrids, sedov_init
    from repro_torch.kernels import hydro_rhs as kern
    from repro_torch.kernels.counts import hydro_rhs_ops

    tol = dict(atol_scale=ATOL_SCALE, rtol=RTOL)
    errs, detail = [], {}
    for c in (cfg, cfg16):
        s, label = c.subgrid, f"{c.n_subgrids} x {c.subgrid}^3"
        kw = dict(gamma=c.gamma, ghost=c.ghost, subgrid=s)
        h = c.domain / (c.grids_per_edge * s)
        u = extract_subgrids(sedov_init(c, device=dev).u, s, c.ghost)
        n = u.shape[0]
        ut = lane_major(u)
        got = kern.hydro_rhs_lane_cuda(ut, h=h, **kw)
        want = kern.hydro_rhs_lane_plain(ut, h=h, **kw)
        errs.append(compare(f"lane kernel vs plain, Sedov IC ({label})",
                            slot_major(got), slot_major(want),
                            slot_field_max(slot_major(want)), **tol))
        ur = lane_major(random_slots(64, c.padded, dev, seed=5))
        want_r = kern.hydro_rhs_lane_plain(ur, h=0.01, **kw)
        errs.append(compare(f"lane kernel vs plain, random smooth states "
                            f"(64 x {s}^3)",
                            slot_major(kern.hydro_rhs_lane_cuda(ur, h=0.01,
                                                                **kw)),
                            slot_major(want_r),
                            slot_field_max(slot_major(want_r)), **tol))
        check_lane_buckets(f"lane kernel, Sedov IC ({label})", u, got, h,
                           **kw)
        ms = time_cuda_ms(lambda: kern.hydro_rhs_lane_cuda(ut, h=h, **kw),
                          reps=50)
        plain_ms = time_cuda_ms(
            lambda: kern.hydro_rhs_lane_plain(ut, h=h, **kw), reps=3, warm=1)
        n_bytes = (u.numel() + got.numel()) * 4
        n_ops = hydro_rhs_ops(n, s, c.ghost)
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        row = dict(slots=n, subgrid=s, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by, bytes=n_bytes, flop=n_ops)
        if s == cfg.subgrid:
            hs = alternating_widths(n, h, dev)
            got_h = kern.hydro_rhs_lane_cuda(ut, h_slots=hs, **kw)
            want_h = kern.hydro_rhs_lane_plain(ut, h_slots=hs, **kw)
            errs.append(compare("lane kernel vs plain, h_slots (2h, h "
                                "alternating)", slot_major(got_h),
                                slot_major(want_h),
                                slot_field_max(slot_major(want_h)), **tol))
            check(torch.equal(got_h[..., 1::2], got[..., 1::2]),
                  "lane h_slots slots of width h differ from the scalar-h "
                  "launch")
            check_lane_buckets("lane kernel, widths 2h, h", u, got_h, hs,
                               **kw)
            uc = lane_major(cold_flow_slots(n, c.padded, dev, seed=2))
            want_c = kern.hydro_rhs_lane_plain(uc, h=h, **kw)
            got_c = kern.hydro_rhs_lane_cuda(uc, h=h, **kw)
            errs.append(compare(f"lane kernel vs plain, cold flow on the "
                                f"pressure floor ({n} slots)",
                                slot_major(got_c), slot_major(want_c),
                                slot_field_max(slot_major(want_c)), **tol))
            # the two layouts: same device math, same order
            grid = kern.hydro_rhs_cuda(u, h=h, **kw)
            grid_h = kern.hydro_rhs_cuda(u, h_slots=hs, **kw)
            grid_c = kern.hydro_rhs_cuda(slot_major(uc).contiguous(), h=h,
                                         **kw)
            differ = []
            for lab, a, b in (("Sedov IC", got, grid),
                              ("2h, h", got_h, grid_h),
                              ("cold flow", got_c, grid_c)):
                compare(f"lane kernel vs slot_grid kernel, {lab}",
                        slot_major(a), b, slot_field_max(b), **tol)
                differ.append(int((slot_major(a) != b).sum()))
            print(f"lane vs slot_grid kernel: elements that differ "
                  f"{differ} (Sedov IC, 2h/h, cold flow) of {grid.numel()} "
                  f"each", flush=True)
            check(differ == [0, 0, 0], "the lane kernel and the slot_grid "
                  "kernel differ: the same device math must agree bit for "
                  "bit")
            u32 = lane_major(u[:32])
            out_t = got.clone()
            row.update(
                ms_32_slots=time_graph_ms(
                    lambda: kern.hydro_rhs_lane_cuda(u32, h=h, **kw),
                    reps=50),
                ms_h_slots=time_cuda_ms(
                    lambda: kern.hydro_rhs_lane_cuda(ut, h_slots=hs, **kw),
                    reps=50),
                ms_cold_flow=time_cuda_ms(
                    lambda: kern.hydro_rhs_lane_cuda(uc, h=h, **kw), reps=50),
                permute_in_ms=time_cuda_ms(lambda: lane_major(u), reps=50),
                permute_out_ms=time_cuda_ms(
                    lambda: slot_major(out_t).contiguous(), reps=50),
                slot_grid_ms=time_cuda_ms(
                    lambda: kern.hydro_rhs_cuda(u, h=h, **kw), reps=50),
                elements_differing_from_slot_grid=differ)
            print(f"lane kernel, {label}: 32 slots {row['ms_32_slots']:.4f} "
                  f"ms by graph replay; h_slots mode {row['ms_h_slots']:.4f} "
                  f"ms; cold flow {row['ms_cold_flow']:.4f} ms; transposes in "
                  f"{row['permute_in_ms']:.4f} ms, out "
                  f"{row['permute_out_ms']:.4f} ms; slot_grid kernel in this "
                  f"call {row['slot_grid_ms']:.4f} ms", flush=True)
        sms = kern.sm_count(torch.cuda.current_device())
        plans = {m: kern.lane_plan(s, m, sms) for m in (32, n)}
        row.update(plan={m: plan._asdict() for m, plan in plans.items()},
                   occupancy={m: kern.lane_occupancy(dev, s, m)
                              for m in plans})
        if s != cfg.subgrid:
            u32 = lane_major(u[:32])
            row["ms_32_slots"] = time_graph_ms(
                lambda: kern.hydro_rhs_lane_cuda(u32, h=h, **kw), reps=50)
        for m, plan in plans.items():
            print(f"lane kernel, {label}, {m} tasks: tiles {plan.tile}, "
                  f"{plan.ctas} CTAs in clusters of {kern.CLUSTER} x "
                  f"{kern.LANE_THREADS} threads, {plan.smem} B of shared "
                  f"memory per CTA, {row['occupancy'][m][0]} CTAs per SM, "
                  f"{plan.face_evals / (3 * (s + 1) * s * s):.3f}x the face "
                  f"evaluations needed", flush=True)
        print(f"lane kernel time on the Sedov IC, {label}: {ms:.4f} ms; "
              f"32 tasks {row['ms_32_slots']:.4f} ms by graph replay; "
              f"plain version {plain_ms:.3f} ms; bound {b_ms:.4f} ms "
              f"({b_by}: {n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.3f} GFLOP), "
              f"so the kernel takes {ms / b_ms:.1f}x its bound", flush=True)
        detail[f"s{s}"] = row
    first = detail[f"s{cfg.subgrid}"]
    results["lane_kernel"] = dict(
        name="hydro_rhs_lane", route="cuda",
        source="src/repro_torch/csrc/hydro_rhs_lane.cu",
        replaces="src/repro/kernels/hydro_rhs.py:154",
        max_abs_err=max(e[0] for e in errs), ms=first["ms"],
        plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
        bound_by=first["bound_by"], library_ms=None)
    results["lane_kernel_detail"] = detail


# ---------------------------------------------------------------------------
# Path A (gravity) and Path B (the split body)
# ---------------------------------------------------------------------------

def drive(runner, u0, dts, counters):
    """One row: warm up, take one untimed step, zero the kernels' counters,
    then time len(dts) RK3 steps on the host clock (synchronised).  Returns
    the state and the row's numbers, the counters read just after.  A state
    may be a tuple of levels."""
    runner.warmup()
    runner.rk3_step(u0, dts[0])
    sync()
    fam0 = dict(runner.launches_by_family)
    launches0 = runner.stats["kernel_launches"]
    hist0 = {k: dict(v["aggregated_hist"])
             for k, v in runner.stats["regions"].items()}
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    t0 = time.perf_counter()
    u = u0
    for dt in dts:
        u = runner.rk3_step(u, dt)
    sync()
    wall = time.perf_counter() - t0
    steps = len(dts)
    fam = {k: v - fam0.get(k, 0)
           for k, v in runner.launches_by_family.items()}
    hists = {k: {b: c - hist0.get(k, {}).get(b, 0)
                 for b, c in v["aggregated_hist"].items()}
             for k, v in runner.stats["regions"].items()}
    return u, dict(ms_per_step=wall / steps * 1e3,
                   launches_per_step=(runner.stats["kernel_launches"]
                                      - launches0) / steps,
                   launches_by_family=fam, bucket_hists=hists,
                   kernel_launches={c.__name__: kernel_launches(c)
                                    for c in counters},
                   eager_launches={c.__name__: eager_launches(c)
                                   for c in counters},
                   peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20)


def per_stage_launches(agg, n):
    from repro_torch.core.aggregation import greedy_decomposition

    return 1 if agg.strategy == "fused" else len(
        greedy_decomposition(n, agg.bucket_sizes()))


def phase_gravity_path(gcfg, dev, steps, rows, results, key):
    from repro_torch.core import GravityScenario, StrategyRunner
    from repro_torch.configs.base import AggregationConfig
    from repro_torch.hydro.state import sedov_init
    from repro_torch.hydro.stepper import courant_dt, total_conserved
    from repro_torch.kernels import gravity as grav
    from repro_torch.kernels import hydro_rhs as kern

    hc = gcfg.hydro
    u0 = sedov_init(hc, device=dev).u
    h = hc.domain / u0.shape[-1]

    # the same scenario on the plain bodies, on the card: the reference,
    # and the source of the dts every row reuses
    def plain_hydro(x, hs):
        return kern.hydro_rhs_plain(x, h_slots=hs, gamma=hc.gamma,
                                    ghost=hc.ghost, subgrid=hc.subgrid)

    plain = StrategyRunner(GravityScenario(
        gcfg, hydro_body=plain_hydro,
        gravity_body=grav.gravity_batched_body(
            hc.ghost, hc.subgrid, gcfg.g_const, gcfg.relax_iters)),
        AggregationConfig(strategy="fused"), device=dev)
    u_ref, dts = u0, []
    for _ in range(steps):
        dts.append(courant_dt(u_ref, hc))
        u_ref = plain.rk3_step(u_ref, dts[-1])
    sync()

    outs, table = {}, {}
    for label, agg in rows:
        runner = StrategyRunner(GravityScenario(gcfg), agg, device=dev)
        u, row = drive(runner, u0, dts,
                       (kern.hydro_rhs_cuda, grav.gravity_cuda))
        want = 3 * steps * per_stage_launches(agg, hc.n_subgrids)
        counts = row["kernel_launches"]
        print(f"{gcfg.name} {hc.n_subgrids} sub-grids, {label}: "
              f"{row['ms_per_step']:.3f} ms/step, "
              f"{row['launches_per_step']:g} launches/step, by family "
              f"{row['launches_by_family']}, kernel launches over {steps} "
              f"steps {counts}", flush=True)
        check(counts["hydro_rhs_cuda"] > 0 and counts["gravity_cuda"] > 0,
              f"{label}: a kernel of the gravity path was never launched")
        check(counts["hydro_rhs_cuda"] == counts["gravity_cuda"] == want,
              f"{label}: kernel launches {counts}, greedy decomposition "
              f"{want} per family")
        check(row["launches_per_step"] * steps == 2 * want,
              f"{label}: runner launches {row['launches_per_step']}/step")
        if agg.strategy != "fused":
            check(row["launches_by_family"] == {"hydro_rhs": want,
                                                "gravity": want},
                  f"{label}: launches by family {row['launches_by_family']}")
        outs[label] = u
        table[label] = row

    fused = outs[rows[0][0]]
    for label, u in outs.items():
        check(torch.equal(u, fused), f"{label} is not bit-identical to fused")
    check(not bool(torch.isnan(fused).any()), "the solution went NaN")
    ref = blocks(u_ref, hc.subgrid)
    diff, _ = compare(f"{gcfg.name} kernel path vs plain path after {steps} "
                      f"steps, per sub-grid", blocks(fused, hc.subgrid), ref,
                      block_scale(ref), atol_scale=1e-6, rtol=1e-5)
    c0, c1 = total_conserved(u0, h), total_conserved(fused, h)
    mass = abs(float((c1[0] - c0[0]) / c0[0]))
    print(f"{gcfg.name}: mass drift after {steps} steps {mass:.2e} (energy "
          f"is not conserved under the gravity source)", flush=True)
    check(mass < 1e-5, "mass drift too large")
    results[key] = dict(config=gcfg.name, n_subgrids=hc.n_subgrids,
                        steps=steps, runs=table, plain_path_max_abs_diff=diff,
                        mass_drift=mass)
    return table


def phase_split_path(cfg, dev, dts, fused_kernel_path, results):
    from repro_torch.configs.base import AggregationConfig
    from repro_torch.core import StrategyRunner, UniformSedovScenario
    from repro_torch.hydro.state import sedov_init
    from repro_torch.kernels import hydro_split as split
    from repro_torch.kernels import ops

    u0 = sedov_init(cfg, device=dev).u
    h = cfg.domain / u0.shape[-1]
    rows = (("fused", AggregationConfig(strategy="fused")),
            ("s3 cap 32", AggregationConfig(strategy="s3",
                                            max_aggregated=32)),
            ("s3 cap 512", AggregationConfig(strategy="s3",
                                             max_aggregated=512)))
    outs, table = {}, {}
    for label, agg in rows:
        sc = UniformSedovScenario(
            cfg, batched_body=ops.hydro_split_batched_body(cfg, h))
        runner = StrategyRunner(sc, agg, device=dev)
        u, row = drive(runner, u0, dts, (split.hydro_reconstruct_cuda,
                                         split.hydro_flux_cuda))
        want = 3 * len(dts) * per_stage_launches(agg, cfg.n_subgrids)
        counts = row["kernel_launches"]
        print(f"split body, {label}: {row['ms_per_step']:.3f} ms/step, "
              f"{row['launches_per_step']:g} launches/step, kernel launches "
              f"over {len(dts)} steps {counts}, peak memory "
              f"{row['peak_mib']:.0f} MiB", flush=True)
        check(counts["hydro_reconstruct_cuda"] > 0
              and counts["hydro_flux_cuda"] > 0,
              f"split {label}: a kernel of the split path was never launched")
        check(counts["hydro_reconstruct_cuda"] == counts["hydro_flux_cuda"]
              == want == row["launches_per_step"] * len(dts),
              f"split {label}: kernel launches {counts}, greedy "
              f"decomposition {want}")
        outs[label] = u
        table[label] = row
    first = outs["fused"]
    for label, u in outs.items():
        check(torch.equal(u, first),
              f"split {label} is not bit-identical to split fused")
    check(not bool(torch.isnan(first).any()), "the split path went NaN")
    ref = blocks(fused_kernel_path, cfg.subgrid)
    diff, _ = compare(f"split path vs fused-kernel path after {len(dts)} "
                      f"steps, per sub-grid", blocks(first, cfg.subgrid), ref,
                      block_scale(ref), atol_scale=1e-6, rtol=1e-5)
    results["split_path"] = dict(steps=len(dts), runs=table,
                                 fused_kernel_path_max_abs_diff=diff)
    return table


# ---------------------------------------------------------------------------
# Path C (two-level AMR) and Path D (uniform Sedov on the lane kernel)
# ---------------------------------------------------------------------------

def amr_level_bodies(acfg, layout, plain):
    """The AMR scenario's family-body factory, sub-grid size -> body ``(k,
    F, P, P, P), (k,) -> (k, F, S, S, S)``: the layout's kernel through
    ``kernels.ops``, or its plain version called directly (the card's
    reference)."""
    import functools

    from repro_torch.kernels import hydro_rhs as kern
    from repro_torch.kernels.ops import level_batched_body

    if not plain:
        return functools.partial(level_batched_body, acfg.gamma, acfg.ghost,
                                 layout=layout)

    def factory(s):
        kw = dict(gamma=acfg.gamma, ghost=acfg.ghost, subgrid=s)
        if layout == "slot_grid":
            return lambda x, hs: kern.hydro_rhs_plain(x, h_slots=hs, **kw)
        return lambda x, hs: slot_major(kern.hydro_rhs_lane_plain(
            lane_major(x), h_slots=hs, **kw)).contiguous()
    return factory


def amr_reference(acfg, dev, steps, level_body=None, dts=None):
    """``steps`` RK3 steps of the per-level fused reference
    (``amr_reference_step``) from the AMR Sedov IC; the Courant dts are
    computed on the way unless given.  Returns (state, dts)."""
    from repro_torch.hydro.state import amr_sedov_init
    from repro_torch.hydro.stepper import amr_courant_dt, amr_reference_step

    st = amr_sedov_init(acfg, device=dev)
    state, out = (st.uc, st.uf), []
    for k in range(steps):
        out.append(amr_courant_dt(*state, acfg) if dts is None else dts[k])
        state = amr_reference_step(*state, out[-1], acfg,
                                   level_body=level_body)
    sync()
    return state, out


def check_physical(label, levels):
    """Finite, rho > 0 and E - KE > -1e-2 max E on every level (the
    reference's tests/test_amr.py bound: the unlimited scheme may undershoot
    internal energy at the front)."""
    for name, u in zip(("coarse", "fine"), levels):
        check(bool(torch.isfinite(u).all()), f"{label}: {name} not finite")
        check(bool((u[0] > 0).all()), f"{label}: {name} density <= 0")
        ke = 0.5 * (u[1] ** 2 + u[2] ** 2 + u[3] ** 2) / u[0]
        check(bool((u[4] - ke > -1e-2 * u[4].max()).all()),
              f"{label}: {name} internal energy below -1e-2 max E")


def phase_amr_path(acfg, layout, rows, dev, ref, dts, results, key,
                   hists=None):
    """Path C on one layout: ``AMRSedovScenario`` through every row,
    bit-identical to the first (``fused``) on both levels, launches equal
    to the greedy decomposition of each level's population, each level in
    agreement with ``ref`` (the same scenario on the plain bodies) per
    sub-grid, and physical.  ``hists`` is each region's expected bucket
    histogram per step under the executor rows.  Returns (fused state,
    rows)."""
    from repro_torch.core import AMRSedovScenario, StrategyRunner
    from repro_torch.hydro.state import amr_sedov_init
    from repro_torch.kernels import hydro_rhs as kern

    steps = len(dts)
    st = amr_sedov_init(acfg, device=dev)
    u0 = (st.uc, st.uf)
    counter, other = ((kern.hydro_rhs_lane_cuda, kern.hydro_rhs_cuda)
                      if layout == "slot_lane" else
                      (kern.hydro_rhs_cuda, kern.hydro_rhs_lane_cuda))
    name = f"{acfg.name} {layout}"
    outs, table = {}, {}
    for label, agg in rows:
        runner = StrategyRunner(AMRSedovScenario(
            acfg, hydro_body=amr_level_bodies(acfg, layout, plain=False)),
            agg, device=dev)
        u, row = drive(runner, u0, dts, (counter, other))
        want = 3 * steps * sum(per_stage_launches(agg, n) for n in (
            acfg.n_subgrids_coarse, acfg.n_subgrids_fine))
        counts = row["kernel_launches"]
        print(f"{name}, {acfg.n_subgrids_coarse}+{acfg.n_subgrids_fine} "
              f"sub-grids, {label}: {row['ms_per_step']:.3f} ms/step, "
              f"{row['launches_per_step']:g} launches/step, kernel launches "
              f"over {steps} steps {counts}, buckets {row['bucket_hists']}",
              flush=True)
        check(counts[counter.__name__] > 0,
              f"{name} {label}: the {layout} kernel was never launched")
        check(counts[counter.__name__] == want
              == row["launches_per_step"] * steps,
              f"{name} {label}: kernel launches {counts}, runner "
              f"{row['launches_per_step']}/step, greedy decomposition {want}")
        check(counts[other.__name__] == 0,
              f"{name} {label}: the other layout's kernel was launched")
        if hists is not None and agg.strategy != "fused":
            per_step = {k: {b: c * steps for b, c in v.items()}
                        for k, v in hists.items()}
            check(row["bucket_hists"] == per_step,
                  f"{name} {label}: buckets {row['bucket_hists']}, want "
                  f"{per_step} over {steps} steps")
        outs[label] = u
        table[label] = row
    fused = outs[rows[0][0]]
    for label, u in outs.items():
        check(torch.equal(u[0], fused[0]) and torch.equal(u[1], fused[1]),
              f"{name} {label} is not bit-identical to fused")
    check_physical(name, fused)
    diffs = []
    for lvl, got, want, s in (("coarse", fused[0], ref[0],
                               acfg.coarse_subgrid),
                              ("fine", fused[1], ref[1], acfg.fine_subgrid)):
        wb = blocks(want, s)
        diffs.append(compare(f"{name}: {lvl} level, kernel path vs plain "
                             f"path after {steps} steps, per sub-grid",
                             blocks(got, s), wb, block_scale(wb),
                             atol_scale=1e-6, rtol=1e-5)[0])
    hc = acfg.h_coarse
    m0, m1 = (float(x[0].sum()) * hc ** 3 for x in (u0[0], fused[0]))
    drift = abs((m1 - m0) / m0)
    print(f"{name}: coarse-level mass drift after {steps} steps {drift:.2e} "
          f"(not bounded: no refluxing at the coarse-fine face)", flush=True)
    results[key] = dict(config=acfg.name, layout=layout,
                        n_subgrids=[acfg.n_subgrids_coarse,
                                    acfg.n_subgrids_fine],
                        steps=steps, runs=table,
                        plain_path_max_abs_diff=diffs,
                        coarse_mass_drift=drift)
    return fused, table


def compare_layouts(label, lane, grid, acfg):
    """The slot_lane rows against the slot_grid rows, per level and
    sub-grid, with the path tolerance."""
    for lvl, a, b, s in (("coarse", lane[0], grid[0], acfg.coarse_subgrid),
                         ("fine", lane[1], grid[1], acfg.fine_subgrid)):
        wb = blocks(b, s)
        compare(f"{label}: {lvl} level, slot_lane vs slot_grid", blocks(a, s),
                wb, block_scale(wb), atol_scale=1e-6, rtol=1e-5)
        print(f"  elements that differ: {int((a != b).sum())} of "
              f"{a.numel()}", flush=True)


def phase_lane_path(cfg, dev, steps, results, key, dts=None, grid_path=None,
                    layout="slot_lane"):
    """Path D: uniform Sedov on the lane kernel (``hydro_batched_body(...,
    layout="slot_lane")``), or with ``layout="slot_grid"`` its twin on the
    slot_grid kernel, under fused, s3 cap 32 and s2+s3 4 x 32:
    bit-identical rows, launches equal to the greedy decomposition,
    conservation, and agreement per sub-grid with ``grid_path`` (the other
    layout's path, same dts) or, where there is none, the plain path.
    Returns (rows, fused state, dts)."""
    from repro_torch.configs.base import AggregationConfig
    from repro_torch.core import StrategyRunner, UniformSedovScenario
    from repro_torch.hydro.state import sedov_init
    from repro_torch.hydro.stepper import courant_dt, rk3_step, total_conserved
    from repro_torch.kernels import hydro_rhs as kern
    from repro_torch.kernels import ops

    u0 = sedov_init(cfg, device=dev).u
    h = cfg.domain / u0.shape[-1]
    counter, other = ((kern.hydro_rhs_lane_cuda, kern.hydro_rhs_cuda)
                      if layout == "slot_lane" else
                      (kern.hydro_rhs_cuda, kern.hydro_rhs_lane_cuda))
    kname = "lane" if layout == "slot_lane" else "slot_grid"
    ref, what = grid_path, ("the slot_grid path" if layout == "slot_lane"
                            else "the lane kernel's path")
    if ref is None:
        ref, dts, what = u0, [], "the plain path"
        for _ in range(steps):
            dts.append(courant_dt(ref, cfg))
            ref = rk3_step(ref, dts[-1], cfg)
        sync()
    rows = (("fused", AggregationConfig(strategy="fused")),
            ("s3 cap 32", AggregationConfig(strategy="s3",
                                            max_aggregated=32)),
            ("s2+s3 4 streams cap 32", AggregationConfig(
                strategy="s2+s3", n_executors=4, max_aggregated=32)))
    outs, table = {}, {}
    for label, agg in rows:
        sc = UniformSedovScenario(cfg, batched_body=ops.hydro_batched_body(
            cfg, h, layout=layout))
        runner = StrategyRunner(sc, agg, device=dev)
        u, row = drive(runner, u0, dts, (counter, other))
        want = 3 * len(dts) * per_stage_launches(agg, cfg.n_subgrids)
        counts = row["kernel_launches"]
        print(f"{cfg.name} on the {kname} kernel ({cfg.n_subgrids} x "
              f"{cfg.subgrid}^3), {label}: {row['ms_per_step']:.3f} ms/step, "
              f"{row['launches_per_step']:g} launches/step, kernel launches "
              f"over {len(dts)} steps {counts}", flush=True)
        check(counts[counter.__name__] > 0,
              f"{cfg.name} {label}: the {kname} kernel was never launched")
        check(counts[counter.__name__] == want
              == row["launches_per_step"] * len(dts)
              and counts[other.__name__] == 0,
              f"{cfg.name} {label}: kernel launches {counts}, greedy "
              f"decomposition {want}")
        outs[label] = u
        table[label] = row
    fused = outs["fused"]
    for label, u in outs.items():
        check(torch.equal(u, fused),
              f"{cfg.name} {kname} {label} is not bit-identical to fused")
    check(bool(torch.isfinite(fused).all()), f"{cfg.name} {kname} path not "
          f"finite")
    wb = blocks(ref, cfg.subgrid)
    diff, _ = compare(f"{cfg.name} {kname} path vs {what} after {len(dts)} "
                      f"steps, per sub-grid", blocks(fused, cfg.subgrid), wb,
                      block_scale(wb), atol_scale=1e-6, rtol=1e-5)
    c0, c1 = total_conserved(u0, h), total_conserved(fused, h)
    mass = abs(float((c1[0] - c0[0]) / c0[0]))
    energy = abs(float((c1[4] - c0[4]) / c0[4]))
    print(f"{cfg.name} {kname} path: mass drift {mass:.2e}, energy drift "
          f"{energy:.2e} after {len(dts)} steps", flush=True)
    check(mass < 1e-5 and energy < 1e-5, f"{cfg.name} {kname} path: "
          f"conservation drift too large")
    results[key] = dict(config=cfg.name, n_subgrids=cfg.n_subgrids,
                        subgrid=cfg.subgrid, layout=layout, steps=len(dts),
                        runs=table, reference=what,
                        reference_max_abs_diff=diff, mass_drift=mass,
                        energy_drift=energy)
    return table, fused, dts


# ---------------------------------------------------------------------------
# staging: the slot ring on 4 streams, hydro_rhs_prefix, host staging
# ---------------------------------------------------------------------------

# per launch on an executor stream, ~8 ms at 2 GHz: longer than the host
# takes to fill two buckets of 32, so a ring buffer comes round again while
# its last launch still waits to read it
SLEEP_CYCLES = 16_000_000
WAVES = 3


def delayed(body):
    """``body`` behind a ``torch.cuda._sleep`` on the stream it runs on: a
    launch on an executor stream reads its inputs late, so a ring slot
    overwritten before the launch has read it would show."""
    def slow(*args, out=None):
        torch.cuda._sleep(SLEEP_CYCLES)
        return body(*args, out=out)
    return slow


def phase_staging(cfg, dev, card, dts, fused_kernel_path, results):
    """The Sedov IC's 512 padded sub-grids submitted one at a time as
    concrete tensors, 3 waves in a row (each wave in another order), on 4
    streams at cap 32 with watermark 1 and 10^9, the executor streams
    delayed: every slot equal to the fused body bit for bit.  Then
    ``hydro_rhs_prefix`` at offsets 0, 1 and 31 of a ring, and the main
    path under host staging (s3 cap 32) against ``fused``."""
    from repro_torch.configs.base import AggregationConfig
    from repro_torch.core import (
        AggregationExecutor, SlotRing, StrategyRunner, UniformSedovScenario,
    )
    from repro_torch.hydro.state import extract_subgrids, sedov_init
    from repro_torch.kernels import hydro_rhs as kern
    from repro_torch.kernels import ops

    u0 = sedov_init(cfg, device=dev).u
    h = cfg.domain / u0.shape[-1]
    kw = dict(h=h, gamma=cfg.gamma, ghost=cfg.ghost, subgrid=cfg.subgrid)
    subs = extract_subgrids(u0, cfg.subgrid, cfg.ghost)
    want = kern.hydro_rhs_cuda(subs, **kw)
    n = subs.shape[0]
    body = delayed(ops.hydro_batched_body(cfg, h))
    rows = {}
    for wm in (1, 10 ** 9):
        exe = AggregationExecutor(body, AggregationConfig(
            strategy="s2+s3", n_executors=4, max_aggregated=32,
            launch_watermark=wm), device=dev)
        exe.warmup((((n,) + tuple(subs.shape[1:]), subs.dtype),))
        waves = []
        for w in range(WAVES):
            order = torch.roll(torch.arange(n, device=dev), 37 * w)
            tasks = list(subs[order].unbind(0))
            sync()
            t0 = time.perf_counter()
            futs = [exe.submit(t) for t in tasks]
            exe.flush()
            got = torch.stack([f.result() for f in futs])
            sync()
            waves.append((time.perf_counter() - t0) * 1e3)
            check(torch.equal(got, want[order]),
                  f"ring staging, watermark {wm}, wave {w}: a slot differs "
                  f"from the fused body")
        ring = exe.ring
        rows[f"watermark {wm}"] = dict(
            wave_ms=waves, writes=ring.writes, commits=ring.commits,
            compactions=ring.compactions, swaps=ring.swaps,
            launches=exe.stats["launches"],
            bucket_hist=dict(exe.stats["aggregated_hist"]))
        print(f"staging ({card}): ring, 4 streams, cap 32, watermark {wm}, "
              f"{WAVES} waves of {n} tasks, each launch delayed "
              f"{SLEEP_CYCLES} cycles: every slot equals the fused body; "
              f"ms per wave {[round(x, 3) for x in waves]}, ring writes "
              f"{ring.writes}, commits {ring.commits}, compactions "
              f"{ring.compactions}, swaps {ring.swaps}, launches "
              f"{exe.stats['launches']}, buckets "
              f"{dict(sorted(exe.stats['aggregated_hist'].items()))}",
              flush=True)

    ring = SlotRing(32, [subs[0]], device=dev)
    for i in range(32):
        ring.write([subs[(5 * i + 3) % n]])
    buf = ring.buffers()[0]
    for start, bucket in ((0, 32), (1, 8), (31, 1)):
        got = kern.hydro_rhs_prefix(buf, start, bucket, **kw)
        check(torch.equal(got, kern.hydro_rhs_cuda(
            buf[start:start + bucket].clone(), **kw)),
            f"hydro_rhs_prefix at offset {start} differs from the kernel")
    print("staging: hydro_rhs_prefix at offsets 0, 1 and 31 of a 32-slot "
          "ring equals the kernel on the same slots bit for bit", flush=True)

    agg = AggregationConfig(strategy="s3", max_aggregated=32,
                            staging="host")
    runner = StrategyRunner(UniformSedovScenario(cfg), agg, device=dev)
    u, row = drive(runner, u0, dts, (kern.hydro_rhs_cuda,))
    check(row["kernel_launches"]["hydro_rhs_cuda"] > 0,
          "host staging: the kernel was never launched")
    check(row["kernel_launches"]["hydro_rhs_cuda"]
          == row["launches_per_step"] * len(dts),
          f"host staging: kernel launches {row['kernel_launches']}, runner "
          f"{row['launches_per_step']}/step")
    check(torch.equal(u, fused_kernel_path),
          "host staging s3 cap 32 is not bit-identical to fused")
    print(f"staging ({card}): main path, s3 cap 32, host staging: "
          f"{row['ms_per_step']:.3f} ms/step (host, synchronised), "
          f"{row['launches_per_step']:g} launches/step, buckets "
          f"{row['bucket_hists']}, bit-identical to fused after {len(dts)} "
          f"steps", flush=True)
    rows["main path s3 cap 32 host staging"] = row
    results["staging"] = dict(card=card, sleep_cycles=SLEEP_CYCLES,
                              waves=WAVES, rows=rows)


# ---------------------------------------------------------------------------
# s2 (one launch per task over 4 streams) and the epilogue-fused stages
# ---------------------------------------------------------------------------

def s2_paths(cfg, gcfg, acfg, dev, dts):
    """(label, scenario factory, initial state, dts, kernel counters,
    tasks per family and iteration) for the main path and Paths A-D."""
    import functools

    from repro_torch.core import (
        AMRSedovScenario, GravityScenario, UniformSedovScenario,
    )
    from repro_torch.hydro.state import amr_sedov_init, sedov_init
    from repro_torch.hydro.stepper import amr_courant_dt, courant_dt
    from repro_torch.kernels import gravity as grav
    from repro_torch.kernels import hydro_rhs as kern
    from repro_torch.kernels import hydro_split as split
    from repro_torch.kernels import ops

    u0 = sedov_init(cfg, device=dev).u
    h = cfg.domain / u0.shape[-1]
    one = [courant_dt(u0, cfg)]
    st = amr_sedov_init(acfg, device=dev)
    n = cfg.n_subgrids
    amr_tasks = acfg.n_subgrids_coarse + acfg.n_subgrids_fine
    return (
        ("main path", lambda: UniformSedovScenario(cfg), u0, dts,
         (kern.hydro_rhs_cuda,), {"hydro_rhs": n}),
        ("Path A (gravity)", lambda: GravityScenario(gcfg), u0, one,
         (kern.hydro_rhs_cuda, grav.gravity_cuda),
         {"hydro_rhs": n, "gravity": n}),
        ("Path B (split pair)", lambda: UniformSedovScenario(
            cfg, batched_body=ops.hydro_split_batched_body(cfg, h)), u0, one,
         (split.hydro_reconstruct_cuda, split.hydro_flux_cuda),
         {"hydro_rhs": n}),
        ("Path C (AMR, slot_lane)", lambda: AMRSedovScenario(
            acfg, hydro_body=functools.partial(
                ops.level_batched_body, acfg.gamma, acfg.ghost,
                layout="slot_lane")), (st.uc, st.uf),
         [amr_courant_dt(st.uc, st.uf, acfg)], (kern.hydro_rhs_lane_cuda,),
         {"hydro_rhs_s8": amr_tasks}),
        ("Path D (lane kernel)", lambda: UniformSedovScenario(
            cfg, batched_body=ops.hydro_batched_body(cfg, h,
                                                     layout="slot_lane")),
         u0, one, (kern.hydro_rhs_lane_cuda,), {"hydro_rhs": n}),
    )


def levels(state):
    return state if isinstance(state, tuple) else (state,)


def states_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(levels(a), levels(b)))


def phase_s2(cfg, gcfg, acfg, dev, card, dts, results):
    """``s2`` with 4 streams on the main path (len(dts) steps) and Paths
    A-D (1 step each): bit-identical to ``fused``, 3 x tasks launches per
    step in every family, each launch counted by its kernel."""
    from repro_torch.configs.base import AggregationConfig
    from repro_torch.core import StrategyRunner

    table = {}
    for label, make, u0, path_dts, counters, tasks in s2_paths(
            cfg, gcfg, acfg, dev, dts):
        steps = len(path_dts)
        fused, _ = drive(StrategyRunner(make(), AggregationConfig(
            strategy="fused"), device=dev), u0, path_dts, counters)
        runner = StrategyRunner(make(), AggregationConfig(
            strategy="s2", n_executors=4), device=dev)
        u, row = drive(runner, u0, path_dts, counters)
        want = {k: 3 * steps * v for k, v in tasks.items()}
        check(row["launches_by_family"] == want,
              f"s2 {label}: launches by family {row['launches_by_family']},"
              f" want 3 x tasks per step {want}")
        # every family of these paths has the same tasks per iteration, and
        # each kernel serves one family (or both kernels of the split pair
        # the one family)
        per = 3 * steps * max(tasks.values())
        for c in counters:
            check(row["kernel_launches"][c.__name__] == per,
                  f"s2 {label}: {c.__name__} launched "
                  f"{row['kernel_launches'][c.__name__]} times, want {per}")
        check(states_equal(u, fused),
              f"s2 {label} is not bit-identical to fused")
        print(f"s2 ({card}): {label}, 4 streams, {steps} step(s): "
              f"{row['ms_per_step']:.3f} ms/step (host, synchronised), "
              f"{row['launches_per_step']:g} launches/step, by family "
              f"{ {k: v // steps for k, v in row['launches_by_family'].items()} }"
              f" per step, kernel launches {row['kernel_launches']}, "
              f"bit-identical to fused", flush=True)
        table[label] = row
    results["s2"] = dict(card=card, runs=table)
    return table


def phase_fused_stages(cfg, gcfg, acfg, dev, card, dts, results):
    """``fuse_epilogue`` on the main path, Path A and Path C (slot_lane):
    ``fused``, ``s3`` cap 32 and ``s2+s3`` 4 x 32 through the stage
    families.  The aggregated rows equal the fused stage reference (the
    ``fused`` row, ``reference_stage`` per stage) bit for bit; all are
    within rtol 1e-5, atol 1e-5 x max|u| of the generic combine; each
    ``+epi`` family launches the greedy decomposition.  ``s2`` with
    ``fuse_epilogue`` must decline it and equal generic ``fused``."""
    from repro_torch.configs.base import AggregationConfig
    from repro_torch.core import StrategyRunner
    from repro_torch.core.aggregation import greedy_decomposition

    rows = (("fused", dict(strategy="fused")),
            ("s3 cap 32", dict(strategy="s3", max_aggregated=32)),
            ("s2+s3 4 streams cap 32", dict(strategy="s2+s3", n_executors=4,
                                            max_aggregated=32)))
    table = {}
    paths = [p for p in s2_paths(cfg, gcfg, acfg, dev, dts)
             if p[0].split(" (")[0] in ("main path", "Path A", "Path C")]
    for label, make, u0, path_dts, counters, _ in paths:
        steps = len(path_dts)
        generic, _ = drive(StrategyRunner(make(), AggregationConfig(
            strategy="fused"), device=dev), u0, path_dts, counters)
        outs = {}
        for row_label, kw in rows:
            agg = AggregationConfig(fuse_epilogue=True, **kw)
            sc = make()
            runner = StrategyRunner(sc, agg, device=dev)
            check(runner.fuse_epilogue,
                  f"{label} {row_label}: fuse_epilogue was declined")
            u, row = drive(runner, u0, path_dts, counters)
            pops = sc.stage_populations(u0, u0, path_dts[0], 0.0, 1.0)
            want = {}
            for pop in pops:
                per = (1 if agg.strategy == "fused" else len(
                    greedy_decomposition(pop.n_tasks, agg.bucket_sizes())))
                want[pop.kernel] = want.get(pop.kernel, 0) + 3 * steps * per
            if agg.strategy != "fused":
                check(row["launches_by_family"] == want,
                      f"{label} {row_label} fused stages: launches by family "
                      f"{row['launches_by_family']}, greedy {want}")
            check(row["launches_per_step"] * steps == sum(want.values()),
                  f"{label} {row_label} fused stages: runner launches "
                  f"{row['launches_per_step']}/step, want "
                  f"{sum(want.values()) / steps}")
            for c in counters:
                check(row["kernel_launches"][c.__name__] > 0,
                      f"{label} {row_label}: {c.__name__} never launched")
            for got, ref in zip(levels(u), levels(generic)):
                scale = float(ref.abs().max())
                err = float((got - ref).abs().max())
                check(bool(((got - ref).abs()
                            <= 1e-5 * scale + 1e-5 * ref.abs()).all()),
                      f"{label} {row_label}: fused stages off the generic "
                      f"combine by {err:.3e} (scale {scale:.3e})")
                row.setdefault("generic_max_abs_diff", []).append(err)
            outs[row_label] = u
            print(f"fused stages ({card}): {label}, {row_label}, {steps} "
                  f"step(s): {row['ms_per_step']:.3f} ms/step (host, "
                  f"synchronised), {row['launches_per_step']:g} launches/"
                  f"step, by family over the run {row['launches_by_family']}"
                  f", vs generic "
                  f"combine max |diff| {row['generic_max_abs_diff']}",
                  flush=True)
            table[f"{label} {row_label}"] = row
        for row_label, u in outs.items():
            check(states_equal(u, outs["fused"]),
                  f"{label} {row_label} fused stages are not bit-identical "
                  f"to the fused stage reference")
    label, make, u0, path_dts, counters, _ = paths[0]
    runner = StrategyRunner(make(), AggregationConfig(
        strategy="s2", n_executors=4, fuse_epilogue=True), device=dev)
    check(not runner.fuse_epilogue, "s2 took fuse_epilogue")
    generic, _ = drive(StrategyRunner(make(), AggregationConfig(
        strategy="fused"), device=dev), u0, path_dts[:1], counters)
    u, _ = drive(runner, u0, path_dts[:1], counters)
    check(states_equal(u, generic),
          "s2 with fuse_epilogue is not the generic path")
    print("fused stages: s2 with fuse_epilogue declines it and equals "
          "generic fused bit for bit (main path, 1 step)", flush=True)
    results["fused_stages"] = dict(card=card, runs=table)
    return table


# ---------------------------------------------------------------------------
# compiled bucket programs: a CUDA graph per bucket launch site
# ---------------------------------------------------------------------------

class eager_programs:
    """Within the block, every compiled-program table files the eager
    callable (``graphs.make_program`` returns the function): the port's
    launches as they were before the programs became graphs, in this
    process, for the same counts and results."""

    def __enter__(self):
        from repro_torch.core import graphs

        self._made = graphs.make_program
        graphs.make_program = lambda fn, device, **kw: fn

    def __exit__(self, *exc):
        from repro_torch.core import graphs

        graphs.make_program = self._made


def bucket_graph_rows(cfg, cfg16, gcfg, acfg, dev, dts):
    """(label, scenario factory, state, dts, config, counters) of the
    bucket_graphs phase: the main path under s3 caps 32 and 512, s2+s3 (4
    streams, cap 32), host staging and the fused stages (len(dts) steps),
    then Paths A-D, Path C on both layouts, and CONFIG_16 (one step
    each)."""
    import functools

    from repro_torch.core import AMRSedovScenario, UniformSedovScenario
    from repro_torch.hydro.state import amr_sedov_init, sedov_init
    from repro_torch.hydro.stepper import amr_courant_dt, courant_dt
    from repro_torch.kernels import hydro_rhs as kern
    from repro_torch.kernels.ops import level_batched_body

    paths = {p[0]: p[1:5] for p in s2_paths(cfg, gcfg, acfg, dev, dts)}
    st = amr_sedov_init(acfg, device=dev)
    u16 = sedov_init(cfg16, device=dev).u
    s3 = dict(strategy="s3", max_aggregated=32)
    main = paths["main path"]          # (make, u0, dts, counters)
    rows = [(f"main path, {label}", main, kw) for label, kw in (
        ("s3 cap 32", s3),
        ("s3 cap 512", dict(strategy="s3", max_aggregated=512)),
        ("s2+s3 4 streams cap 32", dict(strategy="s2+s3", n_executors=4,
                                        max_aggregated=32)),
        ("s3 cap 32 host staging", dict(staging="host", **s3)),
        ("s3 cap 32 fused stages", dict(fuse_epilogue=True, **s3)))]
    rows += [(f"{label}, s3 cap 32", paths[label], s3) for label in (
        "Path A (gravity)", "Path B (split pair)", "Path C (AMR, slot_lane)",
        "Path D (lane kernel)")]
    rows.append(("Path C (AMR, slot_grid), s3 cap 32", (
        lambda: AMRSedovScenario(acfg, hydro_body=functools.partial(
            level_batched_body, acfg.gamma, acfg.ghost,
            layout="slot_grid")), (st.uc, st.uf),
        [amr_courant_dt(st.uc, st.uf, acfg)], (kern.hydro_rhs_cuda,)), s3))
    rows.append(("CONFIG_16 (slot_grid), s3 cap 16", (
        lambda: UniformSedovScenario(cfg16), u16, [courant_dt(u16, cfg16)],
        (kern.hydro_rhs_cuda,)), dict(strategy="s3", max_aggregated=16)))
    return [(label, make, u0, row_dts, kw, counters)
            for label, (make, u0, row_dts, counters), kw in rows]


def graph_row(make, u0, row_dts, agg, counters):
    """One row through ``drive`` (warmup, one untimed step, the timed
    steps), then one more step for the host's enqueue time (the pool's
    ``total_dispatch_s``) and one profiled for the device's busy time and
    its device-to-device copies (each wave's population written into the
    static parent, the replays' outputs copied out)."""
    from repro_torch.core import StrategyRunner

    runner = StrategyRunner(make(), agg, device=levels(u0)[0].device)
    u, row = drive(runner, u0, row_dts, counters)
    exe = runner.executor
    d0 = runner.pool.total_dispatch_s
    nxt = runner.rk3_step(u, row_dts[-1])
    sync()
    row["dispatch_ms_per_step"] = (runner.pool.total_dispatch_s - d0) * 1e3
    _, prof = profiled(lambda: runner.rk3_step(nxt, row_dts[-1]))
    events = device_events(prof)
    row["busy_ms_per_step"] = sum(us for _, us in events) / 1e3
    row["dtod_us_per_step"] = sum(us for name, us in events
                                  if "Memcpy DtoD" in name)
    row["captures"] = exe.stats["captures"] if exe is not None else 0
    row["graph_mib"] = (exe.stats["graph_bytes"] / 2 ** 20
                        if exe is not None else 0.0)
    del runner, prof
    return u, row


def phase_bucket_graphs(cfg, cfg16, gcfg, acfg, dev, card, dts, results):
    """The reference's compiled bucket programs as CUDA graphs: for each
    row of ``bucket_graph_rows`` and for 4 tenants under ``s4``, the run
    with the programs as graphs and the same run with the eager programs
    (``eager_programs``) in this process.  Every row: the graph run equals
    the eager run and ``fused`` (the fused stage reference for the fused
    stages) bit for bit; in the timed steps no wrapper launches its kernel
    (every bucket launch is a replay), and the replays' kernel nodes,
    counted from the graphs, equal the eager run's wrapper launches,
    kernel by kernel.  Prints the captures, the graphs' memory, the
    device-to-device copies' device us per step, and host ms, enqueue ms
    and busy ms per step, graphs against eager."""
    from repro_torch.configs.base import AggregationConfig
    from repro_torch.core import StrategyRunner, UniformSedovScenario
    from repro_torch.hydro.state import sedov_init
    from repro_torch.kernels import hydro_rhs as kern

    t_phase = time.perf_counter()
    table = {}
    for label, make, u0, row_dts, kw, counters in bucket_graph_rows(
            cfg, cfg16, gcfg, acfg, dev, dts):
        steps = len(row_dts)
        ref_kw = dict(strategy="fused",
                      fuse_epilogue=kw.get("fuse_epilogue", False))
        ref, _ = drive(StrategyRunner(make(), AggregationConfig(**ref_kw),
                                      device=dev), u0, row_dts, counters)
        agg = AggregationConfig(**kw)
        u, row = graph_row(make, u0, row_dts, agg, counters)
        with eager_programs():
            ue, eager = graph_row(make, u0, row_dts, agg, counters)
        check(states_equal(u, ref) and states_equal(ue, ref),
              f"bucket graphs {label}: not bit-identical to fused")
        check(all(v == 0 for v in row["eager_launches"].values()),
              f"bucket graphs {label}: a wrapper launched outside a capture "
              f"in the timed steps {row['eager_launches']}: not every "
              f"bucket launch was a replay")
        # the replays' kernel nodes against the eager launches of the same
        # bucket launches: where the drain's decomposition depends on when
        # an executor is idle (host staging's per-task queue), the two runs
        # launch different buckets, and each bucket launch is held to the
        # eager run's kernels per bucket launch
        same = row["bucket_hists"] == eager["bucket_hists"]
        want = (eager["kernel_launches"] if same else {
            k: v * row["launches_per_step"] / eager["launches_per_step"]
            for k, v in eager["kernel_launches"].items()})
        check(row["kernel_launches"] == want
              and all(v > 0 for v in row["kernel_launches"].values()),
              f"bucket graphs {label}: replayed kernel nodes "
              f"{row['kernel_launches']}, eager launches "
              f"{eager['kernel_launches']} ({row['launches_per_step']} and "
              f"{eager['launches_per_step']} bucket launches per step)")
        check(row["captures"] > 0 and eager["captures"] == 0,
              f"bucket graphs {label}: captures {row['captures']}, eager "
              f"{eager['captures']}")
        print(f"bucket graphs ({card}): {label}, {steps} step(s): graphs "
              f"{row['ms_per_step']:.3f} host ms/step (enqueue "
              f"{row['dispatch_ms_per_step']:.3f}, busy "
              f"{row['busy_ms_per_step']:.3f}, device-to-device copies "
              f"{row['dtod_us_per_step']:.1f} us), eager "
              f"{eager['ms_per_step']:.3f} (enqueue "
              f"{eager['dispatch_ms_per_step']:.3f}, busy "
              f"{eager['busy_ms_per_step']:.3f}, copies "
              f"{eager['dtod_us_per_step']:.1f} us); "
              f"{row['launches_per_step']:g} bucket launches/step, kernel "
              f"nodes replayed {row['kernel_launches']} = eager launches; "
              f"{row['captures']} captures, graphs "
              f"{row['graph_mib']:.1f} MiB; peak {row['peak_mib']:.1f} MiB "
              f"(eager {eager['peak_mib']:.1f}); bit-equal to fused",
              flush=True)
        table[label] = dict(graphs=row, eager=eager)

    # what the graphs add on the device: a population copied into its
    # region's static parent (one device copy; the main path's is written
    # there in place, a second family reading it, as gravity's, copies
    # it), and a cap-32 bucket's output copied out of its graph
    u0 = sedov_init(cfg, device=dev).u
    (pop,) = UniformSedovScenario(cfg).populations(u0)
    subs = pop.parents[0]
    static = torch.empty_like(subs)
    out32 = UniformSedovScenario(cfg).family("hydro_rhs").batched_body(
        subs[:32])
    copies = dict(
        population_us=time_graph_ms(lambda: static.copy_(subs), 20) * 1e3,
        population_bytes=subs.numel() * subs.element_size(),
        output_us=time_graph_ms(out32.clone, 50) * 1e3,
        output_bytes=out32.numel() * out32.element_size())
    print(f"bucket graphs ({card}): a wave's population written into its "
          f"static parent ({copies['population_bytes'] / 1e6:.1f} MB, one "
          f"device copy): {copies['population_us']:.2f} us; a cap-32 "
          f"bucket's output copied out of its graph "
          f"({copies['output_bytes'] / 1e3:.1f} KB): "
          f"{copies['output_us']:.2f} us (graph replays)", flush=True)
    del static, out32

    # s4: 4 tenants of the main path, the whole drain one graph per family
    dt = dts[0]
    want = u0
    fused = StrategyRunner(UniformSedovScenario(cfg), AggregationConfig(
        strategy="fused"), device=dev)
    for _ in range(TENANT_STEPS):
        want = fused.rk3_step(want, dt)
    tenants = {}
    for mode in ("graphs", "eager"):
        with (eager_programs() if mode == "eager"
              else contextlib.nullcontext()):
            tb = tenant_batcher(dev, 32, 4, lambda: UniformSedovScenario(cfg),
                                u0, dt)
            tb.rk3_step_all()
            sync()
            zero_launch_counts()
            d0 = tb.executor.pool.total_dispatch_s
            t0 = time.perf_counter()
            for _ in range(TENANT_STEPS - 1):
                out = tb.rk3_step_all()
            sync()
            ms = (time.perf_counter() - t0) / (TENANT_STEPS - 1) * 1e3
            launches = kernel_launches(kern.hydro_rhs_cuda)
            own = eager_launches(kern.hydro_rhs_cuda)
            disp = (tb.executor.pool.total_dispatch_s - d0) / (
                TENANT_STEPS - 1) * 1e3
            _, prof = profiled(tb.rk3_step_all)
            events = device_events(prof)
            for tid in range(4):
                check(torch.equal(out[tid], want),
                      f"bucket graphs s4 {mode}: tenant {tid} differs from "
                      f"fused")
            tenants[mode] = dict(
                host_ms_per_step=ms, dispatch_ms_per_step=disp,
                kernel_launches=launches, eager_launches=own,
                busy_ms_per_step=sum(us for _, us in events) / 1e3,
                dtod_us_per_step=sum(us for name, us in events
                                     if "Memcpy DtoD" in name),
                captures=tb.executor.stats["captures"],
                graph_mib=tb.executor.stats["graph_bytes"] / 2 ** 20,
                keys=sorted(str(k[:2]) for r in tb.executor.regions.values()
                            for k in r.compiled))
            del tb, prof
    g, e = tenants["graphs"], tenants["eager"]
    check(g["eager_launches"] == 0 and g["kernel_launches"]
          == e["kernel_launches"] > 0,
          f"bucket graphs s4: replayed {g['kernel_launches']} (wrapper "
          f"{g['eager_launches']}), eager {e['kernel_launches']}")
    print(f"bucket graphs ({card}): s4, 4 tenants of {cfg.name}, cap 32: "
          f"graphs {g['host_ms_per_step']:.3f} host ms/step (enqueue "
          f"{g['dispatch_ms_per_step']:.3f}, busy {g['busy_ms_per_step']:.3f}"
          f", copies {g['dtod_us_per_step']:.1f} us), eager "
          f"{e['host_ms_per_step']:.3f} (enqueue "
          f"{e['dispatch_ms_per_step']:.3f}, busy {e['busy_ms_per_step']:.3f}"
          f"); programs {g['keys']}, {g['captures']} captures, graphs "
          f"{g['graph_mib']:.1f} MiB; kernel nodes replayed "
          f"{g['kernel_launches']} = eager launches over "
          f"{TENANT_STEPS - 1} steps; every tenant bit-equal to fused",
          flush=True)
    seconds = time.perf_counter() - t_phase
    print(f"bucket graphs: phase {seconds:.1f} s", flush=True)
    results["bucket_graphs"] = dict(card=card, runs=table, s4=tenants,
                                    copies=copies, seconds=seconds)


# ---------------------------------------------------------------------------
# measured tuning and per-family routing
# ---------------------------------------------------------------------------

def tuning_rows(cfg, gcfg, acfg_mixed):
    """(path, label, config) of the tuning phase: on the main path ``s3``
    cap 32 before and after the tuned rows (in turn: baseline, tuned,
    tuned, baseline), the tuned ``s3`` rows under the ``cost`` and
    ``watermark`` flush policies, ``s2`` at its measured width; ``mixed``
    on Path A, routed explicitly and by measurement; ``mixed`` on Path C
    (``CONFIG_MIXED``, both families on the slot_grid kernel) by
    measurement."""
    from repro_torch.configs.base import AggregationConfig

    tuned = dict(autotune=True, cost_model=True)
    return (
        ("main", "s3 cap 32 (a)", AggregationConfig(strategy="s3",
                                                    max_aggregated=32)),
        ("main", "s3 tuned, flush cost, chunk auto", AggregationConfig(
            strategy="s3", max_aggregated=32, flush_policy="cost",
            inner_chunk="auto", **tuned)),
        ("main", "s3 tuned, flush watermark", AggregationConfig(
            strategy="s3", max_aggregated=32, flush_policy="watermark",
            **tuned)),
        ("main", "s3 cap 32 (b)", AggregationConfig(strategy="s3",
                                                    max_aggregated=32)),
        ("main", "s2 measured width, 4 streams", AggregationConfig(
            strategy="s2", n_executors=4, cost_model=True)),
        ("A", "mixed hydro s3, gravity fused", AggregationConfig(
            strategy="mixed", max_aggregated=32,
            family_strategies={"hydro_rhs": "s3", "gravity": "fused"},
            **tuned)),
        ("A", "mixed auto", AggregationConfig(strategy="mixed",
                                              max_aggregated=32, **tuned)),
        ("C", "mixed auto", AggregationConfig(strategy="mixed",
                                              max_aggregated=16, **tuned)),
    )


def phase_tuning(cfg, gcfg, acfg_mixed, dev, card, dts, fused_main, results):
    """Measured tuning and routing on the card, each row a runner through
    ``drive`` (warmup, which times the buckets; one untimed step, in which
    the autotuned rows retune after 2 waves; then the timed steps) and one
    more step under ``torch.profiler`` for the device busy time: every row
    bit-identical to ``fused`` on its path, its kernels launched; the
    autotuned ``s3`` rows launch the greedy decomposition of each wave
    under their derived ladder.  Each row prints its ladder, cost table in
    ms per bucket, routes, flush decisions, launches and host ms per
    step."""
    from repro_torch.configs.base import AggregationConfig
    from repro_torch.core import (
        AMRSedovScenario, GravityScenario, StrategyRunner,
        UniformSedovScenario,
    )
    from repro_torch.core.aggregation import greedy_decomposition
    from repro_torch.hydro.state import amr_sedov_init, sedov_init
    from repro_torch.hydro.stepper import amr_courant_dt, courant_dt
    from repro_torch.kernels import gravity as grav
    from repro_torch.kernels import hydro_rhs as kern

    u0 = sedov_init(cfg, device=dev).u
    st = amr_sedov_init(acfg_mixed, device=dev)
    paths = {
        "main": (lambda: UniformSedovScenario(cfg), u0, dts,
                 (kern.hydro_rhs_cuda,)),
        "A": (lambda: GravityScenario(gcfg), u0, [courant_dt(u0, cfg)],
              (kern.hydro_rhs_cuda, grav.gravity_cuda)),
        "C": (lambda: AMRSedovScenario(acfg_mixed), (st.uc, st.uf),
              [amr_courant_dt(st.uc, st.uf, acfg_mixed)],
              (kern.hydro_rhs_cuda,)),
    }
    fused = {"main": fused_main}
    for key in ("A", "C"):
        make, state, path_dts, counters = paths[key]
        fused[key], _ = drive(StrategyRunner(make(), AggregationConfig(
            strategy="fused"), device=dev), state, path_dts, counters)
    table = {}
    for key, label, agg in tuning_rows(cfg, gcfg, acfg_mixed):
        make, state, path_dts, counters = paths[key]
        runner = StrategyRunner(make(), agg, device=dev)
        u, row = drive(runner, state, path_dts, counters)
        check(states_equal(u, fused[key]),
              f"tuning {key} {label} is not bit-identical to fused")
        for c in counters:
            check(row["kernel_launches"][c.__name__] > 0,
                  f"tuning {key} {label}: {c.__name__} never launched")
        _, prof = profiled(lambda: runner.rk3_step(state, path_dts[0]))
        row["device_busy_ms_per_step"] = sum(
            us for _, us in device_events(prof)) / 1e3
        fams = {}
        for desc, fst in runner.stats["regions"].items():
            fams[desc] = {k: fst.get(k) for k in (
                "ladder", "cost_model", "cost_model_paths",
                "selected_strategy", "strategy_costs", "flush_decisions",
                "inner_chunk", "s2_width", "tuned_by", "queue_hist",
                "measurement_launches")}
            if agg.autotune and agg.strategy == "s3":
                wave = max(fst["queue_hist"])
                chunk = fst.get("inner_chunk") or 0
                want = {}
                for b in greedy_decomposition(wave, fst["ladder"]):
                    want[b] = want.get(b, 0) + 3 * len(path_dts)
                check(row["bucket_hists"][desc] == want,
                      f"tuning {label}: buckets {row['bucket_hists'][desc]},"
                      f" want the greedy decomposition {want} of the "
                      f"{wave}-task wave under {fst['ladder']}")
                per = sum(c * (b // chunk if chunk and chunk < b
                               and b % chunk == 0 else 1)
                          for b, c in want.items())
                check(row["kernel_launches"]["hydro_rhs_cuda"] == per,
                      f"tuning {label}: {row['kernel_launches']} kernel "
                      f"launches, want {per} (inner chunk {chunk})")
        row["families"] = fams
        table[f"{key}: {label}"] = row
        print(f"tuning ({card}): {key} {label}: {row['ms_per_step']:.3f} "
              f"ms/step (host), device busy "
              f"{row['device_busy_ms_per_step']:.3f} ms/step, "
              f"{row['launches_per_step']:g} launches/step, kernel launches "
              f"{row['kernel_launches']}, bit-identical to fused", flush=True)
        for desc, fst in fams.items():
            print(f"  {desc}: route {fst['selected_strategy']}, ladder "
                  f"{fst['ladder']} ({fst['tuned_by'] or 'config'}), cost "
                  f"ms per bucket {fst['cost_model_paths'] or fst['cost_model']},"
                  f" strategy costs ms/wave {fst['strategy_costs']}, flush "
                  f"decisions {fst['flush_decisions']}, inner chunk "
                  f"{fst['inner_chunk']}, s2 width {fst['s2_width']}, "
                  f"measurement launches {fst['measurement_launches']}",
                  flush=True)
    results["tuning"] = dict(card=card, runs=table)
    return table


# ---------------------------------------------------------------------------
# the whole-trajectory CUDA graph, crash-consistent resume, the captured AMR
# exchange
# ---------------------------------------------------------------------------

TRAJ_STEPS = 3
# per s2 launch on an executor stream, ~1 ms: s2 launches 1,024 times per
# stage on Path C, so its streams fall ~130 ms behind the host per stage
S2_SLEEP_CYCLES = 2_000_000
# each kernel wrapper's device kernel, as its function name reads in a
# CUDA graph's kernel nodes and in torch.profiler's records
DEVICE_KERNELS = {"hydro_rhs_cuda": "hydro_rhs_cluster_kernel",
                  "hydro_rhs_lane_cuda": "hydro_rhs_lane_kernel",
                  "hydro_reconstruct_cuda": "reconstruct_kernel",
                  "hydro_flux_cuda": "flux_cluster_kernel",
                  "gravity_cuda": "gravity_kernel",
                  "decode_attention_cuda": "decode_chunk_kernel",
                  "grouped_gemm_cuda": "grouped_gemm_kernel"}


def cuda_wrappers():
    """Every CUDA kernel wrapper; each counts its launches in
    ``.launches``."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import gravity as grav
    from repro_torch.kernels import grouped_gemm as gg
    from repro_torch.kernels import hydro_rhs as kern
    from repro_torch.kernels import hydro_split as split

    return (kern.hydro_rhs_cuda, kern.hydro_rhs_lane_cuda,
            split.hydro_reconstruct_cuda, split.hydro_flux_cuda,
            grav.gravity_cuda, da.decode_attention_cuda,
            gg.grouped_gemm_cuda)


def eager_launches(wrapper):
    """A wrapper's own launches outside bucket-program captures: its count
    less what it counted at captures (a capture's warm call and its
    recording, ``graphs.captured_kernels``)."""
    from repro_torch.core import graphs

    name = DEVICE_KERNELS[wrapper.__name__]
    return wrapper.launches - sum(
        c for k, c in graphs.captured_kernels().items() if name in k)


def kernel_launches(wrapper):
    """A wrapper's kernel's launches on the path: its eager launches plus
    the bucket-program replays' kernel nodes of its kernel
    (``graphs.replayed_kernels``: a replay launches its graph's nodes, not
    the wrapper)."""
    from repro_torch.core import graphs

    name = DEVICE_KERNELS[wrapper.__name__]
    return eager_launches(wrapper) + sum(
        c for k, c in graphs.replayed_kernels().items() if name in k)


def zero_launch_counts():
    from repro_torch.core import graphs

    for f in cuda_wrappers():
        f.launches = 0
    graphs.reset_replayed_kernels()


def nonzero_launch_counts():
    counts = {f.__name__: kernel_launches(f) for f in cuda_wrappers()}
    return {k: v for k, v in counts.items() if v}


def device_events(prof):
    """(name, device us) of every kernel, copy and fill the trace holds."""
    out = []
    for e in prof.events():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            out.append((e.name, float(e.device_time_total)))
    return out


def device_busy_ms(prof):
    """Device ms of every kernel, copy and fill the trace holds, summed
    from the profiler's raw events (building its function events costs
    seconds per 10^5 kernels)."""
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA) / 1e6


def kernels_by_wrapper(names, wrappers):
    """How many of the kernel ``names`` are each wrapper's device kernel
    (``DEVICE_KERNELS``)."""
    return {w: sum(1 for name in names if DEVICE_KERNELS[w] in name)
            for w in wrappers}


def profiled(fn, activities=("CPU", "CUDA")):
    """``fn()`` under ``torch.profiler`` (CPU and CUDA, or the
    ``activities`` named), synchronised; returns (fn's result, the
    profile)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[getattr(ProfilerActivity, a)
                             for a in activities]) as prof:
        out = fn()
        sync()
    return out, prof


def host_ms(fn, steps, reps=3):
    """Best of ``reps`` host-clock times of ``fn()`` (synchronised before
    and after), per step."""
    best = None
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        t = (time.perf_counter() - t0) * 1e3 / steps
        best = t if best is None else min(best, t)
    return best


def trajectory_paths(cfg, cfg16, gravity_512, gravity_64, acfg, dev):
    """(label, scenario factory, initial state, dt, launches per RK stage
    by wrapper) for the main path and Paths A-D at full width."""
    import functools

    from repro_torch.core import (
        AMRSedovScenario, GravityScenario, UniformSedovScenario,
    )
    from repro_torch.hydro.state import amr_sedov_init, sedov_init
    from repro_torch.hydro.stepper import amr_courant_dt, courant_dt
    from repro_torch.kernels import ops

    u0 = sedov_init(cfg, device=dev).u
    dt = courant_dt(u0, cfg)
    h = cfg.domain / u0.shape[-1]
    u16 = sedov_init(cfg16, device=dev).u
    h16 = cfg16.domain / u16.shape[-1]
    g64 = sedov_init(gravity_64.hydro, device=dev).u
    st = amr_sedov_init(acfg, device=dev)
    amr, amr_dt = (st.uc, st.uf), amr_courant_dt(st.uc, st.uf, acfg)
    paths = [
        ("main path", lambda: UniformSedovScenario(cfg), u0, dt,
         {"hydro_rhs_cuda": 1}),
        ("Path A (gravity, 512 x 8^3)", lambda: GravityScenario(gravity_512),
         u0, dt, {"hydro_rhs_cuda": 1, "gravity_cuda": 1}),
        ("Path A (configs/gravity.CONFIG)",
         lambda: GravityScenario(gravity_64), g64,
         courant_dt(g64, gravity_64.hydro),
         {"hydro_rhs_cuda": 1, "gravity_cuda": 1}),
        ("Path B (split pair)", lambda: UniformSedovScenario(
            cfg, batched_body=ops.hydro_split_batched_body(cfg, h)), u0, dt,
         {"hydro_reconstruct_cuda": 1, "hydro_flux_cuda": 1}),
    ]
    for layout, wrapper in (("slot_grid", "hydro_rhs_cuda"),
                            ("slot_lane", "hydro_rhs_lane_cuda")):
        paths.append((f"Path C ({acfg.name}, {layout})",
                      lambda layout=layout: AMRSedovScenario(
                          acfg, hydro_body=functools.partial(
                              ops.level_batched_body, acfg.gamma, acfg.ghost,
                              layout=layout)), amr, amr_dt, {wrapper: 2}))
    for c, u, hh in ((cfg, u0, h), (cfg16, u16, h16)):
        paths.append((
            f"Path D (lane, {c.n_subgrids} x {c.subgrid}^3)",
            lambda c=c, hh=hh: UniformSedovScenario(
                c, batched_body=ops.hydro_batched_body(c, hh,
                                                       layout="slot_lane")),
            u, dt if c is cfg else courant_dt(u16, cfg16),
            {"hydro_rhs_lane_cuda": 1}))
    return paths


def clone_state(state):
    return tuple(u.clone() for u in state) if isinstance(state, tuple) \
        else state.clone()


def phase_trajectory(paths, dev, card, results):
    """``rk3_trajectory`` under ``fused`` on each path: ONE CUDA graph per
    trajectory, bit-equal to the ``rk3_step`` loop at two dts with no
    second capture; the caller's state and an earlier result unchanged by
    a later call; an eager step after the capture equal to a fresh
    runner's; the captured graph's kernel nodes (read from the graph
    itself, ``CapturedCall.kernel_names``) equal to 3 x steps x the path's
    launches per stage; host ms/step against the loop, device busy and
    device ops per step from ``torch.profiler`` (a replay whose profiled
    kernels differ from the graph's nodes is printed as a note: the
    profiler has dropped records of a replay before) and peak memory."""
    from repro_torch.configs.base import AggregationConfig
    from repro_torch.core import StrategyRunner

    fused = AggregationConfig(strategy="fused")
    n = TRAJ_STEPS
    table = {}
    for label, make, u0, dt, per_stage in paths:
        def loop(runner, d, u=u0):
            for _ in range(n):
                u = runner.rk3_step(u, d)
            return u
        ref = StrategyRunner(make(), fused, device=dev)
        ref.warmup()
        dt2 = dt * 0.5
        want, want2 = loop(ref, dt), loop(ref, dt2)
        before = clone_state(u0)
        runner = StrategyRunner(make(), fused, device=dev)
        runner.warmup()
        sync()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        zero_launch_counts()
        t0 = time.perf_counter()
        got = runner.rk3_trajectory(u0, dt, n)
        sync()
        capture_s = time.perf_counter() - t0
        counted = nonzero_launch_counts()
        peak_mib = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 20
        # what one replay launches: the captured graph's own kernel nodes
        want_launches = {k: 3 * n * v for k, v in per_stage.items()}
        (graph,) = runner.trajectory_graphs.values()
        node_names = graph.kernel_names()
        in_graph = kernels_by_wrapper(node_names, want_launches)
        check(in_graph == want_launches,
              f"trajectory {label}: the captured graph holds {in_graph} "
              f"kernel nodes, want {want_launches}")
        # the wrappers count the warm step (one RK3 step) and the capture
        check(counted == {k: 3 * (n + 1) * v for k, v in per_stage.items()},
              f"trajectory {label}: the wrappers counted {counted} over the "
              f"warm step and the capture")
        check(states_equal(got, want), f"trajectory {label}: {n} steps in "
              f"one graph differ from the rk3_step loop")
        got2 = runner.rk3_trajectory(u0, dt2, n)
        check(states_equal(got2, want2), f"trajectory {label}: the graph "
              f"at a second dt differs from its loop")
        check(len(runner.trajectory_graphs) == 1,
              f"trajectory {label}: {len(runner.trajectory_graphs)} graphs "
              f"for one shape")
        check(runner.stats["kernel_launches"] == 2
              and runner.stats["iterations"] == 6 * n,
              f"trajectory {label}: stats {runner.stats}")
        check(states_equal(u0, before) and states_equal(got, want),
              f"trajectory {label}: a replay changed the caller's state or "
              f"an earlier result")
        fresh = StrategyRunner(make(), fused, device=dev)
        check(states_equal(runner.rk3_step(u0, dt), fresh.rk3_step(u0, dt)),
              f"trajectory {label}: an eager step after the capture differs "
              f"from a fresh runner's (a cache made during the capture?)")
        _, prof = profiled(lambda: runner.rk3_trajectory(u0, dt, n))
        events = device_events(prof)
        by_kernel = kernels_by_wrapper([name for name, _ in events],
                                       want_launches)
        if by_kernel != in_graph:
            print(f"trajectory ({card}): {label}: note: torch.profiler "
                  f"recorded {by_kernel} kernels of one replay, the graph "
                  f"holds {in_graph} kernel nodes", flush=True)
        _, prof_loop = profiled(lambda: loop(ref, dt))
        loop_events = device_events(prof_loop)
        row = dict(
            capture_s=capture_s, peak_mib=peak_mib,
            launches_per_replay=in_graph, graph_kernel_nodes=len(node_names),
            profiled_launches_per_replay=by_kernel,
            device_ops_per_step=len(events) / n,
            loop_device_ops_per_step=len(loop_events) / n,
            device_busy_ms_per_step=sum(us for _, us in events) / 1e3 / n,
            loop_device_busy_ms_per_step=sum(
                us for _, us in loop_events) / 1e3 / n,
            ms_per_step=host_ms(lambda: runner.rk3_trajectory(u0, dt, n), n),
            loop_ms_per_step=host_ms(lambda: loop(ref, dt), n))
        print(f"trajectory ({card}): {label}, {n} steps as one CUDA graph: "
              f"bit-equal to the rk3_step loop at two dts, one capture "
              f"({capture_s:.2f} s, peak {peak_mib:.1f} MiB over the "
              f"state), the caller's state kept, an eager step after it "
              f"equal to a fresh runner's; one replay: "
              f"{row['launches_per_replay']} kernel launches of the "
              f"{len(node_names)} kernel nodes in the graph (the wrappers "
              f"counted {counted} at the warm step and the capture), "
              f"{row['device_ops_per_step']:g} device ops/step (loop "
              f"{row['loop_device_ops_per_step']:g}), device busy "
              f"{row['device_busy_ms_per_step']:.3f} ms/step (loop "
              f"{row['loop_device_busy_ms_per_step']:.3f}); host "
              f"{row['ms_per_step']:.3f} ms/step against the loop's "
              f"{row['loop_ms_per_step']:.3f} (synchronised, best of 3)",
              flush=True)
        table[label] = row
        del runner, ref, fresh
    results["trajectory"] = dict(card=card, steps=n, runs=table)
    return table


# a child process that runs the main path under s3 cap 32 with a checkpoint
# after every step and kills itself (SIGKILL, no clean-up) after checkpoint
# 2; argv: checkpoint directory
RESUME_CHILD = """
import os, signal, sys
import torch
from repro_torch.configs.base import AggregationConfig
from repro_torch.configs.sedov import CONFIG
from repro_torch.core import StrategyRunner, UniformSedovScenario
from repro_torch.hydro.state import sedov_init
from repro_torch.hydro.stepper import courant_dt

u0 = sedov_init(CONFIG, device="cuda").u
runner = StrategyRunner(UniformSedovScenario(CONFIG), AggregationConfig(
    strategy="s3", max_aggregated=32), device="cuda")
runner.warmup()
save = runner._checkpoint


def save_then_die(ckpt_dir, step, *args):
    save(ckpt_dir, step, *args)
    if step == 2:
        os.kill(os.getpid(), signal.SIGKILL)


runner._checkpoint = save_then_die
runner.run(u0, courant_dt(u0, CONFIG), 4, checkpoint_every=1,
           ckpt_dir=sys.argv[1])
"""


class Crash(Exception):
    pass


def run_child(script, args, timeout=300):
    """``python -c script *args`` with the checkout's ``src`` first on the
    path; returns the completed process."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    return subprocess.run([sys.executable, "-c", script, *args], env=env,
                          capture_output=True, text=True, timeout=timeout)


def phase_resume(cfg, acfg, dev, card, results):
    """A child process runs the main path under ``s3`` cap 32 for 4 steps
    with a checkpoint after each and dies by SIGKILL after checkpoint 2;
    the parent resumes and must equal an uninterrupted run bit for bit.
    Then the same in one process for the AMR ``(uc, uf)`` state under
    ``s2+s3`` (the run stopped by an exception after checkpoint 2)."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import latest_step
    from repro_torch.configs.base import AggregationConfig
    from repro_torch.core import (
        AMRSedovScenario, StrategyRunner, UniformSedovScenario,
    )
    from repro_torch.hydro.state import amr_sedov_init, sedov_init
    from repro_torch.hydro.stepper import amr_courant_dt, courant_dt

    work = tempfile.mkdtemp(prefix="chip_smoke_resume_", dir=HERE)
    try:
        ckpt = os.path.join(work, "main")
        t0 = time.perf_counter()
        child = run_child(RESUME_CHILD, [ckpt])
        child_s = time.perf_counter() - t0
        check(child.returncode == -9, f"resume: the child exited "
              f"{child.returncode}, not by SIGKILL:\n{child.stderr[-2000:]}")
        check(latest_step(ckpt) == 2,
              f"resume: latest checkpoint {latest_step(ckpt)}, want 2")
        agg = AggregationConfig(strategy="s3", max_aggregated=32)
        u0 = sedov_init(cfg, device=dev).u
        whole = StrategyRunner(UniformSedovScenario(cfg), agg, device=dev)
        whole.warmup()
        want = whole.run(u0, courant_dt(u0, cfg), 4)
        runner = StrategyRunner(UniformSedovScenario(cfg), agg, device=dev)
        zero_launch_counts()
        got = runner.resume(ckpt, u0)
        sync()
        counted = nonzero_launch_counts()
        check(torch.equal(got, want), "resume: the main path resumed after "
              "SIGKILL differs from an uninterrupted run")
        # warmup's bucket ladder, then 2 steps of 3 x 16 buckets of 32
        check(counted.get("hydro_rhs_cuda", 0) >= 2 * 3 * 16
              and set(counted) == {"hydro_rhs_cuda"},
              f"resume: kernel launches {counted}")
        check(runner.stats["resumed_from_step"] == 2
              and runner.stats["recovery_steps"] == 2,
              f"resume: stats {runner.stats}")
        check(latest_step(ckpt) == 4, "resume: no checkpoint of step 4")
        print(f"resume ({card}): main path, s3 cap 32, 4 steps, a "
              f"checkpoint each: the child died by SIGKILL after checkpoint "
              f"2 ({child_s:.1f} s); resumed from step 2 (2 recovery "
              f"steps), bit-identical to an uninterrupted run", flush=True)

        st = amr_sedov_init(acfg, device=dev)
        amr0 = (st.uc, st.uf)
        dt = amr_courant_dt(st.uc, st.uf, acfg)
        agg = AggregationConfig(strategy="s2+s3", n_executors=4,
                                max_aggregated=32)
        want = StrategyRunner(AMRSedovScenario(acfg), agg,
                              device=dev).run(amr0, dt, 3)
        ckpt = os.path.join(work, "amr")
        crashing = StrategyRunner(AMRSedovScenario(acfg), agg, device=dev)
        save = crashing._checkpoint

        def save_then_crash(ckpt_dir, step, *args):
            save(ckpt_dir, step, *args)
            if step == 2:
                raise Crash
        crashing._checkpoint = save_then_crash
        try:
            crashing.run(amr0, dt, 3, checkpoint_every=1, ckpt_dir=ckpt)
            check(False, "resume: the AMR run did not stop")
        except Crash:
            pass
        runner = StrategyRunner(AMRSedovScenario(acfg), agg, device=dev)
        got = runner.resume(ckpt, amr0)
        check(states_equal(got, want), "resume: the AMR (uc, uf) run "
              "resumed from step 2 differs from an uninterrupted run")
        check(runner.stats["resumed_from_step"] == 2
              and runner.stats["recovery_steps"] == 1,
              f"resume: AMR stats {runner.stats}")
        print(f"resume ({card}): Path C ({acfg.name}), s2+s3 4 x 32, 3 "
              f"steps, stopped after checkpoint 2: resumed (uc, uf) "
              f"bit-identical to an uninterrupted run", flush=True)
        results["resume"] = dict(card=card, child_s=child_s)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def exchange_ops(scenario, state):
    """Host ops (top-level aten calls) and device ops in one exchange."""
    _, prof = profiled(lambda: scenario.exchange(*state))
    host = [e for e in prof.events()
            if e.name.startswith("aten::") and e.cpu_parent is None]
    return len(host), len(device_events(prof))


def phase_amr_exchange(acfg, dev, card, results):
    """Path C (slot_grid) at cap 32 under ``s3``, ``s2+s3``, ``s2``, host
    staging and the fused stages, each executor stream's launches delayed
    by ``torch.cuda._sleep``: the captured exchange (its graph's outputs
    overwritten at every stage) bit-equal to the eager one.  An exchange's
    result read on a delayed stream survives the next exchange's replay,
    which nothing orders after that read.  Then the ops of one exchange,
    and host ms/step undelayed, captured against eager."""
    from repro_torch.configs.base import AggregationConfig
    from repro_torch.core import AMRSedovScenario, StrategyRunner
    from repro_torch.core.executor import DeviceExecutor
    from repro_torch.hydro.state import amr_sedov_init
    from repro_torch.hydro.stepper import amr_courant_dt
    from repro_torch.kernels import ops

    st = amr_sedov_init(acfg, device=dev)
    state = (st.uc, st.uf)
    dt = amr_courant_dt(st.uc, st.uf, acfg)

    def make(capture, cycles=None):
        def body(s):
            b = ops.level_batched_body(acfg.gamma, acfg.ghost, s)
            if cycles is None:
                return b

            def slow(*args, out=None):
                torch.cuda._sleep(cycles)
                return b(*args, out=out)
            return slow
        sc = AMRSedovScenario(acfg, hydro_body=body)
        if not capture:
            sc.exchange = sc._exchange_eager       # the eager reference
        return sc

    rows = (("s3 cap 32", dict(strategy="s3", max_aggregated=32), 2,
             SLEEP_CYCLES),
            ("s2+s3 4 streams cap 32", dict(strategy="s2+s3", n_executors=4,
                                            max_aggregated=32), 2,
             SLEEP_CYCLES),
            ("s2 4 streams", dict(strategy="s2", n_executors=4), 1,
             S2_SLEEP_CYCLES),
            ("s3 cap 32 host staging", dict(strategy="s3", max_aggregated=32,
                                            staging="host"), 2,
             SLEEP_CYCLES),
            ("s3 cap 32 fused stages", dict(strategy="s3", max_aggregated=32,
                                            fuse_epilogue=True), 2,
             SLEEP_CYCLES))
    table = {}
    for label, kw, steps, cycles in rows:
        outs = {}
        for capture in (True, False):
            sc = make(capture, cycles)
            runner = StrategyRunner(sc, AggregationConfig(**kw), device=dev)
            runner.warmup()
            u = state
            zero_launch_counts()
            t0 = time.perf_counter()
            for _ in range(steps):
                u = runner.rk3_step(u, dt)
            sync()
            outs[capture] = (u, (time.perf_counter() - t0) * 1e3 / steps)
            check(set(nonzero_launch_counts()) == {"hydro_rhs_cuda"},
                  f"amr_exchange {label}: kernel launches "
                  f"{nonzero_launch_counts()}")
            check(bool(sc.exchange_graphs) == capture,
                  f"amr_exchange {label}: capture {capture}, graphs "
                  f"{len(sc.exchange_graphs)}")
        check(states_equal(outs[True][0], outs[False][0]),
              f"amr_exchange {label}: the captured exchange differs from "
              f"the eager one with the executor streams delayed")
        print(f"amr_exchange ({card}): {acfg.name}, {label}, {steps} "
              f"step(s), each launch delayed {cycles} cycles: the captured "
              f"exchange equals the eager one bit for bit ({outs[True][1]:.1f}"
              f" / {outs[False][1]:.1f} ms/step delayed)", flush=True)
        table[label] = dict(steps=steps, sleep_cycles=cycles,
                            delayed_ms_per_step=outs[True][1],
                            eager_delayed_ms_per_step=outs[False][1])

    # a reader on an executor's stream, delayed, of the fine level's
    # exchanged sub-grids; the next exchange (another state) replays the
    # graph on this stream before that reader has run
    sc = make(True)
    first = sc.exchange(*state)
    reader = DeviceExecutor(0, dev)
    read = reader.run(lambda s: (torch.cuda._sleep(SLEEP_CYCLES),
                                 s.clone())[1], first[1])
    second = sc.exchange(2.0 * st.uc, 2.0 * st.uf)
    reader.join()
    want = sc._exchange_eager(*state)
    check(torch.equal(read, want[1]) and torch.equal(first[1], want[1])
          and not torch.equal(second[1], want[1]),
          "amr_exchange: an exchange's result read on a delayed stream was "
          "overwritten by the next exchange's replay")
    print(f"amr_exchange ({card}): {acfg.name}, an exchange's result read "
          f"on a stream delayed {SLEEP_CYCLES} cycles equals the eager "
          f"exchange after the next exchange replayed the graph", flush=True)
    del sc, first, second, read, want

    sc, eager = make(True), make(False)
    sc.exchange(*state)
    ops_captured, ops_eager = exchange_ops(sc, state), exchange_ops(eager,
                                                                    state)
    host = {}
    for label, kw in (("fused", dict(strategy="fused")),
                      ("s3 cap 32", dict(strategy="s3", max_aggregated=32)),
                      ("s2+s3 4 streams cap 32", dict(
                          strategy="s2+s3", n_executors=4,
                          max_aggregated=32))):
        for capture in (True, False):
            runner = StrategyRunner(make(capture), AggregationConfig(**kw),
                                    device=dev)
            runner.warmup()
            runner.rk3_step(state, dt)
            host[(label, capture)] = 1e3 * min(
                runner.time_step(state, dt, STEPS) for _ in range(3))
        print(f"amr_exchange ({card}): {acfg.name} slot_grid, {label}: "
              f"{host[(label, True)]:.3f} ms/step with the exchange "
              f"captured, {host[(label, False)]:.3f} eager (host, "
              f"synchronised, best of 3)", flush=True)
    print(f"amr_exchange ({card}): one exchange (one per RK stage): eager {ops_eager[0]} host ops and "
          f"{ops_eager[1]} device ops; captured {ops_captured[0]} host ops "
          f"and {ops_captured[1]} device ops", flush=True)
    results["amr_exchange"] = dict(
        card=card, delayed=table,
        exchange_ops=dict(eager=ops_eager, captured=ops_captured),
        host_ms_per_step={f"{k[0]} {'captured' if k[1] else 'eager'}": v
                          for k, v in host.items()})


# ---------------------------------------------------------------------------
# containment: the guard, bisection, degraded buckets, the watchdog, the
# circuit breakers, the executor-less tripwire and serving eviction
# ---------------------------------------------------------------------------

# the launch watchdog's budget in the real-stall check, and the stall: a
# torch.cuda._sleep of about 10 budgets at ~2 GHz
STALL_BUDGET_S = 0.02
STALL_CYCLES = 400_000_000
# gravity's breaker states on Path A: two faulted direct waves, then four
# mixed iterations (tests/test_torch_faults_mixed.py, BREAKER_SEQUENCE)
BREAKER_SEQUENCE = ["closed", "open", "open", "half_open", "closed",
                    "closed"]
CONTAIN_LAYERS = 4      # qwen2-moe-a2.7b depth in the serving eviction check


def recording(region, sizes):
    """Wrap a region's body so each launch's bucket size is appended to
    ``sizes``."""
    body = region.batched_fn

    def rec(*args, out=None):
        sizes.append(args[0].shape[0])
        return body(*args) if out is None else body(*args, out=out)
    region.batched_fn = rec


def counts(xs):
    out = {}
    for x in xs:
        out[x] = out.get(x, 0) + 1
    return dict(sorted(out.items()))


GUARD_ORDER = ("off", "both", "watchdog", "watchdog", "both", "off")
GUARD_KW = {"off": {}, "watchdog": dict(launch_timeout_s=1.0),
            "both": dict(guard="finite", launch_timeout_s=1.0)}


def contain_guard_cost(cfg, dev, card, dts, fused_main):
    """Check 1: the main path under s3 cap 32 and s2+s3 (4 streams, cap
    32), with the guard and the watchdog both on (``both``), the watchdog
    alone, and neither, in the order of ``GUARD_ORDER`` in one process:
    bit-equal to fused, host ms per step (best of 3 x 3 steps) and device
    busy per step (one profiled step)."""
    from repro_torch.configs.base import AggregationConfig
    from repro_torch.core import StrategyRunner, UniformSedovScenario
    from repro_torch.hydro.state import sedov_init
    from repro_torch.kernels import hydro_rhs as kern

    u0 = sedov_init(cfg, device=dev).u
    rows = {}
    for label, base in (("s3 cap 32", dict(strategy="s3", max_aggregated=32)),
                        ("s2+s3 4 streams cap 32", dict(
                            strategy="s2+s3", n_executors=4,
                            max_aggregated=32))):
        runs = []
        for guard in GUARD_ORDER:
            runner = StrategyRunner(UniformSedovScenario(cfg),
                                    AggregationConfig(**base,
                                                      **GUARD_KW[guard]),
                                    device=dev)
            u, row = drive(runner, u0, dts, (kern.hydro_rhs_cuda,))
            check(torch.equal(u, fused_main),
                  f"containment {label}, guard {guard}: not bit-identical "
                  f"to fused")
            check(row["kernel_launches"]["hydro_rhs_cuda"] > 0,
                  f"containment {label}: the kernel never launched")

            def steps(runner=runner):
                u = u0
                for dt in dts:
                    u = runner.rk3_step(u, dt)
            host = host_ms(steps, len(dts))
            _, prof = profiled(lambda: runner.rk3_step(u0, dts[0]))
            busy = sum(us for _, us in device_events(prof)) / 1e3
            faults = {d: dict(r["faults"]) for d, r in
                      runner.stats["regions"].items()}
            check(all(f["trips"] == 0 and f["timeouts"] == 0
                      for f in faults.values()),
                  f"containment {label}: a clean run tripped {faults}")
            runs.append(dict(guard=guard, host_ms_per_step=host,
                             device_busy_ms_per_step=busy,
                             launches_per_step=row["launches_per_step"]))
        rows[label] = runs
        print(f"containment ({card}): 1. main path {label}, {len(dts)} "
              f"steps, each row bit-identical to fused; rows "
              f"{'/'.join(GUARD_ORDER)} (both: guard=finite and "
              f"launch_timeout_s=1.0; watchdog: launch_timeout_s=1.0): host "
              f"ms/step (best of 3) "
              f"{[round(r['host_ms_per_step'], 4) for r in runs]}, device "
              f"busy ms/step "
              f"{[round(r['device_busy_ms_per_step'], 4) for r in runs]}, "
              f"{runs[0]['launches_per_step']:g} launches/step", flush=True)
    return rows


def contain_payload(cfg, dev, card):
    """Check 2: a payload NaN on task 17 of the main path's hydro wave
    (s3 cap 32, guard on): 17 fails, 10 bisection launches through the
    slot_grid kernel at buckets 16, 8, 4, 2 and 1, the survivors bit-equal
    to the fault-free kernel, and the runner names the sub-grid."""
    from repro_torch.configs.base import AggregationConfig
    from repro_torch.core import (
        FaultInjector, FaultSpec, StrategyRunner, TaskFailedError,
        UniformSedovScenario,
    )
    from repro_torch.hydro.state import sedov_init
    from repro_torch.kernels import hydro_rhs as kern

    u0 = sedov_init(cfg, device=dev).u
    spec = FaultSpec(site="payload", kernel="hydro_rhs", task=17, times=1)
    runner = StrategyRunner(UniformSedovScenario(cfg), AggregationConfig(
        strategy="s3", max_aggregated=32, guard="finite"), device=dev,
        fault_injector=FaultInjector([spec]))
    runner.warmup()
    exe = runner.executor
    (pop,) = runner.scenario.populations(u0)
    want = runner.scenario.family("hydro_rhs").batched_body(*pop.parents)
    region = next(iter(exe.regions.values()))
    sizes = []
    recording(region, sizes)        # the bisection's eager launches
    hist0 = dict(exe.stats["aggregated_hist"])
    zero_launch_counts()
    fut = pop.submit_to(exe)
    exe.flush()
    sync()
    launches = kernel_launches(kern.hydro_rhs_cuda)
    # the wave's bucket launches are replays of programs captured at
    # warmup, which run no Python: their sizes come from the histogram
    for b, c in exe.stats["aggregated_hist"].items():
        sizes += [b] * (c - hist0.get(b, 0))
    f = dict(exe.stats["regions"][region.signature.describe()]["faults"])
    check(fut.failed_indices() == [17],
          f"payload fault: failed {fut.failed_indices()}, want [17]")
    check(f["trips"] == 1 and f["bisection_launches"] == 10
          and f["failed_tasks"] == 1,
          f"payload fault: faults {f}, want 1 trip and 2*log2(32) = 10 "
          f"bisection launches")
    sizes = counts(sizes)
    check(sizes == {1: 2, 2: 2, 4: 2, 8: 2, 16: 2, 32: 16},
          f"payload fault: launch sizes {sizes}")
    check(launches == 26, f"payload fault: {launches} slot_grid kernel "
          f"launches, want 16 + 10")
    keep = [i for i in range(pop.n_tasks) if i != 17]
    got = torch.stack([fut.task_result(i) for i in keep])
    check(torch.equal(got, want[keep]),
          "payload fault: a survivor differs from the fault-free kernel")
    runner.set_fault_injector(FaultInjector([spec]))
    try:
        runner.rhs(u0)
        raise CheckFailed("payload fault: rhs did not raise")
    except TaskFailedError as err:
        msg = str(err)
    check(msg.startswith("task 17 of family 'hydro_rhs'"),
          f"payload fault: the error does not name the task: {msg}")
    print(f"containment ({card}): 2. payload NaN on task 17 of the main "
          f"path's 512-task hydro wave, s3 cap 32: failed [17], faults "
          f"{f}, body launches by size {sizes}, slot_grid kernel "
          f"launches {launches} (16 + 10), 511 survivors bit-equal to the "
          f"fault-free kernel; rhs raised: {msg[:120]}", flush=True)
    return dict(faults=f, sizes=sizes, kernel_launches=launches)


def contain_ring(cfg, dev, card):
    """Check 3: per-task ring staging on 4 delayed streams, 3 waves of 512
    sub-grids before one flush, a ring-site poison in wave 0 and a payload
    poison in wave 2; then a compaction between guarded launches and their
    audit: exactly the poisoned tasks fail, every survivor bit-equal to
    the fused kernel."""
    from repro_torch.configs.base import AggregationConfig
    from repro_torch.core import AggregationExecutor, FaultInjector, FaultSpec
    from repro_torch.hydro.state import extract_subgrids, sedov_init
    from repro_torch.kernels import hydro_rhs as kern
    from repro_torch.kernels import ops

    u0 = sedov_init(cfg, device=dev).u
    h = cfg.domain / u0.shape[-1]
    kw = dict(h=h, gamma=cfg.gamma, ghost=cfg.ghost, subgrid=cfg.subgrid)
    subs = extract_subgrids(u0, cfg.subgrid, cfg.ghost)
    want = kern.hydro_rhs_cuda(subs, **kw)
    n = subs.shape[0]
    out = {}
    # region wave r holds tasks [32 r, 32 r + 32): the ring poison lands on
    # task 37 (user wave 0), the payload on task 2 n + 3 * 32 + 7 (wave 2)
    cases = (
        ("three waves, one flush", dict(max_aggregated=32), WAVES,
         [FaultSpec(site="ring", task=5, wave=1),
          FaultSpec(site="payload", task=7, wave=2 * 16 + 3)],
         [37, 2 * n + 3 * 32 + 7]),
        ("compaction before the audit", dict(max_aggregated=4,
                                             buckets=(1, 3)), 1,
         [FaultSpec(site="ring", task=4), FaultSpec(site="payload",
                                                    task=13)], [4, 13]))
    for label, cfg_kw, n_waves, specs, want_failed in cases:
        exe = AggregationExecutor(
            delayed(ops.hydro_batched_body(cfg, h)), AggregationConfig(
                strategy="s2+s3", n_executors=4, launch_watermark=10 ** 9,
                guard="finite", **cfg_kw), device=dev,
            fault_injector=FaultInjector(specs))
        exe.warmup((((n,) + tuple(subs.shape[1:]), subs.dtype),))
        futs, refs = [], []
        sync()
        t0 = time.perf_counter()
        for w in range(n_waves):
            order = torch.roll(torch.arange(n, device=dev), 37 * w)
            futs += [exe.submit(t) for t in subs[order].unbind(0)]
            refs.append(want[order])
        exe.flush()
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        refs = torch.cat(refs)
        failed = [i for i, fut in enumerate(futs) if fut.failed()]
        check(failed == want_failed,
              f"ring hazard, {label}: failed {failed}, want {want_failed}")
        keep = [i for i in range(len(futs)) if i not in want_failed]
        got = torch.stack([futs[i].result() for i in keep])
        check(torch.equal(got, refs[keep]),
              f"ring hazard, {label}: a survivor differs from the fused "
              f"kernel")
        ring = exe.ring
        f = dict(next(iter(exe.stats["regions"].values()))["faults"])
        check(f["trips"] == 2, f"ring hazard, {label}: faults {f}")
        if n_waves > 1:
            check(ring.swaps >= 3 * n_waves, f"ring hazard: {ring.swaps} "
                  f"swaps")
        else:
            check(ring.compactions > 0, "ring hazard: no compaction")
        out[label] = dict(failed=failed, faults=f, ms=ms, swaps=ring.swaps,
                          compactions=ring.compactions,
                          launches=exe.stats["launches"])
        print(f"containment ({card}): 3. ring hazard, {label}: "
              f"{len(futs)} per-task submissions on 4 streams delayed "
              f"{SLEEP_CYCLES} cycles per launch, one flush: failed "
              f"{failed}, faults {f}, ring swaps {ring.swaps}, compactions "
              f"{ring.compactions}, {exe.stats['launches']} launches, "
              f"{len(keep)} survivors bit-equal to the fused kernel, "
              f"{ms:.1f} ms", flush=True)
    # the cost of a guarded ring launch's record: one copy of its slice
    ring_buf = torch.zeros((32,) + tuple(subs.shape[1:]), device=dev)

    def copy():
        return ring_buf.narrow(0, 0, 32).clone()
    dev_ms = time_graph_ms(copy, 200)
    sync()
    t0 = time.perf_counter()
    for _ in range(200):
        copy()
    host_us = (time.perf_counter() - t0) / 200 * 1e6
    sync()
    out["record_copy"] = dict(bytes=ring_buf.numel() * 4, device_ms=dev_ms,
                              host_us=host_us)
    print(f"containment ({card}): 3. a guarded 32-slot ring launch's record "
          f"copies its slice, {ring_buf.numel() * 4 / 1e6:.2f} MB: "
          f"{dev_ms * 1e3:.2f} us of device (a graph of 200 copies), "
          f"{host_us:.1f} us of host per launch", flush=True)
    return out


def contain_degraded(cfg, dev, card, pop, pop_want):
    """Check 4: a compile fault at bucket 32 and one launch fault at bucket
    16 on the main path's wave (s3 cap 32): the counters the CPU test
    expects (tests/test_torch_faults.py, ``degrade_at_cap_32``), 32
    launches of 16, bit-equal to the fused kernel."""
    from repro_torch.configs.base import AggregationConfig
    from repro_torch.core import (
        AggregationExecutor, FaultInjector, FaultSpec, UniformSedovScenario,
    )

    exe = AggregationExecutor(None, AggregationConfig(
        strategy="s3", max_aggregated=32), device=dev,
        fault_injector=FaultInjector([
            FaultSpec(site="compile", kernel="hydro_rhs", bucket=32),
            FaultSpec(site="launch", kernel="hydro_rhs", bucket=16,
                      mode="fail", times=1)]))
    exe.register("hydro_rhs", UniformSedovScenario(cfg).family(
        "hydro_rhs").batched_body)
    fut = pop.submit_to(exe)
    exe.flush()
    got = fut.result()
    sync()
    f = dict(next(iter(exe.stats["regions"].values()))["faults"])
    hist = dict(exe.stats["aggregated_hist"])
    check(f["compile_failures"] == 1 and f["launch_failures"] == 1
          and f["retries"] == 1 and f["degraded_launches"] == 2,
          f"degraded buckets: faults {f}")
    check(hist == {16: 32}, f"degraded buckets: buckets {hist}")
    check(torch.equal(got, pop_want), "degraded buckets: the result differs "
          "from the fused kernel")
    print(f"containment ({card}): 4. compile fault at bucket 32, one launch "
          f"fault at bucket 16, main path s3 cap 32: faults {f}, buckets "
          f"{hist}, bit-equal to the fused kernel", flush=True)
    return dict(faults=f, hist=hist)


def contain_stall(cfg, dev, card, pop, pop_want):
    """Check 5: a sleep of ~10 budgets on the launch's stream ahead of its
    kernel, under launch_timeout_s=0.02: the flush raises
    LaunchTimeoutError naming the family within a few budgets; once the
    sleep ends the executor runs a clean wave bit-equal to fused.  The
    sleep is queued on the executor's stream: the bucket's graph,
    captured at the first wave, replays the body as it was then, so a
    stall switched on in the body would not reach the card."""
    from repro_torch.configs.base import AggregationConfig
    from repro_torch.core import AggregationExecutor, UniformSedovScenario
    from repro_torch.core.faults import LaunchTimeoutError

    body = UniformSedovScenario(cfg).family("hydro_rhs").batched_body
    exe = AggregationExecutor(None, AggregationConfig(
        strategy="s3", max_aggregated=512, launch_timeout_s=STALL_BUDGET_S),
        device=dev)
    exe.register("stalled_hydro", body)
    exe.submit_range(pop.parents, 0, pop.n_tasks, kernel="stalled_hydro")
    exe.flush()                     # first-use costs and the capture
    sync()
    with torch.cuda.stream(exe.pool.executors[0].stream):
        torch.cuda._sleep(STALL_CYCLES)
    t0 = time.perf_counter()
    try:
        exe.submit_range(pop.parents, 0, pop.n_tasks,
                         kernel="stalled_hydro")
        exe.flush()
        raise CheckFailed("real stall: the flush did not raise")
    except LaunchTimeoutError as err:
        raised_s = time.perf_counter() - t0
        msg = str(err)
    still = not exe.pool.executors[0].last_event.query()
    sync()
    stalled_s = time.perf_counter() - t0
    f = dict(next(iter(exe.stats["regions"].values()))["faults"])
    check("stalled_hydro" in msg, f"real stall: {msg}")
    check(f["timeouts"] == 1, f"real stall: faults {f}")
    check(raised_s < 5 * STALL_BUDGET_S + 0.05 and still,
          f"real stall: raised after {raised_s:.3f} s (stall still running: "
          f"{still})")
    fut = exe.submit_range(pop.parents, 0, pop.n_tasks,
                           kernel="stalled_hydro")
    exe.flush()
    check(torch.equal(fut.result(), pop_want),
          "real stall: the clean wave after the stall differs from fused")
    print(f"containment ({card}): 5. a {STALL_CYCLES}-cycle stall under "
          f"launch_timeout_s={STALL_BUDGET_S}: LaunchTimeoutError after "
          f"{raised_s * 1e3:.1f} ms, the stall over after "
          f"{stalled_s * 1e3:.1f} ms, timeouts {f['timeouts']}; {msg}; the "
          f"next wave bit-equal to fused", flush=True)
    return dict(raised_ms=raised_s * 1e3, stall_ms=stalled_s * 1e3,
                faults=f)


def contain_breakers(gcfg, dev, card):
    """Check 6: Path A under mixed ({hydro_rhs: s3, gravity: fused}),
    guard on, breakers (window 4, threshold 2, cooldown 2): two direct
    gravity waves with a payload fault open gravity's breaker; while it is
    not closed gravity runs under s3 (bucket 1 while open), a clean
    half-open probe closes it, and it returns to fused.  Every iteration
    bit-equal to fused; the states equal the CPU test's."""
    from repro_torch.configs.base import AggregationConfig
    from repro_torch.core import (
        FaultInjector, FaultSpec, GravityScenario, StrategyRunner,
    )
    from repro_torch.core.aggregation import greedy_decomposition
    from repro_torch.hydro.state import sedov_init
    from repro_torch.kernels import gravity as grav

    u0 = sedov_init(gcfg.hydro, device=dev).u
    fused = StrategyRunner(GravityScenario(gcfg), AggregationConfig(
        strategy="fused"), device=dev).rhs(u0)
    agg = AggregationConfig(
        strategy="mixed", max_aggregated=32, launch_watermark=10 ** 9,
        family_strategies={"hydro_rhs": "s3", "gravity": "fused"},
        guard="finite", breaker_window=4, breaker_threshold=2,
        breaker_cooldown=2)
    ladder = agg.bucket_sizes()
    inj = FaultInjector([FaultSpec(site="payload", kernel="gravity",
                                   task=3, times=2)])
    runner = StrategyRunner(GravityScenario(gcfg), agg, device=dev,
                            fault_injector=inj)
    routes = runner._strategy.routes(runner.scenario, runner.ctx)
    check(routes["gravity"] == "fused", f"breakers: routes {routes}")
    exe = runner.executor
    pops = {p.kernel: p for p in runner.scenario.populations(u0)}
    states, launches, grav_launches = [], [], []
    for _ in range(2):
        fut = pops["gravity"].submit_to(exe)
        exe.flush()
        check(fut.failed_indices() == [3],
              f"breakers: failed {fut.failed_indices()}")
        states.append(exe.breaker_state("gravity"))
    for _ in range(4):
        before = exe.stats["launches"]
        zero_launch_counts()
        out = runner.rhs(u0)
        sync()
        launches.append(exe.stats["launches"] - before)
        grav_launches.append(kernel_launches(grav.gravity_cuda))
        states.append(exe.breaker_state("gravity"))
        check(torch.equal(out, fused),
              "breakers: a mixed iteration differs from fused")
    n = pops["gravity"].n_tasks
    hydro = len(greedy_decomposition(pops["hydro_rhs"].n_tasks, ladder))
    ladder_n = len(greedy_decomposition(n, ladder))
    check(states == BREAKER_SEQUENCE,
          f"breakers: states {states}, want {BREAKER_SEQUENCE}")
    check(launches == [hydro + n, hydro + n, hydro + ladder_n, hydro],
          f"breakers: executor launches per iteration {launches}")
    check(grav_launches == [n, n, ladder_n, 1],
          f"breakers: gravity kernel launches {grav_launches}")
    check(runner.ctx.caches[("mixed_route", "gravity")] == "fused",
          "breakers: the cached route was overwritten")
    print(f"containment ({card}): 6. Path A mixed, gravity's breaker: "
          f"states {states}; executor launches per iteration {launches}, "
          f"gravity kernel launches {grav_launches} (bucket 1 while open, "
          f"the ladder at the half-open probe, one fused launch once "
          f"closed); every iteration bit-equal to fused", flush=True)
    return exe, dict(states=states, launches=launches,
                     gravity_kernel_launches=grav_launches)


def contain_tripwire(cfg, dev, card):
    """Check 7: fused and s2 under guard=finite: a state holding one NaN
    raises NonFiniteStateError, a clean one passes."""
    from repro_torch.configs.base import AggregationConfig
    from repro_torch.core import (
        NonFiniteStateError, StrategyRunner, UniformSedovScenario,
    )
    from repro_torch.hydro.state import sedov_init

    u0 = sedov_init(cfg, device=dev).u
    bad = u0.clone()
    bad[0, 20, 20, 20] = float("nan")
    for strategy in ("fused", "s2"):
        runner = StrategyRunner(UniformSedovScenario(cfg), AggregationConfig(
            strategy=strategy, n_executors=4, guard="finite"), device=dev)
        runner.rhs(u0)
        try:
            runner.rhs(bad)
            raise CheckFailed(f"tripwire: {strategy} did not raise")
        except NonFiniteStateError as err:
            msg = str(err)
        print(f"containment ({card}): 7. {strategy} under guard=finite, a "
              f"state holding one NaN: NonFiniteStateError ({msg[:80]}...)",
              flush=True)


def contain_serving(dev, card, exe):
    """Check 8: qwen2-moe-a2.7b at published widths and CONTAIN_LAYERS
    layers in bf16, 8 requests on max_batch 4; a payload poison on one
    request at its last decode launch: that request is evicted, its slot
    serves a later request, every other request's tokens equal the
    fault-free run (the two schedules agree launch for launch, since the
    poison frees the slot where the clean run frees it; a slot freed
    earlier would change later buckets, whose GEMMs may round otherwise),
    and healthz reports the shared executor's breakers."""
    from repro_torch.configs.base import AggregationConfig
    from repro_torch.configs.qwen2_moe_a2_7b import CONFIG
    from repro_torch.core import FaultInjector, FaultSpec
    from repro_torch.models import model as model_mod
    from repro_torch.serving import Request, ServingEngine

    class Tracked(ServingEngine):
        """Records the launch (``_step_no``) of each request's last token
        and the slot each request ran in."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.last_launch, self.slot_of = {}, {}

        def _launch(self, slots, toks):
            rids = [self.active[s].rid for s in slots.tolist()]
            out = super()._launch(slots, toks)
            for s, rid in zip(slots.tolist(), rids):
                self.last_launch[rid] = self._step_no
                self.slot_of[rid] = s
            return out

    cfg = CONFIG.replace(n_layers=CONTAIN_LAYERS)
    m = model_mod.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(22)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in rng.integers(4, 13, 8)]
    news = [6, 9, 4, 11, 7, 5, 8, 10]
    target = 2

    def run(injector):
        eng = Tracked(cfg, m, max_batch=4, max_len=64, device=dev,
                      agg=AggregationConfig(max_aggregated=4,
                                            guard="finite"),
                      fault_injector=injector, executor=exe)
        reqs = [Request(i, p, max_new_tokens=k)
                for i, (p, k) in enumerate(zip(prompts, news))]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return eng, reqs

    clean_eng, clean = run(None)
    wave = clean_eng.last_launch[target]
    eng, reqs = run(FaultInjector([FaultSpec(
        site="payload", kernel="decode", task=target, wave=wave)]))
    bad = reqs[target]
    check(bad.failed and bad.done and "evicted" in (bad.error or ""),
          f"serving: request {target} not evicted ({bad.error})")
    check(eng.stats["faults"] == {"trips": 1, "evicted": 1, "shed": 0},
          f"serving: faults {eng.stats['faults']}")
    check(bad.output == clean[target].output[:-1],
          "serving: the evicted request's tokens before the poison differ")
    for r, c in zip(reqs, clean):
        if r.rid != target:
            check(r.done and not r.failed and r.output == c.output,
                  f"serving: request {r.rid}'s tokens differ from the "
                  f"fault-free run")
    reused = [r.rid for r in reqs if r.rid > target
              and eng.slot_of[r.rid] == eng.slot_of[target]
              and eng.last_launch[r.rid] > wave]
    check(reused, "serving: no later request ran in the evicted slot")
    health = eng.healthz()
    check(health["breakers"] == exe.breaker_states() and health["breakers"]
          and health["evicted"] == 1, f"serving: healthz {health}")
    print(f"containment ({card}): 8. {cfg.name} at published widths, "
          f"{CONTAIN_LAYERS} layers, bf16, 8 requests on max_batch 4: "
          f"request {target} poisoned at launch {wave} (its last decode) "
          f"and evicted, its slot {eng.slot_of[target]} reused by request "
          f"{reused[0]}, the other 7 requests' tokens equal the fault-free "
          f"run; faults {eng.stats['faults']}; healthz breakers "
          f"{health['breakers']}", flush=True)
    del m
    torch.cuda.empty_cache()
    return dict(wave=wave, reused_by=reused, faults=eng.stats["faults"],
                breakers=health["breakers"])


def phase_containment(cfg, gcfg, dev, card, dts, fused_main, results):
    """Checks 1-8 of the containment phase (see the functions above)."""
    from repro_torch.core import UniformSedovScenario
    from repro_torch.hydro.state import sedov_init

    t0 = time.perf_counter()
    out = {"card": card}
    out["guard_cost"] = contain_guard_cost(cfg, dev, card, dts, fused_main)
    out["payload"] = contain_payload(cfg, dev, card)
    out["ring"] = contain_ring(cfg, dev, card)
    sc = UniformSedovScenario(cfg)
    (pop,) = sc.populations(sedov_init(cfg, device=dev).u)
    pop_want = sc.family("hydro_rhs").batched_body(*pop.parents)
    out["degraded"] = contain_degraded(cfg, dev, card, pop, pop_want)
    out["stall"] = contain_stall(cfg, dev, card, pop, pop_want)
    exe, out["breakers"] = contain_breakers(gcfg, dev, card)
    contain_tripwire(cfg, dev, card)
    out["serving"] = contain_serving(dev, card, exe)
    out["seconds"] = time.perf_counter() - t0
    print(f"containment ({card}): checks 1-8 passed in "
          f"{out['seconds']:.1f} s", flush=True)
    results["containment"] = out


# ---------------------------------------------------------------------------
# warm start: the tune store across processes and the roofline prior
# ---------------------------------------------------------------------------

# process two of the warm start (``warm``) and the prior's fresh process
# (``prior``): argv = mode, store directory, data file (u0, dts, the fused
# path's state), result file.  Prints nothing; writes one JSON object.
WARM_CHILD = """
import json, sys, time
import torch
from repro_torch.configs.base import AggregationConfig
from repro_torch.configs.sedov import CONFIG
from repro_torch.core import StrategyRunner, UniformSedovScenario, graphs
from repro_torch.core.aggregation import greedy_decomposition
from repro_torch.kernels import _build
from repro_torch.kernels import hydro_rhs as kern

mode, store, data_file, out_file = sys.argv[1:5]
data = torch.load(data_file)
dev = torch.device("cuda", 0)
kw = dict(strategy="s3", max_aggregated=32, autotune=True, cost_model=True)
if mode == "warm":
    kw["tune_store"] = store
else:
    kw["prior"] = "roofline"
runner = StrategyRunner(UniformSedovScenario(CONFIG), AggregationConfig(**kw),
                        device=dev)
torch.cuda.synchronize()
t0 = time.perf_counter()
runner.warmup()
torch.cuda.synchronize()
out = {"warmup_s": time.perf_counter() - t0}
exe = runner.executor
(region,) = exe.regions.values()
fam = region.stats
out.update(tuned_by=fam.get("tuned_by"), ladder=list(fam["ladder"]),
           measurement_launches=fam["measurement_launches"],
           cost_sources=fam.get("cost_sources"),
           cost_model=fam.get("cost_model"),
           cost_model_paths=fam.get("cost_model_paths"),
           captures=exe.stats["captures"],
           built={k: v["seconds"] for k, v in _build.BUILD_LOG.items()})
if mode == "prior":
    out["priors"] = {p: {str(b): t * 1e3 for b, t in tbl.items()}
                     for p, tbl in region.cost.priors.items()}
    out["prior_ladder"] = list(region.buckets)
kern.hydro_rhs_cuda.launches = 0
graphs.reset_replayed_kernels()
u = data["u0"].to(dev)
for dt in data["dts"]:
    u = runner.rk3_step(u, dt.to(dev))
torch.cuda.synchronize()
out["equal"] = bool(torch.equal(u.cpu(), data["want"]))
out["kernel_launches"] = kern.hydro_rhs_cuda.launches + sum(
    c for k, c in graphs.replayed_kernels().items()
    if "hydro_rhs_cluster_kernel" in k) - sum(
    c for k, c in graphs.captured_kernels().items()
    if "hydro_rhs_cluster_kernel" in k)
out["after"] = dict(tuned_by=fam.get("tuned_by"), ladder=list(fam["ladder"]),
                    measurement_launches=fam["measurement_launches"],
                    cost_sources=fam.get("cost_sources"))
if mode == "prior":
    wave = CONFIG.n_subgrids
    tuned = list(region.buckets)
    out["prior_wave_ms"] = region.cost.predict_seq(
        greedy_decomposition(wave, out["prior_ladder"])) * 1e3
    out["tuned_wave_ms"] = region.cost.predict_seq(
        greedy_decomposition(wave, tuned)) * 1e3
    out["priors_left"] = bool(region.cost.priors)
with open(out_file, "w") as f:
    json.dump(out, f)
"""


def warm_child(mode, store, data_file, work):
    out_file = os.path.join(work, f"{mode}.json")
    t0 = time.perf_counter()
    proc = run_child(WARM_CHILD, [mode, store, data_file, out_file])
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"warm_start: the {mode} child exited "
          f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    with open(out_file) as f:
        out = json.load(f)
    out["process_s"] = seconds
    return out


def phase_warm_start(cfg, dev, card, dts, fused_main, results):
    """Process one (this one) tunes the main path under ``s3`` cap 32 with
    the cost model and autotune into a tune store: warmup, then 3 steps,
    the retune after 2 waves writing the store back, then ``save_tuning``.
    Process two, a fresh interpreter, warms up from the store: every
    region tuned by the store, 0 measurement launches, ladder and cost
    table equal to what process one saved, no library built, 3 steps
    bit-equal to ``fused``.  A third process under ``prior="roofline"``:
    the seeded ladder before any measurement launch, the steps bit-equal
    to ``fused``, the prior ladder's predicted per-wave time within 1.5x
    of the tuned ladder's on the measured table, every cost source
    ``"measured"`` after the retune.  Last, ``run(checkpoint_every=1)``
    with a store writes it at the first checkpoint.  Prints the warmup
    host seconds, cold and warm, and the card's figures from the prior's
    micro-benchmark."""
    import shutil
    import tempfile

    from repro_torch.configs.base import AggregationConfig
    from repro_torch.core import (
        StrategyRunner, TuneStore, UniformSedovScenario,
    )
    from repro_torch.core.aggregation import _backend_key
    from repro_torch.core.tunestore.prior import DEVICE_PEAKS, microbenchmark
    from repro_torch.hydro.state import sedov_init

    t_phase = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_warm_", dir=HERE)
    try:
        store = os.path.join(work, "store")
        agg = AggregationConfig(strategy="s3", max_aggregated=32,
                                autotune=True, cost_model=True,
                                tune_store=store)
        u0 = sedov_init(cfg, device=dev).u
        cold = StrategyRunner(UniformSedovScenario(cfg), agg, device=dev)
        sync()
        t0 = time.perf_counter()
        cold.warmup()
        sync()
        cold_s = time.perf_counter() - t0
        u = u0
        for dt in dts:
            u = cold.rk3_step(u, dt)
        sync()
        check(torch.equal(u, fused_main), "warm_start: the cold tuned run "
              "is not bit-identical to fused")
        (fam,) = cold.stats["regions"].values()
        check(fam["tuned_by"] == "measured",
              f"warm_start: process one tuned by {fam.get('tuned_by')}")
        check(os.path.isfile(os.path.join(store, "tunestore.json")),
              "warm_start: the retune wrote no store")
        cold.save_tuning()
        (entry,) = TuneStore(store).entries().values()
        data_file = os.path.join(work, "data.pt")
        torch.save({"u0": u0.cpu(), "dts": [d.cpu() for d in dts],
                    "want": fused_main.cpu()}, data_file)

        warm = warm_child("warm", store, data_file, work)
        check(warm["tuned_by"] == "store", f"warm_start: process two tuned "
              f"by {warm['tuned_by']}")
        check(warm["measurement_launches"] == 0
              and warm["after"]["measurement_launches"] == 0,
              f"warm_start: process two made "
              f"{warm['after']['measurement_launches']} measurement "
              f"launches")
        check(warm["ladder"] == entry["ladder"] == fam["ladder"],
              f"warm_start: ladder {warm['ladder']}, saved {entry['ladder']}")
        saved_ms = {str(b): round(t * 1e3, 4)
                    for b, t in entry["cost_model"]["s3"].items()}
        check({str(b): t for b, t in warm["cost_model"].items()} == saved_ms,
              f"warm_start: cost table {warm['cost_model']}, saved "
              f"{saved_ms}")
        check(warm["built"] and all(s is None
                                    for s in warm["built"].values()),
              f"warm_start: process two built {warm['built']}")
        check(warm["equal"], "warm_start: process two's steps are not "
              "bit-identical to fused")
        check(warm["kernel_launches"] > 0, "warm_start: process two never "
              "launched the kernel")
        print(f"warm_start ({card}): process one (cost model, autotune) "
              f"warmup {cold_s:.3f} s host, ladder {fam['ladder']}, "
              f"{fam['measurement_launches']} measurement launches; process "
              f"two from the store: warmup {warm['warmup_s']:.3f} s host "
              f"(process {warm['process_s']:.1f} s), tuned by the store, "
              f"0 measurement launches, no library built "
              f"({sorted(warm['built'])} cached), {warm['captures']} "
              f"bucket graphs captured at warmup (neither a build nor a "
              f"measurement launch), cost ms per bucket "
              f"{warm['cost_model']}, 3 steps bit-identical to fused",
              flush=True)

        prior = warm_child("prior", store, data_file, work)
        check(prior["tuned_by"] == "prior"
              and prior["measurement_launches"] == 0,
              f"warm_start: prior process tuned by {prior['tuned_by']} with "
              f"{prior['measurement_launches']} measurement launches")
        check(prior["equal"], "warm_start: the prior run is not "
              "bit-identical to fused")
        after = prior["after"]
        check(after["tuned_by"] == "measured" and not prior["priors_left"]
              and all(v == "measured" for tbl in after["cost_sources"].values()
                      for v in tbl.values()),
              f"warm_start: after the retune, tuned by {after['tuned_by']}, "
              f"sources {after['cost_sources']}")
        ratio = prior["prior_wave_ms"] / prior["tuned_wave_ms"]
        check(ratio <= 1.5, f"warm_start: the prior ladder "
              f"{prior['prior_ladder']} predicts {prior['prior_wave_ms']:.4f}"
              f" ms per wave, {ratio:.2f}x the tuned ladder's "
              f"{after['ladder']}")
        print(f"warm_start ({card}): prior='roofline' seeds ladder "
              f"{prior['prior_ladder']} with 0 measurement launches (prior "
              f"ms per bucket {prior['priors'].get('s3')}); after the "
              f"retune ladder {after['ladder']}, every cost source measured; "
              f"the prior ladder predicts {prior['prior_wave_ms']:.4f} ms per "
              f"512-task wave on the measured table, {ratio:.3f}x the tuned "
              f"ladder's {prior['tuned_wave_ms']:.4f} ms; steps bit-identical "
              f"to fused", flush=True)

        ck_store = os.path.join(work, "ck_store")
        runner = StrategyRunner(UniformSedovScenario(cfg), AggregationConfig(
            strategy="s3", max_aggregated=32, cost_model=True,
            tune_store=ck_store), device=dev)
        runner.warmup()
        seen = []
        save = runner._checkpoint

        def save_and_look(ckpt_dir, step, *args):
            save(ckpt_dir, step, *args)
            seen.append((step, os.path.isfile(
                os.path.join(ck_store, "tunestore.json"))))
        runner._checkpoint = save_and_look
        check(not os.path.exists(ck_store), "warm_start: a store before the "
              "first checkpoint")
        runner.run(u0, dts[0], 2, checkpoint_every=1,
                   ckpt_dir=os.path.join(work, "ckpt"))
        check(seen and seen[0] == (1, True), f"warm_start: store file "
              f"after the checkpoints: {seen}")

        bw, flops, launch = microbenchmark(dev)
        table = DEVICE_PEAKS.get("h100")
        print(f"warm_start ({card}): the prior's micro-benchmark on this "
              f"card ({_backend_key(dev)[1]}): {bw / 1e12:.3f} TB/s "
              f"streaming, {flops / 1e12:.2f} TFLOP/s fp32 matmul 512^3, "
              f"launch {launch * 1e6:.2f} us; the table's h100 row "
              f"{table}", flush=True)
        results["warm_start"] = dict(
            card=card, cold_warmup_s=cold_s, warm_warmup_s=warm["warmup_s"],
            warm_process_s=warm["process_s"], ladder=fam["ladder"],
            cold_measurement_launches=fam["measurement_launches"],
            prior_ladder=prior["prior_ladder"],
            prior_tuned_ladder=after["ladder"],
            prior_wave_ms=prior["prior_wave_ms"],
            tuned_wave_ms=prior["tuned_wave_ms"],
            prior_warmup_s=prior["warmup_s"],
            microbenchmark=dict(bytes_per_s=bw, flop_per_s=flops,
                                launch_s=launch),
            seconds=time.perf_counter() - t_phase)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"warm_start ({card}): passed in "
          f"{results['warm_start']['seconds']:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# tenancy on one card: TenantBatcher under s4
# ---------------------------------------------------------------------------

TENANTS = (1, 2, 4, 8, 16)
TENANT_STEPS = 3


def tenant_batcher(dev, cap, n, make, state, dt, eager=False):
    from repro_torch.configs.base import AggregationConfig
    from repro_torch.core import ShardedAggregationExecutor, TenantBatcher

    tb = TenantBatcher(ShardedAggregationExecutor(config=AggregationConfig(
        strategy="s4", max_aggregated=cap), name="tenancy", device=dev))
    tb._eager = eager
    for tid in range(n):
        tb.add(tid, make(), state, dt)
    return tb


def phase_tenancy(cfg, acfg, dev, card, dts, results):
    """Uniform tenants of the main path (512 x 8^3 each) at 1, 2, 4, 8 and
    16 tenants under ``s4`` caps 32 and 512, 3 RK3 steps of one dt: each
    tenant bit-equal to its solo ``s3`` runner, 3 merged waves per step,
    the staged (captured) path live; per row, launches per step, host ms
    per step per tenant against 1 tenant (steps 2 and 3; step 1 captures
    the two phases), device busy of a 4th step by ``torch.profiler`` with
    the graphs' input and output copies (DtoD) apart, and the peak
    memory.  Then 2 tenants of ``configs/amr_sedov.CONFIG``, staged: bit-
    equal to the solo runner and to the eager batcher."""
    from repro_torch.configs.base import AggregationConfig
    from repro_torch.core import (
        AMRSedovScenario, StrategyRunner, UniformSedovScenario,
    )
    from repro_torch.core.aggregation import greedy_decomposition
    from repro_torch.hydro.state import amr_sedov_init, sedov_init
    from repro_torch.hydro.stepper import amr_courant_dt
    from repro_torch.kernels import hydro_rhs as kern

    t_phase = time.perf_counter()
    u0 = sedov_init(cfg, device=dev).u
    dt = dts[0]
    rows = {}
    for cap in (32, 512):
        solo = StrategyRunner(UniformSedovScenario(cfg), AggregationConfig(
            strategy="s3", max_aggregated=cap), device=dev)
        want = u0
        for _ in range(TENANT_STEPS):
            want = solo.rk3_step(want, dt)
        per_wave = {}
        for n in TENANTS:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            tb = tenant_batcher(dev, cap, n, lambda: UniformSedovScenario(cfg),
                                u0, dt)
            tb.rk3_step_all()
            sync()
            zero_launch_counts()
            t0 = time.perf_counter()
            for _ in range(TENANT_STEPS - 1):
                out = tb.rk3_step_all()
            sync()
            wall = time.perf_counter() - t0
            launches = kernel_launches(kern.hydro_rhs_cuda) / (
                TENANT_STEPS - 1)
            for tid in range(n):
                check(torch.equal(out[tid], want), f"tenancy: {n} tenants "
                      f"cap {cap}, tenant {tid} differs from its solo run")
            check(tb.stats["waves"] == 3 * TENANT_STEPS,
                  f"tenancy: {tb.stats['waves']} waves in {TENANT_STEPS} "
                  f"steps")
            check(tb.stats["eager_fallbacks"] == 0 and not tb._eager,
                  "tenancy: the staged path fell back to eager")
            want_launches = 3 * len(greedy_decomposition(
                n * cfg.n_subgrids, AggregationConfig(
                    max_aggregated=cap).bucket_sizes()))
            check(launches == want_launches, f"tenancy: {launches} kernel "
                  f"launches per step, want {want_launches}")
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            _, prof = profiled(tb.rk3_step_all)
            events = device_events(prof)
            busy = sum(us for _, us in events) / 1e3
            copies = sum(us for name, us in events
                         if "Memcpy DtoD" in name) / 1e3
            ms = wall / (TENANT_STEPS - 1) * 1e3
            per_wave[n] = dict(
                host_ms_per_step=ms, host_ms_per_step_per_tenant=ms / n,
                launches_per_step=launches, device_busy_ms_per_step=busy,
                dtod_copy_ms_per_step=copies, peak_mib=peak)
            base = per_wave[1]["host_ms_per_step_per_tenant"]
            print(f"tenancy ({card}): {n:2d} tenants x {cfg.n_subgrids} "
                  f"sub-grids, s4 cap {cap}: {ms:.3f} ms/step host, "
                  f"{ms / n:.3f} ms/step per tenant ({ms / n / base:.3f}x "
                  f"1 tenant), {launches:g} kernel launches/step, device "
                  f"busy {busy:.3f} ms/step (graph input/output copies "
                  f"{copies:.3f} ms), peak {peak:.1f} MiB, every tenant "
                  f"bit-identical to its solo s3 run", flush=True)
            del tb, out
        rows[cap] = per_wave

    st = amr_sedov_init(acfg, device=dev)
    state = (st.uc, st.uf)
    adt = amr_courant_dt(st.uc, st.uf, acfg)
    solo = StrategyRunner(AMRSedovScenario(acfg), AggregationConfig(
        strategy="s3", max_aggregated=16), device=dev)
    want = state
    for _ in range(TENANT_STEPS):
        want = solo.rk3_step(want, adt)
    got = {}
    for eager in (False, True):
        tb = tenant_batcher(dev, 16, 2, lambda: AMRSedovScenario(acfg),
                            state, adt, eager=eager)
        for _ in range(TENANT_STEPS):
            out = tb.rk3_step_all()
        got[eager] = out
        check(tb.stats["eager_fallbacks"] == 0,
              "tenancy: the AMR batcher fell back to eager")
        check(bool(tb._stage_cache) is not eager,
              f"tenancy: AMR stage cache {len(tb._stage_cache)}, eager "
              f"{eager}")
    for tid in range(2):
        check(states_equal(got[False][tid], want)
              and states_equal(got[True][tid], want),
              f"tenancy: AMR tenant {tid} (staged or eager) differs from "
              f"its solo run")
    seconds = time.perf_counter() - t_phase
    print(f"tenancy ({card}): 2 tenants of {acfg.name} (uc, uf), staged "
          f"and eager, {TENANT_STEPS} steps bit-identical to the solo s3 "
          f"run; phase {seconds:.1f} s", flush=True)
    results["tenancy"] = dict(card=card, uniform=rows, seconds=seconds)


# ---------------------------------------------------------------------------
# distributed: s4 over a mesh of shards, the data-parallel step, the
# resilient loop and the elastic restore
# ---------------------------------------------------------------------------

DIST_SHARDS = 4          # shards of the s4 mesh (over cards when visible)
DIST_TENANTS = 4
DP_ARCH = "h2o-danube-1.8b"
DP_BATCHES = (4, 2, 1)   # the full-width DP step's batches, tried in order
RESILIENT_STEPS, RESILIENT_FAIL_AT = 5, 2


def dist_mesh(dev):
    """``DIST_SHARDS`` shards over ``min(4, cards)`` cards when two or more
    are visible, else ``DIST_SHARDS`` shards on the one card."""
    from repro_torch.distributed.api import subgrid_mesh, visible_devices

    cards = torch.cuda.device_count()
    if cards >= 2:
        n = min(DIST_SHARDS, cards)
        return subgrid_mesh(n, devices=visible_devices(dev)), (
            f"{n} shards over {n} cards")
    return subgrid_mesh(DIST_SHARDS, devices=[dev] * DIST_SHARDS), (
        f"{DIST_SHARDS} shards on the one card (one stream each); a real "
        f"exchange between cards is left unverified here")


def dist_s4(cfg, dev, card, dts, fused_main, mesh):
    """The main path under ``s4`` cap 32 on ``mesh`` (``drive``: 3 RK3
    steps bit-equal to ``fused``), the hydro_rhs launches counted from the
    replayed graphs' kernel nodes against the greedy decomposition per
    shard, occupancy, copies, and host and busy ms per step against ``s3``
    cap 32; then 4 tenants on the mesh, each equal to its solo run and
    every shard equally filled; ``halo_exchange`` and ``ghost_gather``."""
    from repro_torch.configs.base import AggregationConfig
    from repro_torch.core import (
        ShardedAggregationExecutor, StrategyRunner, TenantBatcher,
        UniformSedovScenario,
    )
    from repro_torch.core.aggregation import greedy_decomposition
    from repro_torch.hydro.state import sedov_init
    from repro_torch.kernels import hydro_rhs as kern

    u0 = sedov_init(cfg, device=dev).u
    shards = mesh.size
    cap32 = AggregationConfig(strategy="s3", max_aggregated=32)
    rows = {}
    for label, agg, kw in (
            ("s4 cap 32", AggregationConfig(strategy="s4",
                                            max_aggregated=32),
             dict(mesh=mesh)),
            ("s3 cap 32", cap32, {})):
        runner = StrategyRunner(UniformSedovScenario(cfg), agg, device=dev,
                                **kw)
        u, row = drive(runner, u0, dts, [kern.hydro_rhs_cuda])
        check(torch.equal(u, fused_main), f"distributed: {label} on the "
              f"mesh is not bit-identical to fused")

        def steps(runner=runner):
            x = u0
            for dt in dts:
                x = runner.rk3_step(x, dt)
        row["host_ms_per_step"] = host_ms(steps, len(dts))
        _, prof = profiled(lambda: runner.rk3_step(u0, dts[0]))
        events = device_events(prof)
        row["device_busy_ms_per_step"] = sum(us for _, us in events) / 1e3
        row["dtod_copy_ms_per_step"] = sum(
            us for name, us in events if "Memcpy DtoD" in name
            or "Memcpy PtoP" in name) / 1e3
        rows[label] = row
        if agg.strategy == "s4":
            exe = runner.executor
            local = cfg.n_subgrids // shards
            rem = cfg.n_subgrids - local * shards
            per_stage = shards * len(greedy_decomposition(
                local, agg.bucket_sizes())) + (len(greedy_decomposition(
                    rem, agg.bucket_sizes())) if rem else 0)
            got = row["kernel_launches"]["hydro_rhs_cuda"]
            want = 3 * len(dts) * per_stage
            check(got == want, f"distributed: {got} hydro_rhs launches on "
                  f"the mesh over {len(dts)} steps, want {want} (greedy per "
                  f"shard)")
            check(row["eager_launches"]["hydro_rhs_cuda"] == 0,
                  "distributed: an s4 launch ran outside its graph")
            occ = exe.stats["shard_occupancy"]
            check(occ == [local + rem] + [local] * (shards - 1),
                  f"distributed: shard occupancy {occ}")
            row.update(shard_occupancy=occ, mesh=dict(mesh.shape),
                       gather_copies=exe.stats["gather_copies"],
                       scatter_copies=exe.stats["scatter_copies"],
                       captures=exe.stats["captures"],
                       graph_mib=exe.stats["graph_bytes"] / 2 ** 20)
        print(f"distributed ({card}): main path {label}"
              f"{' on ' + str(mesh.shape) if kw else ''}: "
              f"{row['host_ms_per_step']:.3f} ms/step host, busy "
              f"{row['device_busy_ms_per_step']:.3f} ms/step (graph copies "
              f"{row['dtod_copy_ms_per_step']:.3f} ms), hydro_rhs launches "
              f"{row['kernel_launches']['hydro_rhs_cuda']} over {len(dts)} "
              f"steps (from the graphs' kernel nodes)"
              + (f", occupancy {row['shard_occupancy']}, copies gathered "
                 f"{row['gather_copies']} scattered "
                 f"{row['scatter_copies']}, {row['captures']} captures "
                 f"({row['graph_mib']:.1f} MiB)" if kw else "")
              + ", bit-identical to fused", flush=True)

    # tenants on the mesh, one step each, against their solo run
    solo = StrategyRunner(UniformSedovScenario(cfg), cap32,
                          device=dev).rk3_step(u0, dts[0])
    exe = ShardedAggregationExecutor(config=AggregationConfig(
        strategy="s4", max_aggregated=32), name="tenancy", mesh=mesh)
    tb = TenantBatcher(exe)
    for tid in range(DIST_TENANTS):
        tb.add(tid, UniformSedovScenario(cfg), u0, dts[0])
    out = tb.rk3_step_all()
    for tid in range(DIST_TENANTS):
        check(torch.equal(out[tid], solo), f"distributed: tenant {tid} on "
              f"the mesh differs from its solo run")
    occ = exe.stats["shard_occupancy"]
    check(len(set(occ)) == 1 and sum(occ) == DIST_TENANTS * cfg.n_subgrids,
          f"distributed: {DIST_TENANTS} tenants fill the shards {occ}")
    print(f"distributed ({card}): {DIST_TENANTS} tenants on the mesh, each "
          f"bit-identical to its solo s3 step, shards filled {occ}",
          flush=True)

    # the reference's collectives
    x = torch.arange(shards * 6 * 5, dtype=torch.float32,
                     device=dev).reshape(shards * 6, 5)
    rolled = exe.halo_exchange(x)
    check(torch.equal(rolled, torch.roll(x, 6, dims=0)),
          "distributed: halo_exchange is not a one-block roll")
    check(exe.ghost_gather(out[0]) is out[0],
          "distributed: ghost_gather copied a result already whole")
    print(f"distributed ({card}): halo_exchange rolls {shards} shard blocks "
          f"one step along data; ghost_gather returns a gathered wave "
          f"uncopied", flush=True)
    return dict(rows=rows, shard_occupancy_tenants=occ)


def dist_dp(dev, card, work):
    """A one-rank NCCL group (a FileStore in ``work``): reduced granite-8b
    through ``make_dp_train_step`` (``compress=False``) bit-equal to
    ``make_train_step``'s step under ``launch.train.deterministic``; then
    one bf16 step of ``DP_ARCH`` at published widths and full depth, seq
    ``TRAIN_SEQ``, ``compress=True``, at the first of ``DP_BATCHES`` that
    fits: ms, peak memory, the loss at init against ln V."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.distributed import (
        make_dp_train_step, process_group, residual_init,
    )
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import add_extra_inputs, deterministic
    from repro_torch.models import model as model_mod
    from repro_torch.optim import OptConfig, opt_init

    out = {}
    with process_group(0, 1, device=dev,
                       store_path=os.path.join(work, "store")):
        check(torch.distributed.get_backend() == "nccl",
              f"distributed: backend {torch.distributed.get_backend()}")
        cfg = reduced(get_config("granite-8b"))
        opt = OptConfig(lr=3e-3, warmup_steps=2, total_steps=10)
        data = SyntheticLMStream(DataConfig(seq_len=64, global_batch=8,
                                            vocab_size=cfg.vocab_size))
        models, losses = [], []
        with deterministic(dev):
            for dp in (True, False):
                m = model_mod.init_params(cfg, 0, dev)
                state = opt_init(dict(m.named_parameters()))
                if dp:
                    step = make_dp_train_step(model_mod.loss_fn, opt,
                                              compress=False)
                    res = residual_init(m)
                    for i in range(3):
                        m, state, res, loss, _ = step(m, state, res,
                                                      data.batch(i, dev))
                else:
                    step = make_train_step(cfg, opt, device=dev)
                    for i in range(3):
                        m, state, met = step(m, state, data.batch(i, dev))
                    loss = met["loss"]
                models.append(m)
                losses.append(float(loss))
        check(losses[0] == losses[1] and all(
            torch.equal(a, b) for a, b in zip(models[0].parameters(),
                                              models[1].parameters())),
              "distributed: the one-rank DP step differs from train_step")
        print(f"distributed ({card}): one-rank NCCL group, reduced granite-8b"
              f" 3 steps through make_dp_train_step(compress=False) "
              f"bit-equal to make_train_step (loss {losses[0]:.6f})",
              flush=True)
        del models

        # one full-width bf16 step, compressed
        cfg = get_config(DP_ARCH)
        check(cfg.remat and cfg.dtype == "bfloat16",
              f"distributed: {DP_ARCH} is not a bf16 remat config")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        m = model_mod.init_params(cfg, 0, dev)
        n_params = sum(p.numel() for p in m.parameters())
        state = opt_init(dict(m.named_parameters()))
        res = residual_init(m)
        step = make_dp_train_step(model_mod.loss_fn, OptConfig(),
                                  compress=True)
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            for b in DP_BATCHES:
                data = SyntheticLMStream(DataConfig(
                    seq_len=TRAIN_SEQ, global_batch=b,
                    vocab_size=cfg.vocab_size))
                batch = add_extra_inputs(cfg, data.batch(0, dev), 0, dev)
                try:
                    sync()
                    t0 = time.perf_counter()
                    m, state, res, loss, met = step(m, state, res, batch)
                    sync()
                    ms = (time.perf_counter() - t0) * 1e3
                    break
                except torch.OutOfMemoryError:
                    print(f"distributed ({card}): {DP_ARCH} DP step at batch "
                          f"{b} x {TRAIN_SEQ} does not fit", flush=True)
                    batch = None
                    gc.collect()
                    torch.cuda.empty_cache()
            else:
                check(False, f"distributed: no batch of {DP_BATCHES} fits "
                      f"the {DP_ARCH} DP step")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        loss0, gnorm = float(loss), float(met["grad_norm"])
        lnv = float(np.log(cfg.vocab_size))
        check(abs(loss0 - lnv) <= 0.35 * lnv and np.isfinite(gnorm),
              f"distributed: {DP_ARCH} DP loss {loss0}, grad norm {gnorm}")
        carried = sum(float(r.abs().sum()) for r in res.values())
        check(carried > 0, "distributed: the int8 residual carried nothing")
        print(f"distributed ({card}): {DP_ARCH} ({cfg.n_layers} layers, "
              f"{n_params / 1e9:.3f} B parameters) one bf16 "
              f"make_dp_train_step(compress=True) step at batch {b} x "
              f"{TRAIN_SEQ}: {ms:.1f} ms (first call), loss {loss0:.4f} (ln "
              f"V {lnv:.4f}), grad norm {gnorm:.4f}, peak {peak:.2f} GiB",
              flush=True)
        out = dict(granite_bit_equal=True, dp_arch=DP_ARCH, batch=b,
                   seq=TRAIN_SEQ, params=n_params, ms_first_step=ms,
                   peak_gib=peak, loss0=loss0, grad_norm=gnorm)
        del m, state, res, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def dist_resilient(dev, card, work):
    """``resilient_loop`` around the training loop's step and checkpoints
    (reduced granite-8b, ``save_every`` 1): at step
    ``RESILIENT_FAIL_AT`` a ``SimulatedFailure`` after the update (the
    weights already written in place), the loop restores the last
    checkpoint and replays; the weights after ``RESILIENT_STEPS`` steps
    equal a straight run's bit for bit.  Then ``restore_resharded`` of the
    last checkpoint onto a mesh of the card equals them too."""
    from repro_torch.checkpoint import latest_step, restore_resharded
    from repro_torch.configs import get_config, reduced
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.distributed import (
        NamedSharding, PartitionSpec, SimulatedFailure, resilient_loop,
        subgrid_mesh,
    )
    from repro_torch.distributed.api import tree_map
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import (
        deterministic, restore_state, save_state,
    )
    from repro_torch.models import convert
    from repro_torch.models import model as model_mod
    from repro_torch.optim import OptConfig, opt_init

    cfg = reduced(get_config("granite-8b"))
    opt = OptConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    data = SyntheticLMStream(DataConfig(seq_len=64, global_batch=8,
                                        vocab_size=cfg.vocab_size))

    def run(fail, ckpt):
        m = model_mod.init_params(cfg, 0, dev).requires_grad_(True)
        step = make_train_step(cfg, opt, device=dev)
        failed = []

        def step_fn(state, i):
            m, s = state
            m, s, _ = step(m, s, data.batch(i, dev))
            if fail and i == RESILIENT_FAIL_AT and not failed:
                failed.append(i)
                raise SimulatedFailure(f"card lost after the update of "
                                       f"step {i}")
            return m, s

        def restore_fn(i):
            s, _ = restore_state(ckpt, i, m)
            return m, s

        with deterministic(dev):
            (m, _), stats = resilient_loop(
                step_fn, (m, opt_init(dict(m.named_parameters()))),
                RESILIENT_STEPS, save_every=1,
                save_fn=lambda st, i: save_state(ckpt, i, st[0], st[1]),
                restore_fn=restore_fn)
        return m, stats

    straight, s0 = run(False, os.path.join(work, "straight"))
    failed, s1 = run(True, os.path.join(work, "failed"))
    check(s0["failures"] == 0 and s1["failures"] == 1
          and s1["restores"] == 1, f"distributed: resilient stats {s1}")
    check(all(torch.equal(a, b) for a, b in zip(straight.parameters(),
                                                failed.parameters())),
          "distributed: the restored trajectory differs from the straight "
          "run")
    ckpt = os.path.join(work, "failed")
    last = latest_step(ckpt)
    mesh = subgrid_mesh(1, devices=[dev])
    layout = convert.reference_layout(failed)

    def spec_fn(tree):
        return tree_map(lambda _: NamedSharding(mesh, PartitionSpec()), tree)

    params, opt_state, meta = restore_resharded(
        ckpt, last, layout, {"m": layout, "v": layout, "step": 0}, mesh,
        spec_fn)
    want = convert.params_to_reference(failed)
    flat_got = dict(_flat(params))
    ok = all(flat_got[k].device == dev and torch.equal(
        flat_got[k].cpu(), torch.from_numpy(v)) for k, v in _flat(want))
    check(ok and int(opt_state["step"]) == RESILIENT_STEPS,
          "distributed: restore_resharded onto the card differs from the "
          "run's weights")
    print(f"distributed ({card}): resilient_loop, SimulatedFailure after "
          f"step {RESILIENT_FAIL_AT}'s update, {s1['restores']} restore of "
          f"step {RESILIENT_FAIL_AT}: {RESILIENT_STEPS} steps bit-identical "
          f"to the straight run; restore_resharded of step {last} onto "
          f"{mesh.shape} equals the weights on {dev} (AcceleratorError: "
          f"{hasattr(torch, 'AcceleratorError')})", flush=True)
    return dict(stats=s1, restored_step=last,
                accelerator_error=hasattr(torch, "AcceleratorError"))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


def phase_distributed(cfg, dev, card, dts, fused_main, results):
    """``s4`` over a mesh, the data-parallel step, the resilient loop and
    the elastic restore (``dist_s4``, ``dist_dp``, ``dist_resilient``)."""
    import tempfile

    t0 = time.perf_counter()
    mesh, what = dist_mesh(dev)
    print(f"distributed ({card}): the s4 mesh {mesh.shape}: {what}",
          flush=True)
    out = {"mesh": dict(mesh.shape), "mesh_kind": what,
           "s4": dist_s4(cfg, dev, card, dts, fused_main, mesh)}
    gc.collect()
    torch.cuda.empty_cache()
    scratch = os.path.join(HERE, "results")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="dist_", dir=scratch) as work:
        out["dp"] = dist_dp(dev, card, work)
        out["resilient"] = dist_resilient(dev, card, work)
    out["seconds"] = time.perf_counter() - t0
    print(f"distributed ({card}): phase {out['seconds']:.1f} s", flush=True)
    results["distributed"] = out


# ---------------------------------------------------------------------------
# the serving path: decode attention, the grouped GEMM, qwen2-moe-a2.7b
# ---------------------------------------------------------------------------

MAX_LEN = 1024          # the serving phase's engine max_len (cache length S)
MAX_BATCH = 8
# the reference's kernel tolerances (tests/test_kernels.py), atol = rtol
DA_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
GG_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# bf16 logits after 24 layers: 16 bf16 rounding units (2^-8 each) of the
# row's largest |logit|
LOGIT_TOL = 2.0 ** -4
# fp32 replays, kernels against plain versions: each launch within 1e-5 of
# its plain version, a few layers deep, two orders of magnitude of margin
F32_LAYERS = 4
F32_LOGIT_TOL = 1e-3


class CheckedKernels:
    """A ``kernels`` hook for ``decode_step``: launches each serving kernel
    and holds its output to the plain version on the same inputs at the
    dtype's kernel tolerance, then returns the kernel's output."""

    def __init__(self):
        self.calls = {"decode_attention": 0, "grouped_gemm": 0}
        self.max_err = {"decode_attention": 0.0, "grouped_gemm": 0.0}

    def _hold(self, name, got, want, tol):
        diff = (got.float() - want.float()).abs()
        check(bool((diff <= tol + tol * want.float().abs()).all()),
              f"{name} on the serving path: the kernel is outside "
              f"{tol:g} of its plain version")
        self.calls[name] += 1
        self.max_err[name] = max(self.max_err[name], float(diff.max()))
        return got

    def decode_attention(self, q, k, v, cache_len):
        from repro_torch.kernels import decode_attention as da
        return self._hold("decode_attention",
                          da.decode_attention_cuda(q, k, v, cache_len),
                          da.decode_attention_plain(q, k, v, cache_len),
                          DA_TOL[q.dtype])

    def grouped_gemm(self, x, w, group_len):
        from repro_torch.kernels import grouped_gemm as gg
        return self._hold("grouped_gemm",
                          gg.grouped_gemm_cuda(x, w, group_len),
                          gg.grouped_gemm_plain(x, w, group_len),
                          GG_TOL[x.dtype])


class RoutingRecorder:
    """A ``kernels`` hook for ``decode_step`` that passes every call on to
    ``inner`` and keeps each MoE layer's routing: the experts with rows in
    its first grouped GEMM (gate) of every step."""

    def __init__(self, inner):
        self.inner = inner
        self.live = []
        self._calls = 0

    def decode_attention(self, q, k, v, cache_len):
        return self.inner.decode_attention(q, k, v, cache_len)

    def grouped_gemm(self, x, w, group_len):
        if self._calls % 3 == 0:
            self.live.append(tuple(torch.nonzero(group_len).flatten()
                                   .tolist()))
        self._calls += 1
        return self.inner.grouped_gemm(x, w, group_len)


def flop_rate(dtype):
    return BF16_FLOP_PER_S if dtype == torch.bfloat16 else FP32_FLOP_PER_S


def allclose_err(label, got, want, tol):
    """Hold ``got`` to ``want`` elementwise, |got - want| <= tol + tol
    |want| (the reference's allclose with atol = rtol = tol); prints and
    returns the max abs error."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    print(f"{label}: max abs err {err:.3e} (atol = rtol = {tol:g}, max "
          f"|want| {float(w.abs().max()):.3e})", flush=True)
    check(bool(torch.isfinite(g).all()), f"{label}: output not finite")
    check(bool((diff <= tol + tol * w.abs()).all()),
          f"{label}: outside the tolerance")
    return err


def draw(rng, shape, dtype, dev, scale=1.0):
    x = (scale * rng.standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(x).to(dev).to(dtype)


def attention_bytes_ops(q, k, lens):
    """The function's bytes (q, the K and V rows below each cache_len, the
    output) and operations (4 per live row, query head and dimension)."""
    b, hq, d = q.shape
    hkv, elt = k.shape[2], k.element_size()
    rows = int(lens.sum())
    return (2 * q.numel() * elt + rows * hkv * d * 2 * elt,
            4 * rows * hq * d)


def gg_bytes_ops(x, w, gl):
    """The function's bytes (the live x rows, the w of experts with rows,
    the whole output) and operations (2 K N per live row)."""
    e, c, k = x.shape
    n, elt = w.shape[2], x.element_size()
    rows = int(gl.sum())
    live = int((gl > 0).sum())
    return (rows * k * elt + live * k * n * elt + e * c * n * elt,
            2 * rows * k * n)


def timed_engine(*args, **kw):
    """A ``ServingEngine`` that keeps the host time of every launch by
    bucket in ``launch_ms`` (each launch ends in the argmax's copy to the
    host, so it is synchronised)."""
    from repro_torch.data.pipeline import length_bucket
    from repro_torch.serving import ServingEngine

    class TimedEngine(ServingEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.launch_ms = {}

        def _launch(self, slots, toks):
            bucket = length_bucket(len(slots), self.buckets)
            t0 = time.perf_counter()
            out = super()._launch(slots, toks)
            self.launch_ms.setdefault(bucket, []).append(
                (time.perf_counter() - t0) * 1e3)
            return out

    return TimedEngine(*args, **kw)


def replay_alone(model, req, kernels, max_len):
    """Request ``req`` alone (bucket 1) through ``decode_step`` with
    ``kernels``, fed the engine's own tokens, against the engine's stub
    memory: the fp32 logits of each emitted token, (n, V)."""
    from repro_torch.models import model as model_mod

    dev = model.device
    cache = model_mod.init_cache(model, 1, max_len)
    for tok in req.prompt[:-1]:
        model_mod.decode_step(model, cache,
                              torch.tensor([[tok]], device=dev),
                              kernels=kernels)
    tok, rows = req.prompt[-1], []
    for nxt in req.output:
        lg, cache = model_mod.decode_step(
            model, cache, torch.tensor([[tok]], device=dev),
            kernels=kernels)
        rows.append(lg[0].float())
        tok = nxt
    return torch.stack(rows)


def phase_lm_kernels(dev, card, results):
    """The two serving kernels against their plain versions at the
    full-width qwen2-moe-a2.7b shapes (bf16), at fp32 and at granite-8b's
    GQA shape; row independence; exact zeros; times beside the plain
    version, one PyTorch call and the bound."""
    import torch.nn.functional as F

    from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as QWEN
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import grouped_gemm as gg
    from repro_torch.models import moe
    from repro_torch.models.common import Init

    bf16, f32 = torch.bfloat16, torch.float32
    rng = np.random.default_rng(14)
    b, s, d = MAX_BATCH, MAX_LEN, QWEN.resolved_head_dim
    lens = np.concatenate([[1, s], rng.integers(2, s, b - 2)]).astype(np.int32)
    cl = torch.from_numpy(lens).to(dev)
    print(f"decode_attention at B={b}, S={s}, D={d}, cache_len "
          f"{lens.tolist()} ({card})", flush=True)

    # --- decode attention ---
    errs, main = [], None
    for label, hq, hkv, dtype in (
            ("qwen2-moe MHA 16/16 bf16", QWEN.n_heads, QWEN.n_kv_heads, bf16),
            ("qwen2-moe MHA 16/16 f32", QWEN.n_heads, QWEN.n_kv_heads, f32),
            ("granite-8b GQA 32/8 bf16", 32, 8, bf16),
            ("granite-8b GQA 32/8 f32", 32, 8, f32)):
        q = draw(rng, (b, hq, d), dtype, dev)
        k = draw(rng, (b, s, hkv, d), dtype, dev)
        v = draw(rng, (b, s, hkv, d), dtype, dev)
        got = da.decode_attention_cuda(q, k, v, cl)
        want = da.decode_attention_plain(q, k, v, cl)
        errs.append((allclose_err(f"decode_attention kernel vs plain, "
                                  f"{label}", got, want, DA_TOL[dtype]),))
        for i in range(b):
            solo = da.decode_attention_cuda(q[i:i + 1], k[i:i + 1],
                                            v[i:i + 1], cl[i:i + 1])
            check(torch.equal(solo[0], got[i]),
                  f"decode_attention {label}: request {i} differs between "
                  f"its solo launch and the bucket of {b}")
        # nothing at or past a request's cache_len is read
        k2, v2 = k.clone(), v.clone()
        for i, n in enumerate(lens.tolist()):
            k2[i, n:] = float("nan")
            v2[i, n:] = float("nan")
        check(torch.equal(da.decode_attention_cuda(q, k2, v2, cl), got),
              f"decode_attention {label}: NaN stored past cache_len changed "
              f"the result")
        del k2, v2
        if main is None:
            main = (q, k, v, got)
    q, k, v, got = main
    cl0 = cl.clone()
    cl0[0] = 0
    got0 = da.decode_attention_cuda(q, k, v, cl0)
    check(not bool(got0[0].any()) and torch.equal(got0[1:], got[1:]),
          "decode_attention: cache_len 0 must give exactly 0 and leave the "
          "other requests as they were")
    print(f"decode_attention: every request equals its solo launch bit for "
          f"bit and NaN past cache_len is never read (4 shapes); cache_len 0 "
          f"gives 0", flush=True)

    # device time by graph replays: the kernel pair is shorter than its
    # Python wrapper, so back-to-back calls would time the host
    ms_events = time_cuda_ms(lambda: da.decode_attention_cuda(q, k, v, cl),
                             200)
    plain_ms = time_cuda_ms(lambda: da.decode_attention_plain(q, k, v, cl),
                            20)

    def kernel_call(qq, kk, vv, cc):
        return lambda: da.decode_attention_cuda(qq, kk, vv, cc)

    allclose_err("library call (scaled_dot_product_attention) vs plain",
                 sdpa_call(q, k, v, cl)()[:, :, 0],
                 da.decode_attention_plain(q, k, v, cl), DA_TOL[bf16])

    def cold_and_warm(make_call, bb, touched):
        """(ms with L2 cold, ms with L2 warm, L2 exceeded) of the call on
        the first bb requests, by graph replays: cold rotates over copies
        of the inputs (``l2_cold_calls``), warm repeats one call."""
        cb = cl[:bb]
        calls, exceeded = l2_cold_calls(
            lambda qq, kk, vv: make_call(qq, kk, vv, cb),
            (q[:bb], k[:bb], v[:bb]), touched)
        cold = time_graph_ms(calls, 200)
        warm = time_graph_ms(calls[0], 200)
        del calls
        return cold, warm, exceeded

    # by batch, in one call; the serving path's layers find their caches
    # cold (23 other layers' caches and the weights pass through L2 between
    # two visits), so the cold times are the kernels line's
    g = q.shape[1] // k.shape[2]
    by_batch = {}
    for bb in (1, 2, 4, 8):
        n_bytes, n_ops = attention_bytes_ops(q[:bb], k[:bb], lens[:bb])
        k_cold, k_warm, k_exc = cold_and_warm(kernel_call, bb, n_bytes)
        l_cold, l_warm, l_exc = cold_and_warm(
            sdpa_call, bb, 2 * g * k[:bb].numel() * k.element_size())
        by_batch[bb] = dict(
            ms=k_cold, ms_warm=k_warm, library_ms=l_cold,
            library_ms_warm=l_warm, l2_exceeded=[k_exc, l_exc],
            bound_ms=bound_ms(n_bytes, n_ops, flop_rate(bf16))[0])
        print(f"decode_attention at B={bb} (cache_len {lens[:bb].tolist()}): "
              f"kernel {k_cold:.4f} ms L2 cold, {k_warm:.4f} warm; "
              f"scaled_dot_product_attention {l_cold:.4f} ms cold, "
              f"{l_warm:.4f} warm; bound {by_batch[bb]['bound_ms']:.5f} ms "
              f"(graph replays, one call; L2 exceeded between reuses: kernel "
              f"{k_exc}, SDPA {l_exc}; {card})", flush=True)
    ms, library_ms = by_batch[b]["ms"], by_batch[b]["library_ms"]
    n_bytes, n_ops = attention_bytes_ops(q, k, lens)
    entry = kernel_entry("decode_attention",
                         "src/repro_torch/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:28", errs,
                         ms, plain_ms, n_bytes, n_ops, flop_rate(bf16),
                         library_ms)
    chunk, n_chunks = da.launch_plan(s, d)
    print(f"decode_attention time, qwen2-moe bf16 B={b} S={s}: {ms:.4f} ms "
          f"(graph replay, L2 cold; {by_batch[b]['ms_warm']:.4f} warm; "
          f"{ms_events:.4f} ms back to back); plain {plain_ms:.4f} ms; "
          f"scaled_dot_product_attention {library_ms:.4f} ms (L2 cold; "
          f"{by_batch[b]['library_ms_warm']:.4f} warm); bound "
          f"{entry['bound_ms']:.5f} ms ({entry['bound_by']}: "
          f"{n_bytes / 1e6:.2f} MB, {n_ops / 1e9:.4f} GFLOP), so the kernel "
          f"takes {ms / entry['bound_ms']:.1f}x its bound and "
          f"{ms / library_ms:.2f}x SDPA, L2 cold; {chunk}-position chunks, "
          f"{n_chunks} per (kv head, request), {k.shape[2] * b * n_chunks} "
          f"blocks ({card})", flush=True)
    results["decode_attention_kernel"] = entry
    results["decode_attention_detail"] = dict(
        batch=b, cache=s, cache_len=lens.tolist(), bytes=n_bytes, flop=n_ops,
        ms_back_to_back=ms_events, chunk=chunk, n_chunks=n_chunks,
        by_batch=by_batch)

    # --- grouped GEMM, routed by a full-width router ---
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    layer = moe.MoE(QWEN, Init(gen, dev), bf16)
    xt = draw(rng, (b, QWEN.d_model), bf16, dev)
    r = moe.route(layer, xt, QWEN)
    x, gl = r.x_cap, r.group_len
    e, c = x.shape[:2]
    gll = gl.tolist()
    print(f"grouped_gemm: {b} tokens top-{QWEN.top_k} over {e} experts, "
          f"capacity {c}: {sum(1 for n in gll if n)} live experts, "
          f"{sum(gll)} rows, group_len {gll} ({card})", flush=True)
    errs = []
    gate = gg.grouped_gemm_cuda(x, layer.w_gate, gl)
    up = gg.grouped_gemm_cuda(x, layer.w_up, gl)
    h = (F.silu(gate) * up).contiguous()
    down = gg.grouped_gemm_cuda(h, layer.w_down, gl)
    for name, xi, w, out in (("gate", x, layer.w_gate, gate),
                             ("down", h, layer.w_down, down)):
        label = f"{name} (K {w.shape[1]}, N {w.shape[2]})"
        errs.append((allclose_err(f"grouped_gemm kernel vs plain, {label}, "
                                  f"bf16", out, gg.grouped_gemm_plain(
                                      xi, w, gl), GG_TOL[bf16]),))
        x32, w32 = xi.float(), w.float()
        errs.append((allclose_err(
            f"grouped_gemm kernel vs plain, {label}, f32",
            gg.grouped_gemm_cuda(x32, w32, gl),
            gg.grouped_gemm_plain(x32, w32, gl), GG_TOL[f32]),))
        del x32, w32
        dead = torch.arange(c, device=dev)[None, :] >= gl[:, None]
        check(not bool(out[dead].any()),
              f"grouped_gemm {label}: a row past group_len is not 0")
    ex = next(i for i, n in enumerate(gll) if n)
    x2 = draw(rng, x.shape, bf16, dev)
    x2[ex, 0] = x[ex, 0]
    gate2 = gg.grouped_gemm_cuda(x2, layer.w_gate, torch.full_like(gl, c))
    check(torch.equal(gate2[ex, 0], gate[ex, 0]),
          "grouped_gemm: a row changed when the other rows changed")
    print(f"grouped_gemm: rows past group_len and the {gll.count(0)} empty "
          f"experts are exactly 0; expert {ex} row 0 equals itself bit for "
          f"bit with every other row changed", flush=True)

    live_rows = (torch.arange(c, device=dev)[None, :]
                 < gl[:, None])[..., None].to(bf16)
    shapes = (("gate/up", x, layer.w_gate), ("down", h, layer.w_down))
    t = {}
    for label, xi, w in shapes:
        t[label] = dict(
            ms=time_cuda_ms(lambda: gg.grouped_gemm_cuda(xi, w, gl), 50),
            plain_ms=time_cuda_ms(lambda: gg.grouped_gemm_plain(xi, w, gl),
                                  5),
            library_ms=time_cuda_ms(
                lambda: torch.bmm(xi, w).mul_(live_rows), 50),
            bytes_ops=gg_bytes_ops(xi, w, gl))
        n_bytes, n_ops = t[label]["bytes_ops"]
        b_ms, b_by = bound_ms(n_bytes, n_ops, flop_rate(bf16))
        t[label]["bound_ms"] = b_ms
        print(f"grouped_gemm time, {label}: {t[label]['ms']:.4f} ms; plain "
              f"{t[label]['plain_ms']:.4f} ms; torch.bmm + mask "
              f"{t[label]['library_ms']:.4f} ms; bound {b_ms:.4f} ms "
              f"({b_by}: {n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.4f} GFLOP), "
              f"so the kernel takes {t[label]['ms'] / b_ms:.1f}x its bound "
              f"({card})", flush=True)
    # one layer's three launches (gate, up, down), per launch
    per = lambda key: (2 * t["gate/up"][key] + t["down"][key]) / 3  # noqa: E731
    n_bytes = (2 * t["gate/up"]["bytes_ops"][0]
               + t["down"]["bytes_ops"][0]) / 3
    n_ops = (2 * t["gate/up"]["bytes_ops"][1] + t["down"]["bytes_ops"][1]) / 3
    entry = kernel_entry("grouped_gemm", "src/repro_torch/csrc/grouped_gemm.cu",
                         "src/repro/kernels/grouped_gemm.py:30", errs,
                         per("ms"), per("plain_ms"), n_bytes, n_ops,
                         flop_rate(bf16), per("library_ms"))
    print(f"grouped_gemm per launch over a layer's gate, up and down: "
          f"{entry['ms']:.4f} ms against a bound of {entry['bound_ms']:.4f} "
          f"ms ({entry['ms'] / entry['bound_ms']:.1f}x)", flush=True)
    results["grouped_gemm_kernel"] = entry
    results["grouped_gemm_detail"] = dict(
        tokens=b, group_len=gll, shapes={k2: {kk: vv for kk, vv in v2.items()
                                              if kk != "bytes_ops"}
                                         for k2, v2 in t.items()})
    family_kernel_rows(dev, card, results)


# the families phase's new kernel shapes: (label, Hq, Hkv, D, S, every
# request at full length) of decode attention at four families' self
# attention over the serving phase's cache, and llama-vision's cross
# attention over its 6,404 stub vision tokens (full length: every position
# is memory)
FAMILY_DA_ROWS = (
    ("h2o-danube-1.8b GQA 32/8 D 80", 32, 8, 80, MAX_LEN, False),
    ("seamless-m4t-large-v2 MHA 16/16 D 64", 16, 16, 64, MAX_LEN, False),
    ("starcoder2-15b GQA 48/4 (group 12)", 48, 4, 128, MAX_LEN, False),
    ("dbrx-132b GQA 48/8 (group 6)", 48, 8, 128, MAX_LEN, False),
    ("llama-3.2-vision-90b cross 64/8 (group 8), S 6404", 64, 8, 128, 6404,
     True),
    ("zamba2-2.7b MHA 32/32 D 80", 32, 32, 80, MAX_LEN, False),
)


def sdpa_call(qq, kk, vv, cc):
    """One PyTorch call for decode attention: SDPA with the boolean length
    mask (built, like the GQA expansion, outside the call)."""
    import torch.nn.functional as F

    g = qq.shape[1] // kk.shape[2]
    qs = qq[:, :, None, :]
    ks = kk.transpose(1, 2).repeat_interleave(g, dim=1)
    vs = vv.transpose(1, 2).repeat_interleave(g, dim=1)
    mask = (torch.arange(kk.shape[1], device=kk.device)[None, :]
            < cc[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)


def family_kernel_rows(dev, card, results):
    """The two serving kernels at the shapes the six families of the
    ``families`` phase give them (``FAMILY_DA_ROWS``; dbrx-132b's expert
    GEMMs): each in bf16 and fp32 against its plain version, every request
    or expert row bit-equal to its solo launch, NaN past cache_len never
    read, rows past group_len exactly 0; timed (bf16, L2 cold for decode
    attention) beside the plain version, one PyTorch call and the bound."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import grouped_gemm as gg
    from repro_torch.models import moe
    from repro_torch.models.common import Init

    bf16, f32 = torch.bfloat16, torch.float32
    rng = np.random.default_rng(24)
    b = MAX_BATCH
    rows = {}
    for label, hq, hkv, d, s, full in FAMILY_DA_ROWS:
        lens = (np.full(b, s) if full else np.concatenate(
            [[1, s], rng.integers(2, s, b - 2)])).astype(np.int32)
        cl = torch.from_numpy(lens).to(dev)
        errs = []
        for dtype in (f32, bf16):           # bf16 last: it is timed
            q = draw(rng, (b, hq, d), dtype, dev)
            k = draw(rng, (b, s, hkv, d), dtype, dev)
            v = draw(rng, (b, s, hkv, d), dtype, dev)
            got = da.decode_attention_cuda(q, k, v, cl)
            errs.append(allclose_err(
                f"decode_attention kernel vs plain, {label}, {dtype}", got,
                da.decode_attention_plain(q, k, v, cl), DA_TOL[dtype]))
            for i in range(b):
                solo = da.decode_attention_cuda(q[i:i + 1], k[i:i + 1],
                                                v[i:i + 1], cl[i:i + 1])
                check(torch.equal(solo[0], got[i]),
                      f"decode_attention {label} {dtype}: request {i} "
                      f"differs between its solo launch and the bucket")
            if not full:
                k2, v2 = k.clone(), v.clone()
                for i, n in enumerate(lens.tolist()):
                    k2[i, n:] = float("nan")
                    v2[i, n:] = float("nan")
                check(torch.equal(da.decode_attention_cuda(q, k2, v2, cl),
                                  got),
                      f"decode_attention {label} {dtype}: NaN stored past "
                      f"cache_len changed the result")
                del k2, v2
        # bf16 (the serving dtype) times, L2 cold by graph replays
        n_bytes, n_ops = attention_bytes_ops(q, k, lens)
        g = hq // hkv
        calls, k_exc = l2_cold_calls(
            lambda qq, kk, vv: lambda: da.decode_attention_cuda(qq, kk, vv,
                                                                cl),
            (q, k, v), n_bytes)
        ms = time_graph_ms(calls, 200)
        ms_warm = time_graph_ms(calls[0], 200)
        del calls
        lib, l_exc = l2_cold_calls(lambda qq, kk, vv: sdpa_call(qq, kk, vv,
                                                                cl),
                                   (q, k, v),
                                   2 * g * k.numel() * k.element_size())
        library_ms = time_graph_ms(lib, 50)
        del lib
        plain_ms = time_cuda_ms(lambda: da.decode_attention_plain(q, k, v,
                                                                  cl), 10)
        b_ms, b_by = bound_ms(n_bytes, n_ops, flop_rate(bf16))
        chunk, n_chunks = da.launch_plan(s, d)
        rows[label] = dict(hq=hq, hkv=hkv, d=d, s=s, cache_len=lens.tolist(),
                           max_abs_err=max(errs), ms=ms, ms_warm=ms_warm,
                           plain_ms=plain_ms, library_ms=library_ms,
                           bound_ms=b_ms, bound_by=b_by, chunk=chunk,
                           n_chunks=n_chunks, l2_exceeded=[k_exc, l_exc])
        print(f"decode_attention {label} bf16 B={b}: {ms:.4f} ms L2 cold "
              f"({ms_warm:.4f} warm; graph replays); plain {plain_ms:.4f} "
              f"ms; scaled_dot_product_attention {library_ms:.4f} ms (L2 "
              f"cold); bound {b_ms:.5f} ms ({b_by}), so {ms / b_ms:.1f}x its "
              f"bound and {ms / library_ms:.2f}x SDPA; {chunk}-position "
              f"chunks, {n_chunks} per (kv head, request) ({card})",
              flush=True)
        del q, k, v
    print(f"decode_attention: the {len(FAMILY_DA_ROWS)} family shapes "
          f"within tolerance of the plain version in bf16 and fp32, every "
          f"request equal to its solo launch bit for bit, NaN past "
          f"cache_len never read", flush=True)

    # dbrx-132b's expert GEMMs, routed by a full-width router
    cfg = get_config("dbrx-132b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    layer = moe.MoE(cfg, Init(gen, dev), bf16)
    r = moe.route(layer, draw(rng, (b, cfg.d_model), bf16, dev), cfg)
    x, gl = r.x_cap, r.group_len
    e, c = x.shape[:2]
    gll = gl.tolist()
    check(c == moe.expert_capacity(b, cfg),
          f"dbrx capacity {c} != expert_capacity({b})")
    gate = gg.grouped_gemm_cuda(x, layer.w_gate, gl)
    h = (F.silu(gate) * gg.grouped_gemm_cuda(x, layer.w_up, gl)).contiguous()
    down = gg.grouped_gemm_cuda(h, layer.w_down, gl)
    live_rows = (torch.arange(c, device=dev)[None, :]
                 < gl[:, None])[..., None].to(bf16)
    dead = live_rows[..., 0] == 0
    gg_rows = {}
    for name, xi, w, out in (("gate/up", x, layer.w_gate, gate),
                             ("down", h, layer.w_down, down)):
        label = f"dbrx-132b {name} ({e}, {c}, {w.shape[1]}) @ ({e}, " \
                f"{w.shape[1]}, {w.shape[2]})"
        errs = [allclose_err(f"grouped_gemm kernel vs plain, {label}, bf16",
                             out, gg.grouped_gemm_plain(xi, w, gl),
                             GG_TOL[bf16])]
        x32, w32 = xi.float(), w.float()
        errs.append(allclose_err(
            f"grouped_gemm kernel vs plain, {label}, f32",
            gg.grouped_gemm_cuda(x32, w32, gl),
            gg.grouped_gemm_plain(x32, w32, gl), GG_TOL[f32]))
        del x32, w32
        check(not bool(out[dead].any()),
              f"grouped_gemm {label}: a row past group_len is not 0")
        ex = next(i for i, n in enumerate(gll) if n)
        x2 = draw(rng, tuple(xi.shape), bf16, dev)
        x2[ex, 0] = xi[ex, 0]
        check(torch.equal(gg.grouped_gemm_cuda(x2, w, torch.full_like(gl, c))
                          [ex, 0], out[ex, 0]),
              f"grouped_gemm {label}: a row changed when the other rows "
              f"changed")
        del x2
        n_bytes, n_ops = gg_bytes_ops(xi, w, gl)
        b_ms, b_by = bound_ms(n_bytes, n_ops, flop_rate(bf16))
        gg_rows[name] = dict(
            shape=[e, c, int(w.shape[1]), int(w.shape[2])], group_len=gll,
            max_abs_err=max(errs),
            ms=time_cuda_ms(lambda: gg.grouped_gemm_cuda(xi, w, gl), 20),
            plain_ms=time_cuda_ms(lambda: gg.grouped_gemm_plain(xi, w, gl),
                                  3),
            library_ms=time_cuda_ms(lambda: torch.bmm(xi, w).mul_(live_rows),
                                    20),
            bound_ms=b_ms, bound_by=b_by, bytes=n_bytes, flop=n_ops)
        row = gg_rows[name]
        print(f"grouped_gemm {label} bf16, {sum(gll)} live rows in "
              f"{sum(1 for n in gll if n)} experts: {row['ms']:.4f} ms; "
              f"plain {row['plain_ms']:.4f} ms; torch.bmm + mask "
              f"{row['library_ms']:.4f} ms; bound {b_ms:.4f} ms ({b_by}: "
              f"{n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.4f} GFLOP), so "
              f"{row['ms'] / b_ms:.2f}x its bound ({card})", flush=True)
    print(f"grouped_gemm: dbrx-132b's shapes within tolerance in bf16 and "
          f"fp32, rows past group_len and the {gll.count(0)} empty experts "
          f"exactly 0, a row bit-equal with every other row changed",
          flush=True)
    results["family_kernel_rows"] = dict(decode_attention=rows,
                                         grouped_gemm=gg_rows)


def phase_serving_path(dev, card, results):
    """qwen2-moe-a2.7b at full width and depth in bf16 behind
    ``ServingEngine(max_batch=8, max_len=1024)``: 12 requests, every one
    done, the kernels launched 24x and 72x per engine launch, each emitted
    token the argmax of its solo replay (or within LOGIT_TOL of it); three
    replays through the kernels hook (item 14 of the module docstring)."""
    from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as cfg
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import grouped_gemm as gg
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_mod
    from repro_torch.serving import Request, ServingEngine

    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    m = model_mod.init_params(cfg, seed=0, device=dev)
    sync()
    init_s = time.perf_counter() - t0
    pbytes = sum(p.numel() * p.element_size() for p in m.parameters())
    init_peak = torch.cuda.max_memory_allocated(dev)
    print(f"serving: {cfg.name} at full width and depth ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, {cfg.n_experts} experts "
          f"top-{cfg.top_k}), {cfg.dtype}, {pbytes / 1e9:.2f} GB of weights "
          f"({cfg.param_count() / 1e9:.2f} B by ModelConfig) drawn on the card in "
          f"{init_s:.1f} s, peak {init_peak / 2**30:.2f} GiB ({card})",
          flush=True)

    kw = dict(max_batch=MAX_BATCH, max_len=MAX_LEN, device=dev)
    warm = ServingEngine(cfg, m, **kw)      # every bucket once
    for i in range(MAX_BATCH):
        warm.submit(Request(-1 - i, [1 + i, 2 + i], max_new_tokens=1 + i))
    warm.run()
    check(set(warm.stats["aggregated_hist"]) == {1, 2, 4, 8},
          f"warmup buckets {warm.stats['aggregated_hist']}")
    del warm

    rng = np.random.default_rng(2026)
    plens = [int(n) for n in rng.integers(8, 97, 11)] + [640]
    news = [int(n) for n in rng.integers(8, 25, 12)]
    reqs = [Request(i, [int(t) for t in rng.integers(0, cfg.vocab_size, n)],
                    max_new_tokens=new)
            for i, (n, new) in enumerate(zip(plens, news))]
    eng = timed_engine(cfg, m, **kw)
    for r in reqs:
        eng.submit(r)
    torch.cuda.reset_peak_memory_stats(dev)
    sync()
    zero_launch_counts()
    t0 = time.perf_counter()
    eng.run(max_steps=10_000)
    sync()
    wall = time.perf_counter() - t0
    n_da = kernel_launches(da.decode_attention_cuda)
    n_gg = kernel_launches(gg.grouped_gemm_cuda)
    peak = torch.cuda.max_memory_allocated(dev)
    launches = eng.stats["launches"]
    hist = dict(sorted(eng.stats["aggregated_hist"].items()))
    check(all(r.done and not r.failed and len(r.output) == r.max_new_tokens
              for r in reqs), "not every request was served")
    check(n_da == cfg.n_layers * launches and
          n_gg == 3 * cfg.n_layers * launches,
          f"kernel launches decode_attention {n_da}, grouped_gemm {n_gg}, "
          f"engine launches {launches}: want {cfg.n_layers}x and "
          f"{3 * cfg.n_layers}x")
    check(set(hist) == {1, 2, 4, 8}, f"buckets {hist}: want 1, 2, 4 and 8")
    prefill = sum(len(r.prompt) - 1 for r in reqs)
    tokens = eng.stats["tokens"]
    step_ms = {bk: float(np.mean(v)) for bk, v in
               sorted(eng.launch_ms.items())}
    print(f"serving: {len(reqs)} requests (prompts {plens}, new tokens "
          f"{news}) served in {wall:.2f} s after warmup: {tokens} tokens "
          f"emitted, {tokens / wall:.2f} tok/s ({(tokens + prefill) / wall:.2f}"
          f" tok/s counting the {prefill} prefill tokens); {launches} engine "
          f"launches, buckets {hist}; decode_attention_cuda {n_da} launches, "
          f"grouped_gemm_cuda {n_gg}; peak {peak / 2**30:.2f} GiB ({card})",
          flush=True)
    print("serving: ms per engine launch by bucket: " + ", ".join(
        f"{bk}: {v:.2f}" for bk, v in step_ms.items()), flush=True)
    copies = {}
    for bk in (1, 2, 4, 8):
        idx = torch.arange(bk, device=dev)
        sub = eng._gather(idx)
        copies[bk] = dict(
            gather_ms=time_cuda_ms(lambda: eng._gather(idx), 10),
            scatter_ms=time_cuda_ms(lambda: eng._scatter(idx, sub), 10),
            bytes_each_way=sum(t.numel() * t.element_size()
                               for t in sub.values()))
        print(f"serving: bucket {bk}: gather {copies[bk]['gather_ms']:.4f} ms"
              f", scatter {copies[bk]['scatter_ms']:.4f} ms "
              f"({copies[bk]['bytes_each_way'] / 1e9:.3f} GB each way; "
              f"{card})", flush=True)
        del sub

    def replay(model, req, kernels):
        return replay_alone(model, req, kernels, MAX_LEN)

    t0 = time.perf_counter()
    kept, n_steps, n_near = {}, 0, 0
    worst_margin_ratio = 0.0
    by_steps = sorted(reqs, key=lambda r: len(r.prompt) + len(r.output))
    plain_ids = {r.rid for r in by_steps[:3]}
    for r in reqs:
        hook = RoutingRecorder(ops) if r.rid in plain_ids else ops
        lg = replay(m, r, hook)
        top = lg.topk(2, dim=-1)
        margin = top.values[:, 0] - top.values[:, 1]
        tol = LOGIT_TOL * lg.abs().amax(dim=-1)
        emitted = torch.tensor(r.output, device=dev)
        differ = top.indices[:, 0] != emitted
        check(bool((~differ | (margin < tol)).all()),
              f"request {r.rid}: an emitted token is not the replay's argmax "
              f"and the replay's top-2 margin exceeds {LOGIT_TOL:g} x max "
              f"|logit|")
        n_steps += len(r.output)
        n_near += int(differ.sum())
        worst_margin_ratio = max(worst_margin_ratio, float(
            (margin[differ] / tol[differ]).max()) if bool(differ.any())
            else 0.0)
        if r.rid in plain_ids:
            kept[r.rid] = (lg, hook.live)
    replay_s = time.perf_counter() - t0
    print(f"serving: replay of every request alone: {n_steps} emitted "
          f"tokens, {n_near} not the replay's argmax (each within the top-2 "
          f"margin tolerance {LOGIT_TOL:g} x max|logit|; worst margin "
          f"{worst_margin_ratio:.3f} of it), {replay_s:.1f} s", flush=True)
    # the plain versions swapped in through decode_step's kernels hook.
    # (1) bf16, full depth: a hook that launches each kernel and holds it to
    # its plain version on the same inputs, all along three replays
    held = CheckedKernels()
    for r in by_steps[:3]:
        replay(m, r, held)
    print(f"serving: requests {sorted(plain_ids)} replayed with every kernel "
          f"launch held to its plain version on the same inputs: "
          f"decode_attention {held.calls['decode_attention']} launches, max "
          f"abs err {held.max_err['decode_attention']:.3e}; grouped_gemm "
          f"{held.calls['grouped_gemm']} launches, max abs err "
          f"{held.max_err['grouped_gemm']:.3e} (atol = rtol = "
          f"{DA_TOL[torch.bfloat16]:g})", flush=True)
    # (2) bf16, full depth, the plain versions alone: a rounding difference
    # that flips one of the 60-way top-4 routing choices moves the rest of
    # the replay, so this divergence is printed (with the routing choices
    # that differ), not bounded
    diverge = []
    for r in by_steps[:3]:
        lg, live = kept[r.rid]
        rec = RoutingRecorder(ops.PLAIN_LM)
        pl = replay(m, r, rec)
        rel = (pl - lg).abs().amax(dim=-1) / lg.abs().amax(dim=-1)
        flips = [i for i, (a, b) in enumerate(zip(live, rec.live)) if a != b]
        first = divmod(flips[0], cfg.n_layers) if flips else None
        diverge.append(dict(rid=r.rid, steps=len(r.output),
                            max_rel=float(rel.max()),
                            median_rel=float(rel.median()),
                            argmax_differs=int((pl.argmax(-1)
                                                != lg.argmax(-1)).sum()),
                            routing_choices=len(live),
                            routing_differs=len(flips),
                            first_differs_step_layer=first))
        print(f"serving: request {r.rid} replayed with the plain versions "
              f"({cfg.dtype}, {cfg.n_layers} layers): logits differ from the "
              f"kernels' by {diverge[-1]['median_rel']:.4f} (median) to "
              f"{diverge[-1]['max_rel']:.4f} (max) of max|logit| over "
              f"{len(r.output)} steps; argmax differs at "
              f"{diverge[-1]['argmax_differs']}; {len(flips)} of {len(live)} "
              f"layer routings differ, the first at (step, layer) {first} "
              f"(not bounded)", flush=True)
    # (3) fp32 at full width, F32_LAYERS layers: the same replays with the
    # kernels and with the plain versions agree within F32_LOGIT_TOL
    cfg32 = cfg.replace(n_layers=F32_LAYERS, dtype="float32")
    m32 = model_mod.init_params(cfg32, seed=0, device=dev)
    f32_rel = []
    for r in by_steps[:3]:
        rk, rp = RoutingRecorder(ops), RoutingRecorder(ops.PLAIN_LM)
        lk = replay(m32, r, rk)
        lp = replay(m32, r, rp)
        rel = (lp - lk).abs().amax(dim=-1) / lk.abs().amax(dim=-1)
        f32_rel.append(float(rel.max()))
        flips = sum(a != b for a, b in zip(rk.live, rp.live))
        check(bool((rel <= F32_LOGIT_TOL).all()),
              f"request {r.rid}, fp32 {F32_LAYERS} layers: the plain "
              f"versions' logits differ from the kernels' by "
              f"{f32_rel[-1]:.3e} > {F32_LOGIT_TOL:g} of max|logit|")
        print(f"serving: request {r.rid} replayed in fp32 ({F32_LAYERS} "
              f"layers, full width) with the kernels and with the plain "
              f"versions: logits within {f32_rel[-1]:.3e} of max|logit| "
              f"(bound {F32_LOGIT_TOL:g}) over {len(r.output)} steps; "
              f"{flips} of {len(rk.live)} layer routings differ", flush=True)
    del m32
    results["serving_path"] = dict(
        config=cfg.name, params_bytes=pbytes, init_s=init_s,
        init_peak_bytes=init_peak, requests=len(reqs), prompt_lens=plens,
        new_tokens=news, wall_s=wall, tokens=tokens, prefill_tokens=prefill,
        tokens_per_s=tokens / wall, launches=launches, buckets=hist,
        ms_per_launch_by_bucket=step_ms, copies=copies, peak_bytes=peak,
        decode_attention_launches=n_da, grouped_gemm_launches=n_gg,
        replay_steps=n_steps, replay_not_argmax=n_near,
        replay_worst_margin_over_tol=worst_margin_ratio,
        logit_tol=LOGIT_TOL, held_calls=held.calls,
        held_max_err=held.max_err, plain_divergence=diverge,
        f32_layers=F32_LAYERS, f32_plain_max_rel=f32_rel,
        f32_logit_tol=F32_LOGIT_TOL)
    results["decode_attention_kernel"]["launches"] = n_da
    results["grouped_gemm_kernel"]["launches"] = n_gg


# the families phase: each architecture at published widths in bf16, at
# its published depth (None) unless one 80 GB card or the run's time
# forces a cut, and why
FAMILY_DEPTHS = (
    ("h2o-danube-1.8b", None, ""),
    ("starcoder2-15b", None, ""),
    ("seamless-m4t-large-v2", None, ""),
    ("qwen1.5-32b", 32, "its 64 layers are 70.4 GB of bf16 weights, which "
     "leave too little of the card's 80 GB for the engine's caches, the "
     "replays' plain versions and the fp32 check"),
    ("dbrx-132b", 4, "its 40 layers are 263 GB of bf16 weights, three "
     "cards' memory"),
    ("llama-3.2-vision-90b", 10, "its 100 layers are 175 GB of bf16 "
     "weights; 10 keep two groups of 4 self-attention blocks and a gated "
     "cross-attention block over the full 6,404 stub vision tokens"),
    ("xlstm-125m", None, ""),
    ("zamba2-2.7b", None, ""),
)
FAMILY_REQUESTS = 6
FAMILY_PROMPTS = (4, 32)        # prompt lengths, drawn in this range
FAMILY_NEW_TOKENS = 8
FAMILY_MAX_LEN = 256
FAMILY_PROFILED_STEPS = 4       # decode launches profiled per bucket


def attention_reads(cfg):
    """Decode-attention launches per decode step: one per self-attention
    layer, one per vlm cross block, two per enc-dec decoder layer, one per
    application of the hybrid's shared block, none for the ssm family."""
    if cfg.family == "vlm":
        return cfg.n_layers // cfg.cross_attn_every * cfg.cross_attn_every
    if cfg.family == "audio":
        return 2 * cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every
    if cfg.family == "ssm":
        return 0
    return cfg.n_layers


def f32_layers(cfg):
    """The fp32 check's depth: ``F32_LAYERS``, or one whole group where
    the family stacks groups (a vlm, ssm or hybrid model of fewer layers
    would hold no group at all)."""
    every = {"vlm": cfg.cross_attn_every, "ssm": cfg.slstm_every,
             "hybrid": cfg.shared_attn_every}.get(cfg.family)
    return every or F32_LAYERS


def profile_buckets(cfg, m, dev, buckets=(1, MAX_BATCH)):
    """Device busy per decode launch from ``torch.profiler`` and the
    profiled host ms per launch, at each bucket: that many one-token
    requests decoding ``FAMILY_PROFILED_STEPS`` tokens (the first launch,
    which admits them, stays out of the window)."""
    from repro_torch.serving import Request, ServingEngine

    out = {}
    for bk in buckets:
        eng = ServingEngine(cfg, m, max_batch=MAX_BATCH,
                            max_len=FAMILY_MAX_LEN, device=dev)
        for i in range(bk):
            eng.submit(Request(i, [1 + i], max_new_tokens=1
                               + FAMILY_PROFILED_STEPS))
        eng.step()
        sync()

        def window():
            t0 = time.perf_counter()
            for _ in range(FAMILY_PROFILED_STEPS):
                eng.step()
            sync()
            return (time.perf_counter() - t0) * 1e3

        wall, prof = profiled(window)
        busy = sum(us for _, us in device_events(prof)) / 1e3
        out[bk] = dict(host_ms=wall / FAMILY_PROFILED_STEPS,
                       busy_ms=busy / FAMILY_PROFILED_STEPS,
                       idle_share=max(0.0, 1.0 - busy / wall))
        del eng, prof
    return out


def serve_family(arch, layers, why, dev, card):
    """One architecture behind ``ServingEngine(max_batch=8, max_len=256)``
    (module docstring, item 17); returns its measurements."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import grouped_gemm as gg
    from repro_torch.kernels import ops
    from repro_torch.models import model as model_mod
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config(arch)
    depth = (f"{cfg.n_layers} layers, the published depth" if layers is None
             else f"{layers} of {cfg.n_layers} layers: {why}")
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    m = model_mod.init_params(cfg, seed=0, device=dev)
    sync()
    init_s = time.perf_counter() - t0
    pbytes = sum(p.numel() * p.element_size() for p in m.parameters())
    print(f"families: {cfg.name} ({cfg.family}, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.resolved_head_dim}"
          f"), {depth}; {pbytes / 1e9:.2f} GB of {cfg.dtype} weights drawn "
          f"in {init_s:.1f} s ({card})", flush=True)

    kw = dict(max_batch=MAX_BATCH, max_len=FAMILY_MAX_LEN, device=dev)
    warm = ServingEngine(cfg, m, **kw)      # every bucket once
    for i in range(MAX_BATCH):
        warm.submit(Request(-1 - i, [1 + i, 2 + i], max_new_tokens=1 + i))
    warm.run()
    check(set(warm.stats["aggregated_hist"]) == {1, 2, 4, 8},
          f"{cfg.name}: warmup buckets {warm.stats['aggregated_hist']}")
    del warm

    rng = np.random.default_rng(17)
    lo, hi = FAMILY_PROMPTS
    plens = [int(n) for n in rng.integers(lo, hi + 1, FAMILY_REQUESTS)]
    reqs = [Request(i, [int(t) for t in rng.integers(0, cfg.vocab_size, n)],
                    max_new_tokens=FAMILY_NEW_TOKENS)
            for i, n in enumerate(plens)]
    eng = timed_engine(cfg, m, **kw)
    for r in reqs:
        eng.submit(r)
    sync()
    zero_launch_counts()
    t0 = time.perf_counter()
    eng.run(max_steps=10_000)
    sync()
    wall = time.perf_counter() - t0
    n_da = kernel_launches(da.decode_attention_cuda)
    n_gg = kernel_launches(gg.grouped_gemm_cuda)
    launches = eng.stats["launches"]
    hist = dict(sorted(eng.stats["aggregated_hist"].items()))
    reads = attention_reads(cfg)
    n_gemm = 3 * cfg.n_layers if cfg.n_experts else 0
    check(all(r.done and not r.failed and len(r.output) == r.max_new_tokens
              for r in reqs), f"{cfg.name}: not every request was served")
    check(nonzero_launch_counts() == {
        k: v for k, v in (("decode_attention_cuda", reads * launches),
                          ("grouped_gemm_cuda", n_gemm * launches)) if v},
          f"{cfg.name}: kernel launches {nonzero_launch_counts()} over "
          f"{launches} engine launches: want decode_attention {reads}x and "
          f"grouped_gemm {n_gemm}x")
    tokens = eng.stats["tokens"]
    step_ms = {bk: float(np.mean(v)) for bk, v in
               sorted(eng.launch_ms.items())}
    copies = {}
    for bk in (1, MAX_BATCH):
        idx = torch.arange(bk, device=dev)
        sub = eng._gather(idx)
        copies[bk] = dict(
            gather_ms=time_cuda_ms(lambda: eng._gather(idx), 5),
            scatter_ms=time_cuda_ms(lambda: eng._scatter(idx, sub), 5),
            gather_bytes=sum(t.numel() * t.element_size()
                             for t in sub.values()))
        del sub
    del eng
    prof = profile_buckets(cfg, m, dev)
    print(f"families: {cfg.name}: {len(reqs)} requests (prompts {plens}, "
          f"{FAMILY_NEW_TOKENS} new tokens each) in {wall:.2f} s: {tokens} "
          f"tokens, {tokens / wall:.1f} tok/s; {launches} engine launches, "
          f"buckets {hist}; decode_attention_cuda {n_da} launches ({reads} "
          f"per launch), grouped_gemm_cuda {n_gg} ({n_gemm} per launch); "
          f"host ms per launch by bucket "
          + ", ".join(f"{bk}: {v:.2f}" for bk, v in step_ms.items())
          + "; profiled: " + ", ".join(
              f"bucket {bk} busy {p['busy_ms']:.3f} ms of {p['host_ms']:.3f} "
              f"ms per launch (idle share {p['idle_share']:.3f})"
              for bk, p in prof.items())
          + "; gather per launch: " + ", ".join(
              f"bucket {bk} {c['gather_ms']:.4f} ms "
              f"({c['gather_bytes'] / 1e6:.1f} MB)"
              for bk, c in copies.items())
          + f" ({card})", flush=True)

    # each request alone: an emitted token is its replay's argmax, or the
    # replay's top-2 margin is below LOGIT_TOL x max|logit|
    n_near = 0
    for r in reqs:
        lg = replay_alone(m, r, ops, FAMILY_MAX_LEN)
        top = lg.topk(2, dim=-1)
        margin = top.values[:, 0] - top.values[:, 1]
        differ = top.indices[:, 0] != torch.tensor(r.output, device=dev)
        check(bool((~differ | (margin < LOGIT_TOL * lg.abs().amax(dim=-1)))
                   .all()),
              f"{cfg.name} request {r.rid}: an emitted token is not its "
              f"solo replay's argmax beyond the margin tolerance")
        n_near += int(differ.sum())
    # one replay with every kernel launch held to its plain version
    shortest = min(reqs, key=lambda r: len(r.prompt))
    held = CheckedKernels()
    replay_alone(m, shortest, held, FAMILY_MAX_LEN)
    check(held.calls["decode_attention"] == reads * (
        len(shortest.prompt) - 1 + FAMILY_NEW_TOKENS),
          f"{cfg.name}: held replay launched decode_attention "
          f"{held.calls['decode_attention']} times")
    peak = torch.cuda.max_memory_allocated(dev)
    del m
    gc.collect()
    torch.cuda.empty_cache()

    # fp32 at full width and F32_LAYERS layers (one whole group where
    # the family has groups): the kernels' logits and the plain versions'
    # agree within F32_LOGIT_TOL
    kw32 = dict(dtype="float32", n_layers=f32_layers(cfg))
    if cfg.family == "audio":
        kw32["n_encoder_layers"] = F32_LAYERS
    m32 = model_mod.init_params(cfg.replace(**kw32), seed=0, device=dev)
    lk = replay_alone(m32, shortest, ops, FAMILY_MAX_LEN)
    lp = replay_alone(m32, shortest, ops.PLAIN_LM, FAMILY_MAX_LEN)
    f32_rel = float(((lp - lk).abs().amax(dim=-1)
                     / lk.abs().amax(dim=-1)).max())
    check(f32_rel <= F32_LOGIT_TOL,
          f"{cfg.name} fp32 {kw32['n_layers']} layers: the plain versions' "
          f"logits differ from the kernels' by {f32_rel:.3e} of max|logit|")
    del m32
    gc.collect()
    torch.cuda.empty_cache()
    print(f"families: {cfg.name}: every emitted token its solo replay's "
          f"argmax ({n_near} within the top-2 margin tolerance); request "
          f"{shortest.rid} replayed with every kernel launch held to its "
          f"plain version (decode_attention {held.calls['decode_attention']}"
          f" launches, max abs err {held.max_err['decode_attention']:.3e}; "
          f"grouped_gemm {held.calls['grouped_gemm']}, "
          f"{held.max_err['grouped_gemm']:.3e}); fp32 at {kw32['n_layers']} "
          f"layers: plain within {f32_rel:.3e} of max|logit| of the kernels "
          f"(bound {F32_LOGIT_TOL:g}); peak {peak / 2**30:.2f} GiB ({card})",
          flush=True)
    return dict(layers=cfg.n_layers, depth=depth, params_bytes=pbytes,
                init_s=init_s, prompt_lens=plens, wall_s=wall, tokens=tokens,
                tokens_per_s=tokens / wall, launches=launches, buckets=hist,
                decode_attention_launches=n_da, grouped_gemm_launches=n_gg,
                attention_reads_per_launch=reads,
                ms_per_launch_by_bucket=step_ms, profiled=prof,
                copies=copies, replay_not_argmax=n_near,
                held_calls=held.calls, held_max_err=held.max_err,
                f32_layers=kw32["n_layers"], f32_plain_max_rel=f32_rel,
                peak_bytes=peak)


# the mixer check: one layer of each recurrent mixer at its published
# width in fp32, the chunked form over two chunks of the published 256
# against as many decode steps, at the reference's decode-equals-forward
# tolerance (tests/test_models.py)
MIXER_TOKENS = 512
MIXER_BATCH = 2
MIXER_ATOL, MIXER_RTOL = 2e-4, 2e-3


def mixer_check(dev, card):
    """Mamba2 at zamba2-2.7b's width, mLSTM and sLSTM at xlstm-125m's, one
    layer each in fp32 with seeded weights (the biases, ``D`` and the
    norm weights drawn too, mLSTM's input-gate biases up to 6 so its
    stabiliser leaves 0): the chunked forward over ``MIXER_TOKENS`` tokens
    against that many decode steps from the fresh state, within
    ``MIXER_ATOL`` + ``MIXER_RTOL`` |y|; returns each mixer's error and
    times."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.models.common import Init

    gen = torch.Generator(device=dev)
    gen.manual_seed(25)
    rng = np.random.default_rng(25)
    mixers = (
        ("Mamba2", "zamba2-2.7b", ssm.Mamba2, ssm.mamba2_apply,
         lambda cfg: ssm.mamba2_state_init(cfg, MIXER_BATCH, torch.float32,
                                           dev)),
        ("mLSTM", "xlstm-125m", ssm.MLSTM, ssm.mlstm_apply,
         lambda cfg: ssm.mlstm_state_init(cfg, MIXER_BATCH, dev)),
        ("sLSTM", "xlstm-125m", ssm.SLSTM, ssm.slstm_apply,
         lambda cfg: ssm.slstm_state_init(cfg, MIXER_BATCH, dev)))
    out = {}
    for name, arch, cls, apply, fresh in mixers:
        cfg = get_config(arch).replace(dtype="float32")
        check(MIXER_TOKENS == 2 * cfg.ssm_chunk,
              f"mixers: {arch}'s chunk {cfg.ssm_chunk} is not half of "
              f"{MIXER_TOKENS} tokens")
        layer = cls(cfg, Init(gen, dev), torch.float32)
        with torch.no_grad():
            for pname, p in layer.named_parameters():
                shape = tuple(p.shape)
                if pname in ("conv_b", "dt_bias", "b"):
                    p.copy_(draw(rng, shape, p.dtype, dev, 0.2))
                elif pname in ("D", "norm_w"):
                    p.copy_(1.0 + draw(rng, shape, p.dtype, dev, 0.2))
                elif pname == "b_if":
                    h = shape[0] // 2
                    p[:h] = torch.from_numpy(rng.uniform(0.0, 6.0, h)
                                             .astype(np.float32)).to(dev)
                    p[h:] = 2.0 + draw(rng, (h,), p.dtype, dev)
        x = draw(rng, (MIXER_BATCH, MIXER_TOKENS, cfg.d_model),
                 torch.float32, dev, 0.5)
        sync()
        t0 = time.perf_counter()
        full, _ = apply(layer, x, cfg)
        sync()
        chunked_ms = (time.perf_counter() - t0) * 1e3
        state, rows = fresh(cfg), []
        t0 = time.perf_counter()
        for i in range(MIXER_TOKENS):
            y, state = apply(layer, x[:, i:i + 1], cfg, state=state)
            rows.append(y)
        steps = torch.cat(rows, dim=1)
        sync()
        steps_ms = (time.perf_counter() - t0) * 1e3
        diff = (steps - full).abs()
        err = float(diff.max())
        check(bool(torch.isfinite(full).all() and torch.isfinite(steps).all()),
              f"mixers: {name} output not finite")
        check(bool((diff <= MIXER_ATOL + MIXER_RTOL * full.abs()).all()),
              f"mixers: {name}'s {MIXER_TOKENS} decode steps differ from "
              f"its chunked form by {err:.3e}")
        out[name] = dict(arch=arch, d_model=cfg.d_model, max_abs_err=err,
                         max_abs_y=float(full.abs().max()),
                         chunked_ms=chunked_ms, steps_ms=steps_ms)
        print(f"mixers: {name} at {arch}'s width (d_model {cfg.d_model}), "
              f"fp32, B {MIXER_BATCH}: the chunked form over {MIXER_TOKENS} "
              f"tokens ({MIXER_TOKENS // cfg.ssm_chunk} chunks of "
              f"{cfg.ssm_chunk}) equals {MIXER_TOKENS} decode steps within "
              f"{err:.3e} (max |y| {out[name]['max_abs_y']:.3e}; atol "
              f"{MIXER_ATOL:g}, rtol {MIXER_RTOL:g}); chunked "
              f"{chunked_ms:.1f} ms, steps {steps_ms:.1f} ms host ({card})",
              flush=True)
        del layer, x, full, steps, rows, state
    return out


def phase_families(dev, card, results):
    """The recurrent mixers' check, then the eight families beside the
    serving path's qwen2-moe-a2.7b, one after the other, each freed before
    the next."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mixers = mixer_check(dev, card)
    out = {}
    for arch, layers, why in FAMILY_DEPTHS:
        out[arch] = serve_family(arch, layers, why, dev, card)
    seconds = time.perf_counter() - t0
    print(f"families: {len(out)} architectures served in {seconds:.1f} s",
          flush=True)
    results["families"] = dict(card=card, seconds=seconds, mixers=mixers,
                               archs=out)


# ---------------------------------------------------------------------------
# training: reduced runs of every architecture, resume, full-width steps
# ---------------------------------------------------------------------------

TRAIN_REDUCED_STEPS = 30    # the reference's loss-decrease bar's run
TRAIN_REDUCED = dict(seq_len=64, batch_size=8, lr=3e-3, total_steps=50)
TRAIN_FIRST_STEP_RTOL = 1e-4
RESUME_STEPS, RESUME_KILL_AT = 6, 3
RESUME_ARCHS = ("granite-8b", "qwen2-moe-a2.7b", "xlstm-125m",
                "zamba2-2.7b", "llama-3.2-vision-90b",
                "seamless-m4t-large-v2")     # one per family
# one full-width step: TRAIN_4K's length, global batch 4 in 2 microbatches
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICROBATCH = 4096, 4, 2
# state per parameter under microbatch 2: bf16 weights and gradients, and
# fp32 m, v and gradient accumulation buffers (2 + 2 + 4 + 4 + 4)
TRAIN_BYTES_PER_PARAM = 16
# (arch, layers or None for the published depth or 0 for no step, why);
# parameters counted on the meta device; each cut keeps 16 B per
# parameter within ~64 GiB, leaving ~15 GiB of the card's 79.1 GiB for
# the activations of one 2 x 4,096-token microbatch under remat
TRAIN_DEPTHS = (
    ("granite-8b", 18, "18 of 36 layers: 4.13 B parameters, 61.5 GiB of "
     "state at 16 B each (36 would be 8.05 B, 120 GiB)"),
    ("starcoder2-15b", 9, "9 of 40 layers: 4.06 B parameters, 60.5 GiB "
     "(40 would be 15.96 B, 238 GiB)"),
    ("qwen1.5-32b", 5, "5 of 64 layers: 4.19 B parameters, 62.4 GiB; its "
     "152,064-token vocabulary holds 1.56 B of them"),
    ("h2o-danube-1.8b", None, ""),
    ("dbrx-132b", 1, "1 of 40 layers: 4.49 B parameters (16 experts of "
     "6144 x 10752 x 3), 66.9 GiB; two would be 7.75 B, 115 GiB"),
    ("qwen2-moe-a2.7b", 6, "6 of 24 layers: 4.05 B parameters (60 "
     "experts each), 60.4 GiB (24 would be 14.32 B, 213 GiB)"),
    ("xlstm-125m", 0, "time, not memory (4.8 GiB at one group): the sLSTM "
     "steps through the 4,096 positions one by one in eager PyTorch, "
     "forward, recompute and backward, ~0.7 M kernels per step: one group "
     "of 4 layers took 36.4 s of host per step and its profiled step "
     "~5 min, beyond this script's time"),
    ("seamless-m4t-large-v2", None, ""),
    ("zamba2-2.7b", None, ""),
    ("llama-3.2-vision-90b", 0, "its smallest whole group (4 self blocks "
     "and a gated cross block) with the 128,256-token embedding and head "
     "holds 6.38 B parameters, 95.1 GiB of state at 16 B each (71.3 GiB at "
     "12 B without accumulation), beyond the card's 80 GB at any batch"),
)

TRAIN_RESUME_CHILD = """
import os, signal, sys
from repro_torch.launch import train as t
save = t.save_state


def save_then_die(ckpt_dir, step, *args, **kw):
    path = save(ckpt_dir, step, *args, **kw)
    if step == int(sys.argv[3]):
        os.kill(os.getpid(), signal.SIGKILL)
    return path


t.save_state = save_then_die
t.train(sys.argv[1], int(sys.argv[4]), 64, 8, True, sys.argv[2],
        save_every=1, lr=3e-3, microbatch=2, total_steps=50,
        log_every=1000, device=sys.argv[5])
"""


def rel_err(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def train_reduced(dev, card):
    """Check 1: each architecture reduced, fp32 (TF32 off): one step on
    the card against the same step on the CPU from the same weights and
    batch (loss and gradient norm within ``TRAIN_FIRST_STEP_RTOL``), then
    ``TRAIN_REDUCED_STEPS`` steps of ``train()`` on the card (seq 64, batch
    8, lr 3e-3, warmup 5, 50 total steps): the mean of the last 5 losses
    below the mean of the first 5; granite-8b at 2 layers by 0.2 (the
    reference's bar, ``tests/test_models.py:160``)."""
    import copy

    from repro_torch.configs import ARCHS, get_config, reduced
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import add_extra_inputs, train
    from repro_torch.models import model as model_mod
    from repro_torch.optim import OptConfig, opt_init

    opt = OptConfig(lr=3e-3, warmup_steps=5, total_steps=50)
    out = {}
    runs = [(arch, None) for arch in sorted(ARCHS)] + [("granite-8b", 2)]
    for arch, n_layers in runs:
        cfg = reduced(get_config(arch))
        if n_layers:
            cfg = cfg.replace(n_layers=n_layers)
        label = arch if n_layers is None else f"{arch} ({n_layers} layers)"
        data = SyntheticLMStream(DataConfig(seq_len=64, global_batch=8,
                                            vocab_size=cfg.vocab_size))
        batch = add_extra_inputs(cfg, data.batch(0), 0)
        first = {}
        on_cpu = model_mod.init_params(cfg, 0, "cpu")
        on_card = copy.deepcopy(on_cpu).to(dev)
        for where, m in (("cpu", on_cpu), ("card", on_card)):
            d = torch.device("cpu") if where == "cpu" else dev
            step = make_train_step(cfg, opt, device=d)
            _, _, met = step(m, opt_init(dict(m.named_parameters())),
                             {k: v.to(d) for k, v in batch.items()})
            first[where] = (float(met["loss"]), float(met["grad_norm"]))
        del on_cpu, on_card
        errs = [rel_err(first["card"][i], first["cpu"][i]) for i in (0, 1)]
        check(max(errs) <= TRAIN_FIRST_STEP_RTOL,
              f"training {label}: the card's first step (loss, grad norm) "
              f"{first['card']} against the CPU's {first['cpu']}, rel err "
              f"{errs}")
        sync()
        t0 = time.perf_counter()
        _, _, losses = train(arch, TRAIN_REDUCED_STEPS,
                             TRAIN_REDUCED["seq_len"],
                             TRAIN_REDUCED["batch_size"], True,
                             lr=TRAIN_REDUCED["lr"],
                             total_steps=TRAIN_REDUCED["total_steps"],
                             n_layers=n_layers, log_every=10_000, device=dev)
        ms = (time.perf_counter() - t0) * 1e3 / TRAIN_REDUCED_STEPS
        head, tail = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        bar = 0.2 if n_layers == 2 else 0.0
        check(np.all(np.isfinite(losses)) and tail < head - bar,
              f"training {label}: the loss did not fall by {bar} over "
              f"{TRAIN_REDUCED_STEPS} steps: {losses}")
        print(f"training reduced {label}: first step card/cpu loss "
              f"{first['card'][0]:.6f}/{first['cpu'][0]:.6f}, grad norm "
              f"{first['card'][1]:.6f}/{first['cpu'][1]:.6f} (rel err "
              f"{errs[0]:.2e}, {errs[1]:.2e}); {TRAIN_REDUCED_STEPS} steps: "
              f"loss {head:.4f} -> {tail:.4f} (first 5 / last 5 means), "
              f"{ms:.1f} host ms/step [{card}]", flush=True)
        out[label] = dict(first_card=first["card"], first_cpu=first["cpu"],
                          rel_err=errs, losses=losses, ms_per_step=ms)
    return out


def train_resume(dev, card, work):
    """Check 2: one architecture per family, reduced: ``RESUME_STEPS``
    steps of ``train()`` straight, against a child process SIGKILLed after
    the checkpoint at step ``RESUME_KILL_AT`` (the six children run at
    once) and resumed to ``RESUME_STEPS``; the weights, ``m``, ``v`` and
    ``step`` must be equal in every bit (``train()`` runs under
    ``torch.use_deterministic_algorithms(True)``)."""
    from repro_torch.launch.train import train

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "src")]
        + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    children = {}
    for arch in RESUME_ARCHS:
        ckpt = os.path.join(work, f"train_{arch}")
        children[arch] = (ckpt, subprocess.Popen(
            [sys.executable, "-c", TRAIN_RESUME_CHILD, arch, ckpt,
             str(RESUME_KILL_AT), str(RESUME_STEPS), str(dev)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    kw = dict(lr=3e-3, microbatch=2, total_steps=50, log_every=10_000,
              device=dev)
    straight = {arch: train(arch, RESUME_STEPS, 64, 8, True, **kw)
                for arch in RESUME_ARCHS}
    out = {}
    for arch, (ckpt, proc) in children.items():
        _, err = proc.communicate(timeout=600)
        check(proc.returncode == -9, f"training resume {arch}: the child "
              f"exited {proc.returncode}, not by SIGKILL: {err[-2000:]}")
        m_r, s_r, losses = train(arch, RESUME_STEPS, 64, 8, True, ckpt,
                                 save_every=1, **kw)
        m_s, s_s, _ = straight[arch]
        check(len(losses) == RESUME_STEPS - RESUME_KILL_AT,
              f"training resume {arch}: resumed {len(losses)} steps")
        same = all(torch.equal(a, b) for a, b in
                   zip(m_r.parameters(), m_s.parameters()))
        for key in ("m", "v"):
            same &= all(torch.equal(s_r[key][n], s_s[key][n])
                        for n in s_s[key])
        same &= int(s_r["step"]) == int(s_s["step"]) == RESUME_STEPS
        check(same, f"training resume {arch}: the resumed run differs from "
              f"the straight one")
        print(f"training resume {arch}: killed after checkpoint "
              f"{RESUME_KILL_AT}, resumed to step {RESUME_STEPS}: weights, "
              f"m, v and step equal in every bit [{card}]", flush=True)
        out[arch] = True
    del straight
    return out


def train_full_width(dev, card):
    """Check 3: one training step per architecture at published widths,
    bf16, remat on, ``TRAIN_SEQ`` x ``TRAIN_BATCH`` tokens in
    ``TRAIN_MICROBATCH`` microbatches, at ``TRAIN_DEPTHS``: one untimed
    step under ``torch.profiler`` for busy (the loss at initialisation
    within rel 0.35 of ln V, as ``tests/test_models.py:42``, the gradient
    norm finite), then two timed by the host clock; prints host
    ms/step, busy ms/step, tokens/s, the model-FLOPs share 6 N_active
    tokens / step_s / 989e12, and peak memory.  Each model is freed before
    the next.  The attention's scores are fp32 products, as the
    reference's are; they run on TF32 here (the TPU's default precision
    takes fp32 products in one bf16 pass too), the check-1 comparison
    keeps it off."""
    out = {}
    tokens = TRAIN_SEQ * TRAIN_BATCH
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for arch, layers, why in TRAIN_DEPTHS:
            out[arch] = train_full_width_row(arch, layers, why, dev, card,
                                             tokens)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_full_width_row(arch, layers, why, dev, card, tokens):
    """One row of check 3 (``train_full_width``)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import add_extra_inputs
    from repro_torch.models import model as model_mod
    from repro_torch.optim import OptConfig, opt_init

    cfg = get_config(arch)
    if layers == 0:
        print(f"training full width {arch}: no step: {why}", flush=True)
        return dict(skipped=why)
    if layers:
        cfg = cfg.replace(n_layers=layers)
    check(cfg.remat and cfg.dtype == "bfloat16",
          f"training full width {arch}: not a bf16 remat config")
    gc.collect()
    sync()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t_arch = time.perf_counter()
    model = model_mod.init_params(cfg, 0, dev)
    n_params = sum(p.numel() for p in model.parameters())
    state = opt_init(dict(model.named_parameters()))
    step = make_train_step(cfg, OptConfig(),
                           microbatch=TRAIN_MICROBATCH, device=dev)
    data = SyntheticLMStream(DataConfig(seq_len=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH,
                                        vocab_size=cfg.vocab_size))
    batches = [add_extra_inputs(cfg, data.batch(i, dev), i, dev)
               for i in range(3)]
    # the untimed first step, under the profiler tracing the device only
    # (its device work is any step's; the host's first-call costs stay out
    # of the timed two; tracing the host's ops too, and parsing the trace
    # into function events, cost minutes on a step of ~10^5 kernels)
    (model, state, met), prof = profiled(
        lambda: step(model, state, batches[0]), activities=("CUDA",))
    busy = device_busy_ms(prof)
    del prof
    check(busy > 0, f"training full width {arch}: the profile holds no "
          f"device time")
    loss0, gnorm = float(met["loss"]), float(met["grad_norm"])
    lnv = float(np.log(cfg.vocab_size))
    check(abs(loss0 - lnv) <= 0.35 * lnv and np.isfinite(gnorm),
          f"training full width {arch}: loss at init {loss0} (ln V "
          f"{lnv:.3f}), grad norm {gnorm}")
    sync()
    t0 = time.perf_counter()
    for b in batches[1:]:
        model, state, met = step(model, state, b)
    sync()
    host = (time.perf_counter() - t0) * 1e3 / (len(batches) - 1)
    check(np.isfinite(float(met["loss"])),
          f"training full width {arch}: non-finite loss")
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    n_active = cfg.param_count(active_only=True)
    mfu = 6 * n_active * tokens / (host / 1e3) / BF16_FLOP_PER_S
    depth = (f"{cfg.n_layers} of {get_config(arch).n_layers} layers"
             if layers else f"{cfg.n_layers} layers")
    print(f"training full width {arch} ({depth}, {n_params / 1e9:.3f} "
          f"B parameters, {n_active / 1e9:.3f} B active): loss at init "
          f"{loss0:.4f} (ln V {lnv:.4f}), grad norm {gnorm:.4f}; host "
          f"{host:.1f} ms/step, busy {busy:.1f} ms/step (profiled), "
          f"{tokens / (host / 1e3):.0f} tokens/s, model-FLOPs share "
          f"{mfu:.3f}, peak {peak:.2f} GiB; "
          f"{time.perf_counter() - t_arch:.1f} s [{card}]", flush=True)
    row = dict(layers=cfg.n_layers, params=n_params, active=n_active,
               loss0=loss0, grad_norm=gnorm, host_ms=host, busy_ms=busy,
               tokens_per_s=tokens / (host / 1e3), mfu=mfu, peak_gib=peak,
               why=why)
    del model, state, step, batches, met
    return row


def phase_training(dev, card, results):
    """Training on the card (``repro_torch.launch``): checks 1-3 above.
    The training path reaches no kernel (the reference trains on the MoE
    layer's einsum branch and its jnp attention, with no custom VJP), so
    no wrapper may count a launch here."""
    import tempfile

    gc.collect()
    torch.cuda.empty_cache()
    zero_launch_counts()
    t0 = time.perf_counter()
    out = {"reduced": train_reduced(dev, card)}
    scratch = os.path.join(HERE, "results")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="train_", dir=scratch) as work:
        out["resume"] = train_resume(dev, card, work)
    out["full_width"] = train_full_width(dev, card)
    check(not nonzero_launch_counts(), f"training: kernel launches "
          f"{nonzero_launch_counts()} on a path that has none")
    out["seconds"] = time.perf_counter() - t0
    print(f"training: {len(out['reduced'])} reduced runs, "
          f"{len(out['resume'])} resumes, {len(out['full_width'])} "
          f"full-width rows in {out['seconds']:.1f} s", flush=True)
    results["training"] = out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write every measurement to this JSON file")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}: run it "
              f"from a checkout of the repo", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.configs.amr_sedov import CONFIG as AMR_CONFIG
    from repro_torch.configs.amr_sedov import CONFIG_MIXED
    from repro_torch.configs.base import (
        AggregationConfig, AMRHydroConfig, GravityHydroConfig,
    )
    from repro_torch.configs.gravity import CONFIG as GRAVITY_CONFIG
    from repro_torch.configs.sedov import CONFIG, CONFIG_16
    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import extract as ext
    from repro_torch.kernels import gravity as grav
    from repro_torch.kernels import grouped_gemm as gg
    from repro_torch.kernels import hydro_rhs as kern
    from repro_torch.kernels import hydro_split as split

    dev = torch.device("cuda", 0)
    # fp32 products in full fp32 (the plain versions' reference arithmetic)
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)})",
          flush=True)
    # one nvcc per source, all started together
    t0 = time.perf_counter()
    libs = {"hydro_rhs": kern.build, "gravity": grav.build,
            "hydro_split": split.build, "hydro_rhs_lane": kern.build_lane,
            "decode_attention": da.build, "grouped_gemm": gg.build,
            "extract": ext.build}
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(build) for build in libs.values()]:
            fut.result()
    print(f"build: {len(libs)} libraries loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in libs:
        info = _build.BUILD_LOG[name]
        built = (f"built in {info['seconds']:.1f} s" if info["seconds"]
                 is not None else "cached build")
        print(f"build: csrc/{name}.cu, nvcc sm_90a, {built}", flush=True)
        for line in info["ptxas"].splitlines():
            if ("registers" in line or "spill" in line
                    or "Function properties for" in line):
                print(f"  ptxas: {line.strip()}", flush=True)

    results = {"card": card, "device": torch.cuda.get_device_name(0),
               "torch": torch.__version__, "cuda": torch.version.cuda}
    phase_kernel(CONFIG, dev, results)
    phase_kernel_16(CONFIG_16, dev, results)
    dts, fused_kernel_path = phase_main_path(CONFIG, dev, STEPS, results)
    phase_extract_kernel(dev, card, results)

    gravity_512 = GravityHydroConfig(name="gravity_sedov_512", hydro=CONFIG)
    phase_gravity_kernel(gravity_512, dev, results)
    phase_split_kernels(CONFIG, dev, results)
    four_rows = (
        ("fused", AggregationConfig(strategy="fused")),
        ("s3 cap 32", AggregationConfig(strategy="s3", max_aggregated=32)),
        ("s3 cap 512", AggregationConfig(strategy="s3",
                                         max_aggregated=512)),
        ("s2+s3 4 streams cap 32", AggregationConfig(
            strategy="s2+s3", n_executors=4, max_aggregated=32)))
    path_a = phase_gravity_path(gravity_512, dev, STEPS, four_rows, results,
                                "gravity_path")
    phase_gravity_path(GRAVITY_CONFIG, dev, STEPS, (
        ("fused", AggregationConfig(strategy="fused")),
        ("s3 cap 16", AggregationConfig(strategy="s3", max_aggregated=16))),
        results, "gravity_path_64")
    path_b = phase_split_path(CONFIG, dev, dts, fused_kernel_path, results)

    # the lane kernel, then Path C (AMR, both layouts) and Path D
    phase_lane_kernel(CONFIG, CONFIG_16, dev, results)
    amr_1024 = AMRHydroConfig(name="amr_sedov_1024", coarse_grids_per_edge=8,
                              cover=32)
    rows_16 = (("fused", AggregationConfig(strategy="fused")),
               ("s3 cap 16", AggregationConfig(strategy="s3",
                                               max_aggregated=16)))
    family_8 = {"hydro_rhs_s8[5x14x14x14,scalar]": {8: 6}}
    path_c = {}
    for acfg, rows, hists in ((amr_1024, four_rows, None),
                              (AMR_CONFIG, rows_16, family_8)):
        ref, amr_dts = amr_reference(acfg, dev, STEPS)
        fused = {}
        for layout in ("slot_grid", "slot_lane"):
            if layout == "slot_lane":
                ref, _ = amr_reference(acfg, dev, STEPS, amr_level_bodies(
                    acfg, layout, plain=True), amr_dts)
            fused[layout], path_c[(acfg.name, layout)] = phase_amr_path(
                acfg, layout, rows, dev, ref, amr_dts, results,
                f"amr_path_{acfg.name}_{layout}", hists)
        compare_layouts(acfg.name, fused["slot_lane"], fused["slot_grid"],
                        acfg)
    # CONFIG_MIXED (a 16^3 family and an 8^3 one) on both layouts
    rows_mixed = rows_16 + (("s2+s3 4 streams cap 16", AggregationConfig(
        strategy="s2+s3", n_executors=4, max_aggregated=16)),)
    mixed_fused, mixed_dts = {}, None
    for layout in ("slot_lane", "slot_grid"):
        ref, mixed_dts = amr_reference(CONFIG_MIXED, dev, STEPS,
                                       amr_level_bodies(CONFIG_MIXED, layout,
                                                        plain=True),
                                       mixed_dts)
        mixed_fused[layout], path_c[(CONFIG_MIXED.name, layout)] = \
            phase_amr_path(CONFIG_MIXED, layout, rows_mixed, dev, ref,
                           mixed_dts, results, f"amr_path_mixed_{layout}", {
                               "hydro_rhs_s16[5x22x22x22,scalar]": {1: 3},
                               "hydro_rhs_s8[5x14x14x14,scalar]": {8: 3}})
    compare_layouts(CONFIG_MIXED.name, mixed_fused["slot_lane"],
                    mixed_fused["slot_grid"], CONFIG_MIXED)
    phase_lane_path(CONFIG, dev, STEPS, results, "lane_path", dts=dts,
                    grid_path=fused_kernel_path)
    _, lane16, dts16 = phase_lane_path(CONFIG_16, dev, STEPS, results,
                                       "lane_path_16")
    path_d16, grid16, _ = phase_lane_path(
        CONFIG_16, dev, STEPS, results, "grid_path_16", dts=dts16,
        grid_path=lane16, layout="slot_grid")
    check(torch.equal(grid16, lane16), "CONFIG_16: the slot_grid path and "
          "the lane kernel's path differ after the same steps")
    print("CONFIG_16: the slot_grid path equals the lane kernel's path in "
          "every element", flush=True)

    # staging, s2 and the epilogue-fused stages
    phase_staging(CONFIG, dev, card, dts, fused_kernel_path, results)
    phase_s2(CONFIG, gravity_512, amr_1024, dev, card, dts, results)
    phase_fused_stages(CONFIG, gravity_512, amr_1024, dev, card, dts,
                       results)
    phase_tuning(CONFIG, gravity_512, CONFIG_MIXED, dev, card, dts,
                 fused_kernel_path, results)
    phase_bucket_graphs(CONFIG, CONFIG_16, gravity_512, amr_1024, dev, card,
                        dts, results)

    # the whole trajectory as one CUDA graph, crash-consistent resume and
    # the captured AMR exchange
    phase_trajectory(trajectory_paths(CONFIG, CONFIG_16, gravity_512,
                                      GRAVITY_CONFIG, amr_1024, dev),
                     dev, card, results)
    phase_resume(CONFIG, amr_1024, dev, card, results)
    phase_amr_exchange(amr_1024, dev, card, results)

    # containment: the guard, bisection, degraded buckets, the watchdog,
    # the breakers, the tripwire and serving eviction
    phase_containment(CONFIG, gravity_512, dev, card, dts, fused_kernel_path,
                      results)

    # warm start (the tune store across processes, the roofline prior) and
    # tenancy on one card (TenantBatcher under s4)
    phase_warm_start(CONFIG, dev, card, dts, fused_kernel_path, results)
    phase_tenancy(CONFIG, AMR_CONFIG, dev, card, dts, results)
    # s4 over a mesh of shards, the data-parallel step on a one-rank NCCL
    # group, the resilient loop and the elastic restore
    phase_distributed(CONFIG, dev, card, dts, fused_kernel_path, results)

    # the serving kernels, then the serving path (qwen2-moe-a2.7b); the
    # runners above are gone, and with them their bucket graphs' pools
    gc.collect()
    torch.cuda.empty_cache()
    phase_lm_kernels(dev, card, results)
    phase_serving_path(dev, card, results)
    # the other eight families the port serves (six attention stacks,
    # the ssm and the hybrid), after the recurrent mixers' check
    phase_families(dev, card, results)
    # training: reduced runs of every architecture, resume, and one
    # full-width bf16 step per architecture
    phase_training(dev, card, results)

    # launches on each kernel's own path, the s3 cap 32 row
    entries = [results["kernel"], results["gravity_kernel"],
               results["reconstruct_kernel"], results["flux_kernel"],
               results["lane_kernel"], results["decode_attention_kernel"],
               results["grouped_gemm_kernel"], results["kernel_16"],
               results["extract_kernel"]]
    entries[1]["launches"] = \
        path_a["s3 cap 32"]["kernel_launches"]["gravity_cuda"]
    entries[2]["launches"] = \
        path_b["s3 cap 32"]["kernel_launches"]["hydro_reconstruct_cuda"]
    entries[3]["launches"] = \
        path_b["s3 cap 32"]["kernel_launches"]["hydro_flux_cuda"]
    entries[4]["launches"] = path_c[(amr_1024.name, "slot_lane")][
        "s3 cap 32"]["kernel_launches"]["hydro_rhs_lane_cuda"]
    entries[7]["launches"] = \
        path_d16["s3 cap 32"]["kernel_launches"]["hydro_rhs_cuda"]
    entries[8]["launches"] = \
        results["main_path"]["runs"]["s3 cap 32"]["extract_launches"]
    results["seconds"] = time.perf_counter() - t_start
    print(f"chip_smoke: every phase passed in {results['seconds']:.1f} s, "
          f"the builds included", flush=True)
    k = results["kernel"]
    print(f"kernels: hydro_rhs (cuda, {k['source']}, replaces "
          f"{k['replaces']} and its h_slots twin :146, on the main path, "
          f"Path A, Path C slot_grid and, at 16^3 in two x-slabs per slot, "
          f"CONFIG_16 and CONFIG_MIXED); gravity (cuda, "
          f"src/repro_torch/csrc/gravity.cu, replaces "
          f"src/repro/kernels/gravity.py:130, Path A); hydro_reconstruct and "
          f"hydro_flux (cuda, src/repro_torch/csrc/hydro_split.cu, replace "
          f"src/repro/kernels/hydro_rhs.py:301 and :327, Path B); "
          f"hydro_rhs_lane (cuda, src/repro_torch/csrc/hydro_rhs_lane.cu, "
          f"replaces src/repro/kernels/hydro_rhs.py:154 and its h_slots twin "
          f":160, Path C slot_lane and Path D); decode_attention (cuda, "
          f"src/repro_torch/csrc/decode_attention.cu, replaces "
          f"src/repro/kernels/decode_attention.py:28, the serving path); "
          f"grouped_gemm (cuda, src/repro_torch/csrc/grouped_gemm.cu, "
          f"replaces src/repro/kernels/grouped_gemm.py:30, the serving path);"
          f" extract (cuda, src/repro_torch/csrc/extract.cu, replaces "
          f"src/repro/hydro/state.py:96's pad and gather, no TPU kernel, "
          f"every scenario's extraction on the card)", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{key: e[key] for key in keys}
                                  for e in entries]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
