"""Where an RK3 step's time goes on the card, per strategy; and where a
serving engine step's time goes, per bucket.

  PYTHONPATH=src python -m repro_torch.profile_step \
      [--scenario sedov|gravity|amr|serve|paths|families] \
      [--body fused|split] [--layout slot_grid|slot_lane] \
      [--out results/profile_step.json]

At the paper's grid (512 sub-grids of 8^3), for each strategy row (fused,
the fused trajectory, s3 at caps 32 and 512, s2+s3 with 4 streams, s2
with 4 streams, s3 cap 32 under host staging, and s3 cap 32 and s2+s3 4 x
32 through the epilogue-fused stages) it warms up, times 3 RK3
steps on the host clock (synchronised), then profiles the same steps with
``torch.profiler`` and prints the host operations with the most self CPU
time, the kernels with the most device time, the device's busy time (the
union of every kernel, copy and fill interval over all streams, so
kernels that overlap on several streams count once), and the device's
idle share of the step (1 - device busy / wall), with the host's enqueue
time per step (the executors' ``dispatch_s``) and the bucket-program
captures the row made.  The fused trajectory row runs the 3 steps as one
``rk3_trajectory`` call, one CUDA graph replay (captured before the
timing).

``--scenario sedov`` (default) steps the uniform Sedov ``CONFIG``;
``--scenario gravity`` steps the self-gravitating blast on the same grid,
``GravityHydroConfig(hydro=CONFIG)`` (hydro and gravity families);
``--scenario amr`` steps the two-level AMR blast at 1,024 tasks per
iteration (``AMR_1024``: a 64^3 coarse level and a 64^3 fine patch, 512
sub-grids of 8^3 each, one family).  ``--body split`` runs the uniform
Sedov scenario on the split Reconstruct + Flux body instead of the fused
hydro kernel.  ``--layout slot_lane`` runs the hydro family on the lane
kernel (tasks across each warp) instead of the slot_grid kernel (one
thread-block cluster per slot).  On ``--scenario amr`` the two-level
exchange of every row is the scenario's captured graph.

``--scenario serve`` profiles the serving engine: qwen2-moe-a2.7b at its
published widths cut to 4 layers, bf16, behind
``ServingEngine(max_batch=8, max_len=1024)``.  For each bucket (1, 2, 4, 8)
it admits that many requests (64-token prompts), warms up, times engine
steps (one aggregated launch each) on the host clock, profiles the same
number of steps, and reports each kernel's device time and launches per
step, the cache gather and scatter copies (CUDA events), the device's busy
time and its idle share.

``--scenario paths`` runs, in one process, the main path's bucket rows
(s3 caps 32 and 512, s2+s3 4 x 32, host staging, the fused stages) and
``s3`` cap 32 on Path A (gravity), Path B (split), Path C (AMR, both
layouts), Path D (the lane kernel) and ``CONFIG_16``, printing host,
profiled, busy and enqueue ms per step.  ``--scenario families`` serves
every architecture of the registry at its published widths in bf16, cut
to ``FAMILY_LAYERS`` layers (one whole group where the family stacks
groups), behind ``ServingEngine(max_batch=8, max_len=256)``, and prints
the host ms and the device's busy ms per engine launch at buckets 1 and
8.  Both read only what every revision of the port has (the
``StrategyRunner`` and ``ServingEngine`` entry points, the executors'
``dispatch_s``), so the script run as a file against another revision's
``src`` (``PYTHONPATH``) measures that revision the same way.
Needs a CUDA device.
"""
import argparse
import functools
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs.base import (
    AggregationConfig, AMRHydroConfig, GravityHydroConfig,
)
from repro_torch.configs.sedov import CONFIG
from repro_torch.core import (
    AMRSedovScenario, GravityScenario, StrategyRunner, UniformSedovScenario,
)
from repro_torch.hydro.state import amr_sedov_init, sedov_init
from repro_torch.hydro.stepper import amr_courant_dt, courant_dt
from repro_torch.kernels.hydro_rhs import LAYOUTS
from repro_torch.kernels.ops import (
    hydro_batched_body, hydro_split_batched_body, level_batched_body,
)

STEPS = 3            # RK3 steps timed, then profiled, per row
AMR_1024 = AMRHydroConfig(name="amr_sedov_1024", coarse_grids_per_edge=8,
                          cover=32)
TOP = 8              # host operations and kernels listed per row
TRAJECTORY = "fused trajectory"
ROWS = (("fused", dict(strategy="fused")),
        (TRAJECTORY, dict(strategy="fused")),
        ("s3 cap 32", dict(strategy="s3", max_aggregated=32)),
        ("s3 cap 512", dict(strategy="s3", max_aggregated=512)),
        ("s2+s3 4 streams cap 32", dict(strategy="s2+s3", n_executors=4,
                                        max_aggregated=32)),
        ("s2 4 streams", dict(strategy="s2", n_executors=4)),
        ("s3 cap 32 host staging", dict(strategy="s3", max_aggregated=32,
                                        staging="host")),
        ("s3 cap 32 fused stages", dict(strategy="s3", max_aggregated=32,
                                        fuse_epilogue=True)),
        ("s2+s3 4 streams cap 32 fused stages", dict(
            strategy="s2+s3", n_executors=4, max_aggregated=32,
            fuse_epilogue=True)))


def _on_device(evt) -> bool:
    """A kernel or memcpy on the card (an aten op's own event carries its
    kernels' time too, so summing every event would count it twice)."""
    return getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA


def _busy_ms(prof, steps: int) -> float:
    """Device busy ms per step: the union of the profile's device
    intervals over all streams."""
    return tracing.union_ns(tracing.device_intervals(prof)) / 1e6 / steps


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def make_case(scenario: str, body: str, layout: str, dev):
    """The profiled scenario, its initial state and its first Courant dt:
    the uniform and gravity scenarios at the paper's grid (``CONFIG``),
    the AMR scenario at ``AMR_1024``."""
    if body == "split" and (scenario != "sedov" or layout != "slot_grid"):
        raise SystemExit("--body split runs with --scenario sedov and the "
                         "slot_grid layout only")
    if scenario == "amr":
        cfg = AMR_1024
        st = amr_sedov_init(cfg, device=dev)
        sc = AMRSedovScenario(cfg, hydro_body=functools.partial(
            level_batched_body, cfg.gamma, cfg.ghost, layout=layout))
        return sc, (st.uc, st.uf), amr_courant_dt(st.uc, st.uf, cfg)
    u0 = sedov_init(CONFIG, device=dev).u
    dt = courant_dt(u0, CONFIG)
    if scenario == "gravity":
        hc = CONFIG
        return GravityScenario(
            GravityHydroConfig(name="gravity_sedov_512", hydro=hc),
            hydro_body=level_batched_body(hc.gamma, hc.ghost, hc.subgrid,
                                          layout=layout)), u0, dt
    h = CONFIG.domain / (CONFIG.grids_per_edge * CONFIG.subgrid)
    if body == "split":
        return UniformSedovScenario(
            CONFIG, batched_body=hydro_split_batched_body(CONFIG, h)), u0, dt
    return UniformSedovScenario(CONFIG, batched_body=hydro_batched_body(
        CONFIG, h, layout=layout)), u0, dt


def _dispatch_s(runner) -> float:
    return sum(e.dispatch_s for e in runner.pool.executors)


def profile_row(scenario, u0, dt, agg, steps, dev, trajectory=False):
    """One row: ``steps`` RK3 steps timed, then profiled; with
    ``trajectory`` as one ``rk3_trajectory`` call (its graph captured
    first).  The executor strategies take one untimed step after the
    warmup (the bucket programs a warmup leaves are made there)."""
    runner = StrategyRunner(scenario, agg, device=dev)
    runner.warmup()
    if trajectory:
        runner.rk3_trajectory(u0, dt, steps)
    elif runner.executor is not None:
        runner.rk3_step(u0, dt)
    torch.cuda.synchronize(dev)
    d0 = _dispatch_s(runner)
    wall_ms = runner.time_step(u0, dt, steps, use_scan=trajectory) * 1e3
    dispatch_ms = (_dispatch_s(runner) - d0) * 1e3 / steps
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if trajectory:
            runner.rk3_trajectory(u0, dt, steps)
        else:
            u = u0
            for _ in range(steps):
                u = runner.rk3_step(u, dt)
        torch.cuda.synchronize(dev)
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    events = prof.key_averages()
    kernels = [e for e in events if _on_device(e)]
    device_ms = _busy_ms(prof, steps)
    host = sorted((e for e in events if not _on_device(e)),
                  key=lambda e: e.self_cpu_time_total, reverse=True)[:TOP]
    device = sorted(kernels, key=_device_us, reverse=True)[:TOP]
    exe = runner.executor
    return dict(
        ms_per_step=wall_ms, profiled_ms_per_step=prof_wall_ms,
        device_busy_ms_per_step=device_ms,
        device_idle_share=max(0.0, 1.0 - device_ms / prof_wall_ms),
        dispatch_ms_per_step=dispatch_ms,
        captures=(exe.stats.get("captures", 0) if exe is not None else 0),
        top_host_ops=[dict(name=e.key, calls=e.count,
                           self_cpu_ms_per_step=e.self_cpu_time_total
                           / 1e3 / steps,
                           device_ms_per_step=_device_us(e) / 1e3 / steps)
                      for e in host],
        top_device_ops=[dict(name=e.key, calls=e.count,
                             device_ms_per_step=_device_us(e) / 1e3 / steps)
                        for e in device])


SERVE_LAYERS = 4
SERVE_BUCKETS = (1, 2, 4, 8)
SERVE_PROMPT = 64        # tokens per request's prompt
SERVE_MAX_LEN = 1024
# each serving kernel's device kernels by name; the first is launched once
# per wrapper call (decode attention: the chunk pass, then the combine)
SERVE_KERNELS = {"decode_attention": ("decode_chunk_kernel",
                                      "decode_combine_kernel"),
                 "grouped_gemm": ("grouped_gemm_kernel",)}


def _cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` by CUDA events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def profile_serve(layers: int, steps: int, dev) -> dict:
    """One row per bucket of the serving engine on a reduced-depth
    qwen2-moe-a2.7b (published widths, ``layers`` layers, bf16)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_mod
    from repro_torch.serving import Request, ServingEngine

    cfg = get_config("qwen2-moe-a2.7b").replace(n_layers=layers)
    m = model_mod.init_params(cfg, seed=0, device=dev)
    rows = {}
    for bucket in SERVE_BUCKETS:
        eng = ServingEngine(cfg, m, max_batch=max(SERVE_BUCKETS),
                            max_len=SERVE_MAX_LEN, device=dev)
        for i in range(bucket):
            prompt = [(97 * i + 13 * j) % cfg.vocab_size
                      for j in range(SERVE_PROMPT)]
            eng.submit(Request(i, prompt, max_new_tokens=SERVE_MAX_LEN
                               - SERVE_PROMPT))
        for _ in range(3):                 # admission + prefill, warmup
            eng.step()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                eng.step()
            torch.cuda.synchronize(dev)
            prof_wall_ms = (time.perf_counter() - t0) * 1e3 / steps
        events = prof.key_averages()
        kernels = [e for e in events if _on_device(e)]
        busy_ms = _busy_ms(prof, steps)
        ours = {}
        for op, names in SERVE_KERNELS.items():
            hits = [e for e in kernels if any(n in e.key for n in names)]
            ours[op] = dict(
                device_ms_per_step=sum(_device_us(e) for e in hits)
                / 1e3 / steps,
                launches_per_step=sum(e.count for e in hits
                                      if names[0] in e.key) / steps)
        idx = torch.arange(bucket, device=dev)
        sub = eng._gather(idx)
        rows[bucket] = dict(
            ms_per_step=wall_ms, profiled_ms_per_step=prof_wall_ms,
            device_busy_ms_per_step=busy_ms,
            device_idle_share=max(0.0, 1.0 - busy_ms / prof_wall_ms),
            kernels=ours,
            gather_ms=_cuda_ms(lambda: eng._gather(idx)),
            scatter_ms=_cuda_ms(lambda: eng._scatter(idx, sub)),
            top_device_ops=[dict(name=e.key, calls=e.count,
                                 device_ms_per_step=_device_us(e) / 1e3
                                 / steps)
                            for e in sorted(kernels, key=_device_us,
                                            reverse=True)[:TOP]])
        del sub, eng
    return dict(config=cfg.name, layers=layers, dtype=cfg.dtype,
                prompt=SERVE_PROMPT, max_len=SERVE_MAX_LEN,
                peak_bytes=torch.cuda.max_memory_allocated(dev), rows=rows)


def main_serve(dev, out):
    out.update(profile_serve(SERVE_LAYERS, STEPS * 2, dev))
    print(f"profile_step: serving {out['config']} cut to {out['layers']} "
          f"layers, {out['dtype']}, {SERVE_PROMPT}-token prompts, on "
          f"{out['device']}; peak {out['peak_bytes'] / 2**30:.2f} GiB",
          flush=True)
    for bucket, row in out["rows"].items():
        ks = row["kernels"]
        print(f"bucket {bucket}: {row['ms_per_step']:.3f} ms/step (profiled "
              f"{row['profiled_ms_per_step']:.3f}), device busy "
              f"{row['device_busy_ms_per_step']:.3f} ms/step, idle share "
              f"{row['device_idle_share']:.3f}; decode_attention "
              + "{:.4f} ms ({:g} launches), grouped_gemm {:.4f} ms ({:g} "
              "launches) per step; gather {:.4f} ms, scatter {:.4f} ms"
              .format(ks["decode_attention"]["device_ms_per_step"],
                      ks["decode_attention"]["launches_per_step"],
                      ks["grouped_gemm"]["device_ms_per_step"],
                      ks["grouped_gemm"]["launches_per_step"],
                      row["gather_ms"], row["scatter_ms"]), flush=True)
        for op in row["top_device_ops"]:
            print(f"    device {op['device_ms_per_step']:9.3f} ms "
                  f"{op['calls']:6d}x  {op['name'][:90]}", flush=True)


PATH_ROWS = ("s3 cap 32", "s3 cap 512", "s2+s3 4 streams cap 32",
             "s3 cap 32 host staging", "s3 cap 32 fused stages")


def path_cases(dev):
    """(label, scenario, state, dt, row labels) of ``--scenario paths``."""
    from repro_torch.configs.sedov import CONFIG_16

    cases = [("main path",) + make_case("sedov", "fused", "slot_grid", dev)
             + (PATH_ROWS,)]
    for label, args in (("Path A (gravity)", ("gravity", "fused",
                                              "slot_grid")),
                        ("Path B (split)", ("sedov", "split", "slot_grid")),
                        ("Path C (AMR, slot_grid)", ("amr", "fused",
                                                     "slot_grid")),
                        ("Path C (AMR, slot_lane)", ("amr", "fused",
                                                     "slot_lane")),
                        ("Path D (lane kernel)", ("sedov", "fused",
                                                  "slot_lane"))):
        cases.append((label,) + make_case(*args, dev) + (PATH_ROWS[:1],))
    u16 = sedov_init(CONFIG_16, device=dev).u
    cases.append(("CONFIG_16", UniformSedovScenario(CONFIG_16), u16,
                  courant_dt(u16, CONFIG_16), PATH_ROWS[:1]))
    return cases


def main_paths(dev, out):
    rows = dict(ROWS)
    n_cases = len(path_cases(dev))
    for i in range(n_cases):
        label, _, _, _, labels = path_cases(dev)[i]
        for row_label in labels:
            # a fresh scenario per row (a scenario caches per-step data)
            _, scenario, u0, dt, _ = path_cases(dev)[i]
            row = profile_row(scenario, u0, dt,
                              AggregationConfig(**rows[row_label]), STEPS,
                              dev)
            row.pop("top_host_ops")
            row.pop("top_device_ops")
            out["rows"][f"{label}, {row_label}"] = row
            print(f"{label}, {row_label}: {row['ms_per_step']:.3f} ms/step "
                  f"(profiled {row['profiled_ms_per_step']:.3f}), device "
                  f"busy {row['device_busy_ms_per_step']:.3f} ms/step, "
                  f"enqueue {row['dispatch_ms_per_step']:.3f} ms/step, "
                  f"captures {row['captures']}", flush=True)


FAMILY_LAYERS = 2
FAMILY_BUCKETS = (1, 8)
FAMILY_STEPS = 8         # engine launches timed, then profiled, per bucket


def profile_families(dev) -> dict:
    """Host and busy ms per engine launch at buckets 1 and 8 for every
    architecture (published widths, bf16, ``FAMILY_LAYERS`` layers or one
    whole group)."""
    import gc

    from repro_torch.configs import ARCHS
    from repro_torch.models import model as model_mod
    from repro_torch.serving import Request, ServingEngine

    out = {}
    for arch, full in ARCHS.items():
        every = {"vlm": full.cross_attn_every, "ssm": full.slstm_every,
                 "hybrid": full.shared_attn_every}.get(full.family)
        cfg = full.replace(n_layers=every or FAMILY_LAYERS)
        m = model_mod.init_params(cfg, seed=0, device=dev)
        rows = {}
        for bucket in FAMILY_BUCKETS:
            eng = ServingEngine(cfg, m, max_batch=max(FAMILY_BUCKETS),
                                max_len=256, device=dev)
            for i in range(bucket):
                eng.submit(Request(i, [1 + i],
                                   max_new_tokens=2 * FAMILY_STEPS + 2))
            eng.step()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(FAMILY_STEPS):
                eng.step()
            torch.cuda.synchronize(dev)
            wall = (time.perf_counter() - t0) * 1e3 / FAMILY_STEPS
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(FAMILY_STEPS):
                    eng.step()
                torch.cuda.synchronize(dev)
            busy = _busy_ms(prof, FAMILY_STEPS)
            rows[bucket] = dict(host_ms=wall, busy_ms=busy,
                                idle_share=max(0.0, 1.0 - busy / wall),
                                captures=eng.stats.get("captures", 0))
            del eng, prof
        out[arch] = dict(layers=cfg.n_layers, rows=rows)
        print(f"{arch} ({cfg.family}, {cfg.n_layers} layers, bf16): "
              + "; ".join(f"bucket {b}: {r['host_ms']:.3f} host ms, busy "
                          f"{r['busy_ms']:.3f} ms per launch (idle share "
                          f"{r['idle_share']:.3f}, captures {r['captures']})"
                          for b, r in rows.items()), flush=True)
        del m
        gc.collect()
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", default="sedov",
                    choices=("sedov", "gravity", "amr", "serve", "paths",
                             "families"))
    ap.add_argument("--body", default="fused", choices=("fused", "split"))
    ap.add_argument("--layout", default="slot_grid", choices=LAYOUTS)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs a CUDA device")
    dev = torch.device("cuda", 0)
    out = {"device": torch.cuda.get_device_name(0), "scenario": args.scenario,
           "body": args.body, "layout": args.layout, "rows": {}}
    if args.scenario in ("serve", "paths", "families"):
        print(f"profile_step: scenario {args.scenario} on {out['device']}",
              flush=True)
        if args.scenario == "serve":
            main_serve(dev, out)
        elif args.scenario == "paths":
            main_paths(dev, out)
        else:
            out["families"] = profile_families(dev)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1)
        return
    tasks = (AMR_1024.n_subgrids_coarse + AMR_1024.n_subgrids_fine
             if args.scenario == "amr" else CONFIG.n_subgrids)
    print(f"profile_step: scenario {args.scenario}, body {args.body}, layout "
          f"{args.layout}, {tasks} tasks of 8^3 per iteration on "
          f"{out['device']}", flush=True)
    for label, kw in ROWS:
        scenario, u0, dt = make_case(args.scenario, args.body, args.layout,
                                     dev)
        row = profile_row(scenario, u0, dt, AggregationConfig(**kw), STEPS,
                          dev, trajectory=label == TRAJECTORY)
        out["rows"][label] = row
        print(f"{label}: {row['ms_per_step']:.3f} ms/step (profiled "
              f"{row['profiled_ms_per_step']:.3f}), device busy "
              f"{row['device_busy_ms_per_step']:.3f} ms/step, idle share "
              f"{row['device_idle_share']:.3f}, enqueue "
              f"{row['dispatch_ms_per_step']:.3f} ms/step, captures "
              f"{row['captures']}", flush=True)
        for op in row["top_host_ops"]:
            print(f"    {op['self_cpu_ms_per_step']:9.3f} ms cpu "
                  f"{op['device_ms_per_step']:9.3f} ms dev "
                  f"{op['calls']:6d}x  {op['name']}", flush=True)
        for op in row["top_device_ops"]:
            print(f"    device {op['device_ms_per_step']:9.3f} ms "
                  f"{op['calls']:6d}x  {op['name'][:90]}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
