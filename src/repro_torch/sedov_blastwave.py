"""The paper's scenario end to end on the port: Sedov-Taylor blast wave with
a selectable work-aggregation strategy.

  PYTHONPATH=src python -m repro_torch.sedov_blastwave --strategy s3 \
      --steps 5 [--executors 4] [--max-aggregated 16] [--levels 3] \
      [--subgrid 16] [--autotune] [--cost-model] \
      [--flush-policy eager|watermark|cost] [--inner-chunk N|auto] \
      [--route KERNEL=s2|s3|fused|auto ...] [--device cuda|cpu]

``--strategy mixed`` routes each kernel family by ``--route`` (``*`` for
every family; missing or ``auto``: the measured choice under
``--cost-model``, else ``s3``).  Prints per-step timing, launch counts,
each family's ladder, cost table and route, conservation drift, and the
shock radius vs the Sedov similarity law R ~ (E t^2 / rho)^(1/5).
"""
import argparse
import time

import torch

from repro_torch.configs.base import AggregationConfig, HydroConfig
from repro_torch.core import StrategyRunner, UniformSedovScenario
from repro_torch.device import resolve_device
from repro_torch.hydro.state import sedov_init
from repro_torch.hydro.stepper import courant_dt, shock_radius, total_conserved


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--strategy", default="s2+s3",
                    choices=("fused", "s2", "s3", "s2+s3", "mixed"))
    ap.add_argument("--executors", type=int, default=4)
    ap.add_argument("--max-aggregated", type=int, default=16)
    ap.add_argument("--subgrid", type=int, default=8)
    ap.add_argument("--levels", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--autotune", action="store_true",
                    help="re-derive each family's ladder after 2 waves")
    ap.add_argument("--cost-model", action="store_true",
                    help="time the buckets and tune by predicted time")
    ap.add_argument("--flush-policy", default="eager",
                    choices=("eager", "watermark", "cost"))
    ap.add_argument("--inner-chunk", default="0",
                    help="slots per chunk launch of a bucket, or 'auto'")
    ap.add_argument("--route", action="append", default=[],
                    metavar="KERNEL=STRATEGY",
                    help="a family's route under --strategy mixed")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = HydroConfig(subgrid=args.subgrid, ghost=3, levels=args.levels)
    routes = dict(r.split("=", 1) for r in args.route)
    agg = AggregationConfig(
        strategy=args.strategy, n_executors=args.executors,
        max_aggregated=args.max_aggregated, autotune=args.autotune,
        cost_model=args.cost_model, flush_policy=args.flush_policy,
        inner_chunk=(args.inner_chunk if args.inner_chunk == "auto"
                     else int(args.inner_chunk)),
        family_strategies=routes or None)
    print(f"Sedov blast wave: {cfg.cells_total} cells, "
          f"{cfg.n_subgrids} sub-grids of {cfg.subgrid}^3, "
          f"strategy={args.strategy} (exec={args.executors}, "
          f"max_agg={args.max_aggregated}) on {device}")

    st = sedov_init(cfg, device=device)
    h = cfg.domain / st.u.shape[-1]
    c0 = total_conserved(st.u, h)
    runner = StrategyRunner(UniformSedovScenario(cfg), agg, device=device)
    runner.warmup()

    u, t = st.u, 0.0
    for step in range(args.steps):
        dt = courant_dt(u, cfg)
        t0 = time.perf_counter()
        u = runner.rk3_step(u, dt)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        t += float(dt)
        r = float(shock_radius(u, cfg))
        print(f"step {step + 1}: dt={float(dt):.3e}  t={t:.3e}  "
              f"R_shock={r:.4f}  {wall * 1e3:.0f} ms "
              f"({runner.stats['kernel_launches']} launches total)")

    for fam, st_ in runner.stats["regions"].items():
        print(f"{fam}: ladder {st_.get('ladder')}, launches "
              f"{st_['aggregated_hist']}, route "
              f"{st_.get('selected_strategy', args.strategy)}, cost model "
              f"(ms) {st_.get('cost_model_paths', st_.get('cost_model'))}")
    c1 = total_conserved(u, h)
    print(f"mass drift    : {abs(float((c1[0] - c0[0]) / c0[0])):.2e}")
    print(f"energy drift  : {abs(float((c1[4] - c0[4]) / c0[4])):.2e}")
    print(f"Sedov check   : R ∝ t^0.4 -> R/t^0.4 = "
          f"{float(shock_radius(u, cfg)) / t ** 0.4:.3f} (constant in time)")
    if bool(torch.isnan(u).any()):
        raise RuntimeError("solution went NaN")


if __name__ == "__main__":
    main()
