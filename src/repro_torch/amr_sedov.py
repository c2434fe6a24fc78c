"""Two-level AMR Sedov on the port: the multi-region aggregation runtime.

A coarse grid covers the whole domain; a centred fine patch refines the
blast at 2x resolution.  Every RK3 iteration submits a MIXED task list —
coarse and fine sub-grids, each task with its level's cell width — through
one aggregation executor.  With ``--mixed`` the levels use different
sub-grid sizes, so TWO kernel families aggregate side by side.
``--layout slot_lane`` runs the lane kernel (tasks across each warp) in
place of the slot_grid kernel; both layouts take the 16^3 family of
``--mixed`` (the slot_grid kernel in two x-slabs per slot).

Every strategy's result is checked bit-identical to the per-level fused
reference on the same level body; the ``mixed`` row routes each family by
its measured cost (``cost_model=True``) and prints the routes.

  PYTHONPATH=src python -m repro_torch.amr_sedov [--mixed] [--steps N] \
      [--layout slot_grid|slot_lane] [--device cuda|cpu]
"""
import argparse
import functools

import torch

from repro_torch.configs.amr_sedov import CONFIG, CONFIG_MIXED
from repro_torch.configs.base import AggregationConfig
from repro_torch.core import AMRSedovScenario, StrategyRunner
from repro_torch.device import resolve_device
from repro_torch.hydro.state import amr_sedov_init
from repro_torch.hydro.stepper import amr_courant_dt, amr_reference_step
from repro_torch.kernels.hydro_rhs import LAYOUTS
from repro_torch.kernels.ops import level_batched_body

ROWS = (("fused", dict(strategy="fused")),
        ("s3", dict(strategy="s3", max_aggregated=16)),
        ("s2+s3", dict(strategy="s2+s3", n_executors=4, max_aggregated=16)),
        ("mixed", dict(strategy="mixed", max_aggregated=16,
                       cost_model=True)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mixed", action="store_true",
                    help="different per-level sub-grid sizes (two families)")
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--layout", default="slot_grid", choices=LAYOUTS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = CONFIG_MIXED if args.mixed else CONFIG
    body = functools.partial(level_batched_body, cfg.gamma, cfg.ghost,
                             layout=args.layout)
    print(f"{cfg.name}: coarse {cfg.n_coarse}^3 (h={cfg.h_coarse:.4f}) + "
          f"fine {cfg.n_fine}^3 patch (h={cfg.h_fine:.4f}), "
          f"{cfg.n_subgrids_coarse}+{cfg.n_subgrids_fine} tasks/iteration, "
          f"layout {args.layout} on {device}")

    st = amr_sedov_init(cfg, device=device)
    dt = amr_courant_dt(st.uc, st.uf, cfg)
    ref_c, ref_f = st.uc, st.uf
    for _ in range(args.steps):
        ref_c, ref_f = amr_reference_step(ref_c, ref_f, dt, cfg,
                                          level_body=body)

    for label, kw in ROWS:
        r = StrategyRunner(AMRSedovScenario(cfg, hydro_body=body),
                           AggregationConfig(**kw), device=device)
        r.warmup()
        uc, uf = st.uc, st.uf
        for _ in range(args.steps):
            uc, uf = r.rk3_step((uc, uf), dt)
        ok = torch.equal(uc, ref_c) and torch.equal(uf, ref_f)
        fams = ""
        if r.executor is not None:
            hists = {k: v["aggregated_hist"]
                     for k, v in r.executor.stats["regions"].items()}
            fams = f"  families={hists}"
            routes = {k: v["selected_strategy"]
                      for k, v in r.executor.stats["regions"].items()
                      if "selected_strategy" in v}
            if routes:
                fams += f"  routes={routes}"
        print(f"  {label:6s} launches={r.stats['kernel_launches']:4d}  "
              f"bit-identical={ok}{fams}")
        if not ok:
            raise SystemExit(f"strategy {label} diverged from the per-level "
                             f"reference")
    print("all strategies bit-identical to the per-level fused reference")


if __name__ == "__main__":
    main()
