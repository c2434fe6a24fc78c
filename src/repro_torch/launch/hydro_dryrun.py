"""Distributed dry run of the paper's own scenario: the Sedov blast wave's
assembled grid sharded across the production mesh, sized without a
compiler (``repro.launch.hydro_dryrun``'s counterpart).

The state ``(5, n, n, n)`` fp32 shards x over ``data`` (over ``pod`` and
``data`` on two pods) and y over ``model``, the reference's
decomposition.  Each device's bytes of the state come from the shape and
the spec, and the ghost faces a shard reads from its neighbours per RK3
step (3 stages, ``ghost`` layers of the 5 fields on both faces of each
sharded axis) are counted analytically.  The reference reads the step's
temporaries and its halo collectives from XLA's compiled program, which
the port has no counterpart of: ``temp_bytes_per_device`` and
``collectives`` are ``null`` and ``"note"`` says why.

    PYTHONPATH=src python -m repro_torch.launch.hydro_dryrun \\
        [--multipod] [--levels 4] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict

from repro_torch.configs.base import HydroConfig
from repro_torch.distributed.api import PartitionSpec as P
from repro_torch.launch.dryrun import CARD_BYTES
from repro_torch.launch.mesh import make_production_mesh

FIELDS = 5
STAGES = 3
NOTE = ("temp_bytes_per_device and the collectives come from XLA's "
        "compiled program, which the port has no counterpart of: null; "
        "halo_bytes_per_device_per_step counts the ghost faces analytically")


def hydro_dryrun(levels: int = 4, multi_pod: bool = False
                 ) -> Dict[str, Any]:
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg = HydroConfig(subgrid=8, ghost=3, levels=levels)
    n = cfg.grids_per_edge * cfg.subgrid
    spec = P(None, ("pod", "data"), "model", None) if multi_pod \
        else P(None, "data", "model", None)
    sx = mesh.shape["data"] * mesh.shape.get("pod", 1)
    sy = mesh.shape["model"]
    bx, by = n // sx, n // sy
    state = FIELDS * n ** 3 * 4
    per_device = FIELDS * bx * by * n * 4
    # both faces of x (by x n) and of y (bx x n), ghost layers, per stage
    halo = STAGES * FIELDS * 4 * 2 * cfg.ghost * n * (
        (by if sx > 1 else 0) + (bx if sy > 1 else 0))
    return {
        "scenario": "sedov", "mesh": "multipod" if multi_pod else "pod",
        "chips": mesh.size, "cells": cfg.cells_total,
        "subgrids": cfg.n_subgrids, "grid": [FIELDS, n, n, n],
        "spec": list(spec), "block": [FIELDS, bx, by, n],
        "state_bytes": state, "state_bytes_per_device": per_device,
        "halo_bytes_per_device_per_step": halo,
        "card_bytes": CARD_BYTES, "fits": per_device <= CARD_BYTES,
        "temp_bytes_per_device": None,
        "halo_collective_bytes_per_device": None, "collectives": None,
        "note": NOTE,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--levels", type=int, default=4,
                    help="4 -> 4096 sub-grids of 8^3 (2M cells)")
    ap.add_argument("--out", default="",
                    help="a directory for the JSON file")
    args = ap.parse_args(argv)
    result = hydro_dryrun(args.levels, args.multipod)
    print(f"hydro dry-run: {result['subgrids']} sub-grids of 8^3 "
          f"({result['grid'][1]}^3 cells) on {result['chips']} chips")
    print(json.dumps(result, indent=2))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out,
                               f"hydro_dryrun_{result['mesh']}.json"),
                  "w") as f:
            json.dump(result, f, indent=2)
    print("OK: the hydro state is sized on the production mesh")
    return 0


if __name__ == "__main__":
    sys.exit(main())
