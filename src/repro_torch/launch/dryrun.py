"""Multi-pod dry run: size every (arch x shape x mesh) cell without a
compiler (``repro.launch.dryrun``'s counterpart).

For each cell this script:
  1. builds the production mesh (16 x 16 one pod, 2 x 16 x 16 two pods:
     placeholder devices, ``launch.mesh``),
  2. derives the parameter, optimizer, batch and cache specs from the
     logical rules (``launch.sharding``) over a model built on ``meta``,
  3. counts each device's bytes of parameters, optimizer state (fp32
     ``m`` and ``v``, the step), batch and cache from the shapes and the
     specs, and checks their sum against one card's 80 GB,
  4. adds the analytic roofline terms (``launch.roofline``).

The reference lowers and compiles each cell and reads XLA's memory
analysis, cost analysis and collective schedule; the port has no such
compiler, so ``temp_size_in_bytes``, ``compile_s``, the raw cost analysis
and the collectives are ``null`` and ``"note"`` says why.  The other keys
are the reference's.  Prints one JSON object per cell and writes files
only under ``--out``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-15b \\
        --shape train_4k --mesh pod [--out DIR]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict

import torch

from repro_torch.configs import ARCHS, SHAPES_BY_NAME, get_config
from repro_torch.configs.base import shape_applicable
from repro_torch.distributed.api import tree_map
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import roofline_terms
from repro_torch.launch.sharding import device_bytes, make_all_specs

# NVIDIA H100 80GB HBM3: the 80 GB its name gives
CARD_BYTES = 80e9
NOTE = ("temp_size_in_bytes, compile_s, hlo_cost_analysis_raw and the "
        "collectives come from XLA's compiled program, which the port has "
        "no counterpart of: null; the memory counts the step's arguments "
        "from shapes and specs, a lower bound of the peak")


def opt_shapes(params_sh) -> Dict[str, Any]:
    """The optimizer state's shapes: fp32 ``m`` and ``v`` beside each
    parameter, an int32 step."""
    def fp32(t):
        return torch.empty(t.shape, dtype=torch.float32, device="meta")
    return {"m": tree_map(fp32, params_sh), "v": tree_map(fp32, params_sh),
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool,
                verbose: bool = True) -> Dict[str, Any]:
    cfg = get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    mesh_name = "multipod" if multi_pod else "pod"
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "skipped": why}

    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    # the reference's training policy: no Megatron-SP but for MoE
    overrides: Dict[str, Any] = {}
    if shape.kind == "train" and cfg.family != "moe":
        overrides["seq_sp"] = None

    (params_sh, batch_sh, cache_sh, pspec, ospec, bspec, cspec
     ) = make_all_specs(cfg, shape, mesh, overrides=overrides)
    parts = {"params_bytes_per_device": device_bytes(params_sh, pspec, mesh),
             "batch_bytes_per_device": device_bytes(batch_sh, bspec, mesh)}
    if shape.kind == "train":
        parts["opt_bytes_per_device"] = device_bytes(opt_shapes(params_sh),
                                                     ospec, mesh)
    if cache_sh is not None:
        parts["cache_bytes_per_device"] = device_bytes(cache_sh, cspec, mesh)
    args = sum(parts.values())
    # what the step donates: params and state (train), the cache (decode)
    alias = (parts["params_bytes_per_device"]
             + parts["opt_bytes_per_device"] if shape.kind == "train"
             else parts.get("cache_bytes_per_device", 0))
    memory = dict(parts, argument_size_in_bytes=args,
                  alias_size_in_bytes=alias, temp_size_in_bytes=None,
                  peak_bytes_per_device_est=args, card_bytes=CARD_BYTES,
                  fits=args <= CARD_BYTES)
    roof = roofline_terms(cfg, shape, chips, {"total": 0.0})
    roof.update(collective_s=None, collective_bytes_per_device=None,
                collectives=None)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "chips": chips, "compile_s": None, "memory": memory,
              "roofline": roof, "hlo_cost_analysis_raw": None, "note": NOTE}
    if verbose:
        print(json.dumps(result, indent=2), flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=("pod", "multipod", "both"),
                    default="pod")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="",
                    help="a directory for one JSON file per cell")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES_BY_NAME) if (args.all or not args.shape) \
        else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    failures = []
    for mesh_name in meshes:
        for arch in archs:
            for shape in shapes:
                try:
                    res = dryrun_cell(arch, shape,
                                      multi_pod=(mesh_name == "multipod"))
                except Exception as e:  # noqa: BLE001 — report, keep going
                    import traceback
                    traceback.print_exc()
                    failures.append((mesh_name, arch, shape, repr(e)))
                    continue
                if args.out:
                    path = os.path.join(
                        args.out, f"dryrun_{mesh_name}_{arch}_{shape}.json")
                    with open(path, "w") as f:
                        json.dump(res, f, indent=2)
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        return 1
    print("all requested cells sized")
    return 0


if __name__ == "__main__":
    sys.exit(main())
