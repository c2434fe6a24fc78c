"""The readings the comparison's limits are set from, at the cells' own
sizes, on the card (the benchmark's runs do not run this).

  python3 portbench/control.py [--cells a,b,...] [--seeds 12] \
      [--control-seeds 3] [--seed-base N] [--out FILE]

For each seed, the plain fp32 reference's first ``check.steps`` steps from
the cell's initial state, and against them (``compare.numbers``):

* the program, through the timed window's loop (``harness.drive``) from
  the same state: the lower readings;
* the control, the same reference computed in bfloat16 (the nearest
  precision below the configuration's fp32 that changes this arithmetic;
  it has no matrix product for TF32 to touch), on the first
  ``--control-seeds`` seeds: the upper readings.

Cells of one configuration at one size share each seed's reference.
Prints each reading and, per cell, the largest program reading and the
smallest control reading of each number.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from portbench import compare, harness  # noqa: E402
from portbench import manifest as mf  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default="all")
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seed-base", type=int, default=3_000_000_017)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 4
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    man = mf.load()
    names = ([w["name"] for w in man["workloads"]] if args.cells == "all"
             else args.cells.split(","))
    groups = {}
    for name in names:
        wl = mf.workload(man, name)
        mix = mf.mix(wl["traffic"])
        groups.setdefault((wl["config"], json.dumps(mix["size"])),
                          []).append((wl, mix))
    seeds = [args.seed_base + 7919 * i for i in range(args.seeds)]
    out = {"device": torch.cuda.get_device_name(device), "seeds": seeds,
           "cells": {}}
    for (config_name, _), members in groups.items():
        config = mf.config(config_name)
        steps = config["check"]["steps"]
        scenario = __import__(f"portbench.scenarios.{config['scenario']}",
                              fromlist=["Cell"])
        cells = [(wl, scenario.Cell(config, mix, device))
                 for wl, mix in members]
        progs = [(wl, cell, cell.program()) for wl, cell in cells]
        cell0 = cells[0][1]
        for i, seed in enumerate(seeds):
            u0 = cell0.initial_state(seed)
            lv0 = cell0.levels(u0)
            t = time.perf_counter()
            ref = compare.reference_steps(cell0.reference(), lv0, steps)
            ref_s = time.perf_counter() - t
            for wl, cell, prog in progs:
                w = harness.drive(prog, u0, steps, steps, random.Random(0),
                                  steps=steps)
                nums = compare.numbers(
                    [(d, cell.levels(s)) for d, s in w.kept], ref, lv0,
                    config["subgrid"])
                rec = out["cells"].setdefault(wl["name"], {
                    "program": [], "control": []})
                rec["program"].append({"seed": seed, **nums})
                print(f"{wl['name']} seed {seed} program {nums} "
                      f"(reference {ref_s:.2f} s)", flush=True)
            if i < args.control_seeds:
                low = compare.reference_steps(cell0.reference(), lv0, steps,
                                              dtype=torch.bfloat16)
                nums = compare.numbers(low, ref, lv0, config["subgrid"])
                for wl, _, _ in progs:
                    out["cells"][wl["name"]]["control"].append(
                        {"seed": seed, **nums})
                print(f"{config_name} seed {seed} control bf16 {nums}",
                      flush=True)
            del u0, lv0, ref
        del progs, cells
        torch.cuda.empty_cache()
    for name, rec in out["cells"].items():
        lower = {k: max(r[k] for r in rec["program"]) for k in compare.NAMES}
        upper = {k: min((r[k] for r in rec["control"]), default=None)
                 for k in compare.NAMES}
        rec["lower"], rec["upper"] = lower, upper
        print(f"{name}: lower {lower} upper {upper}", flush=True)
    out["seconds"] = time.perf_counter() - T0
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
