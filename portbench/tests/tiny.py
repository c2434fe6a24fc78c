"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in seconds, and
one run of the harness on them (the card's look skipped)."""
from __future__ import annotations

import copy
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from portbench import harness
from portbench import manifest as mf

SEED = 2 ** 31 + 977
# 8 sub-grids of 8^3 (levels 1); on two levels 16^3 coarse cells and a
# 16^3 fine patch, 8 + 8 sub-grids: each touches the blast at the centre
SIZES = {"sedov8": {"levels": 1},
         "amr-sedov8": {"coarse_grids_per_edge": 2, "cover": 8}}
# the least sizes with sub-grids far from the blast: 64 sub-grids, the
# blast on the centre 8 (21, 22, 25, 26, 37, 38, 41, 42); on two levels
# 32^3 coarse cells and a 32^3 fine patch, 64 + 64 sub-grids, the blast on
# the fine patch's centre 8.  Slot 0 of each bucket of 4 is never one that
# the blast touches.
AMBIENT = {"sedov8": {"levels": 2},
           "amr-sedov8": {"coarse_grids_per_edge": 4, "cover": 16}}


def cell(name: str, here: Path = mf.HERE, manifest: dict = None,
         sizes: dict = SIZES):
    """``(workload, config, mix)`` of a cell at the tiny size (or
    ``sizes``): buckets of 4, a restart every 4 steps, 3 traced steps."""
    manifest = manifest or mf.load()
    wl = mf.workload(manifest, name)
    config = mf.config(wl["config"], here)
    mix = copy.deepcopy(mf.mix(wl["traffic"], here))
    mix.update(size=sizes[wl["config"]], restart_every=4, trace_steps=3)
    mix["aggregation"]["max_aggregated"] = 4
    return wl, config, mix


def run(name: str, *, program=None, trace: bool = False,
        here: Path = mf.HERE, manifest: dict = None, seed: int = SEED,
        sizes: dict = SIZES, log=lambda msg: None) -> dict:
    """One run of the cell at the tiny size (or ``sizes``) on the CPU: its
    window closes as soon as one segment's checked steps are in."""
    manifest = manifest or mf.load()
    wl, config, mix = cell(name, here, manifest, sizes)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run_cell(wl, config, mix, seed, 0.0, trace,
                                torch.device("cpu"), manifest,
                                time.perf_counter(), log, here=here,
                                program=program)
    finally:
        torch.set_num_threads(threads)


def program_of(name: str, sizes: dict = SIZES, **changes):
    """The cell's program at the tiny size (or ``sizes``) with ``changes``
    (``step``, ``courant``) put in place of its own."""
    def make():
        _, config, mix = cell(name, sizes=sizes)
        import importlib
        scenario = importlib.import_module(
            f"portbench.scenarios.{config['scenario']}")
        prog = scenario.Cell(config, mix, torch.device("cpu")).program()
        fields = dict(vars(prog))
        fields.update({k: v(prog) for k, v in changes.items()})
        return SimpleNamespace(**fields)
    return make
