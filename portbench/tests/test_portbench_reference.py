"""The plain reference against the port's CPU path at a tiny size, and a
mutated reference that the comparison must refuse."""
import importlib
import importlib.util
import random
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import compare, harness
from portbench.tests import tiny

REFERENCE = Path(__file__).resolve().parent.parent / "reference"
CELLS = ("sedov8.l4-s3-cap512", "amr-sedov8.c16-s3-cap512")


def _cell(name):
    _, config, mix = tiny.cell(name)
    scenario = importlib.import_module(
        f"portbench.scenarios.{config['scenario']}")
    return config, scenario.Cell(config, mix, torch.device("cpu"))


def _program_steps(cell, u0, steps):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        w = harness.drive(cell.program(), u0, steps, steps,
                          random.Random(0), steps=steps)
    finally:
        torch.set_num_threads(threads)
    return [(d, cell.levels(s)) for d, s in w.kept]


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(name):
    """The uniform and two-level steps and the Courant dt, three steps
    from a seeded state, through the harness's whole run."""
    result = tiny.run(name)
    assert result["correct"] is True
    for check in result["checks"].values():
        assert check["value"] <= 1e-3 * check["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_courant_dt_agrees(name):
    config, cell = _cell(name)
    u0 = cell.initial_state(tiny.SEED)
    prog = cell.program()
    want = cell.reference().courant(cell.levels(u0))
    got = prog.courant(u0)
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)
    assert float(want) > 0


def _load_package(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        name, path / "__init__.py", submodule_search_locations=[str(path)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", CELLS)
def test_mutated_reference_fails_the_comparison(tmp_path, name):
    """One operator changed in the central-upwind flux: the port's steps
    no longer meet the limits against it."""
    mut = tmp_path / "portbench_mutref"
    shutil.copytree(REFERENCE, mut)
    flux = mut / "flux.py"
    text = flux.read_text()
    before = "(ap * fL - am * fR) * inv"
    assert text.count(before) == 1
    flux.write_text(text.replace(before, "(ap * fL + am * fR) * inv"))
    pkg_name = f"portbench_mutref_{name.partition('.')[0].replace('-', '_')}"
    try:
        _load_package(mut, pkg_name)
        step = importlib.import_module(f"{pkg_name}.step")
        config, cell = _cell(name)
        g = cell.grid
        if config["scenario"] == "uniform_sedov":
            mutated = SimpleNamespace(
                courant=lambda lv: step.uniform_courant_dt(lv[0], g),
                step=lambda lv, dt: (step.uniform_step(lv[0], dt, g),))
        else:
            mutated = SimpleNamespace(
                courant=lambda lv: step.two_level_courant_dt(lv[0], lv[1], g),
                step=lambda lv, dt: step.two_level_step(lv[0], lv[1], dt, g))
        u0 = cell.initial_state(tiny.SEED)
        steps = config["check"]["steps"]
        got = _program_steps(cell, u0, steps)
        limits = config["check"]["limits"]
        lv0, sub = cell.levels(u0), config["subgrid"]
        sound = compare.numbers(got, compare.reference_steps(
            cell.reference(), lv0, steps), lv0, sub)
        assert compare.verdict(sound, limits)
        nums = compare.numbers(got, compare.reference_steps(
            mutated, lv0, steps), lv0, sub)
        assert not compare.verdict(nums, limits), nums
    finally:
        for mod in [m for m in sys.modules if m.startswith(pkg_name)]:
            del sys.modules[mod]
