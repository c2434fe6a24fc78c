"""The frozen counts and peaks against the program's, at the cells'
shapes today."""
import importlib
import re
from pathlib import Path

import pytest
import torch

from portbench import manifest as mf
from portbench import yardstick

ROOT = Path(__file__).resolve().parents[2]


def _cells():
    man = mf.load()
    for wl in man["workloads"]:
        config, mix = mf.config(wl["config"]), mf.mix(wl["traffic"])
        scenario = importlib.import_module(
            f"portbench.scenarios.{config['scenario']}")
        yield wl["name"], config, scenario.Cell(config, mix,
                                                torch.device("cpu"))


@pytest.mark.parametrize("name", [w["name"] for w in mf.load()["workloads"]])
def test_frozen_counts_equal_the_program_at_each_cell(name):
    from repro_torch.kernels import counts

    _, config, cell = next(c for c in _cells() if c[0] == name)
    n = cell.hydro_evaluations_per_step
    s, g = config["subgrid"], config["ghost"]
    assert yardstick.hydro_rhs_ops(n, s, g) == counts.hydro_rhs_ops(n, s, g)


@pytest.mark.parametrize("n,subgrid", ((1, 8), (512, 8), (4096, 8),
                                       (64, 16), (1, 5)))
def test_frozen_counts_equal_the_program(n, subgrid):
    from repro_torch.kernels import counts

    assert (yardstick.hydro_rhs_ops(n, subgrid, 3)
            == counts.hydro_rhs_ops(n, subgrid, 3))


def test_roofline_arithmetic_and_peaks():
    """The peaks ``chip_smoke.py``'s bounds use, and its 512-slot bound of
    the hydro kernel: 1.366 GFLOP and 33.3 MB, bound by operations."""
    text = (ROOT / "chip_smoke.py").read_text()
    for name, key in (("HBM_BYTES_PER_S", "hbm_bytes_per_s"),
                      ("FP32_FLOP_PER_S", "fp32_flop_per_s"),
                      ("BF16_FLOP_PER_S", "bf16_flop_per_s")):
        value = float(re.search(rf"^{name} = (\S+)", text, re.M).group(1))
        assert yardstick.PEAKS[key] == value
    ops = yardstick.hydro_rhs_ops(512, 8, 3)
    n_bytes = yardstick.hydro_rhs_bytes(512, 8, 3)
    assert round(ops / 1e9, 3) == 1.366
    assert round(n_bytes / 1e6, 1) == 33.3
    bound = yardstick.roofline_s(ops, n_bytes)
    assert bound == ops / 67e12
    assert round(bound * 1e3, 4) == 0.0204
