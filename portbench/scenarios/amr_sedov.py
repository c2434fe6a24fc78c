"""The two-level refined Sedov blast: ``AMRSedovScenario`` under
``StrategyRunner``, coarse and fine tasks of one ``subgrid^3`` family with
the cell width per task, and the two-level exchange between them."""
from __future__ import annotations

from types import SimpleNamespace

import torch

from portbench.initial import two_level_state
from portbench.reference import step as ref
from portbench.reference.grid import TwoLevel


class Cell:
    def __init__(self, config: dict, mix: dict, device: torch.device):
        self.config, self.mix, self.device = config, mix, device
        size = mix["size"]
        self.grid = TwoLevel(subgrid=config["subgrid"], ghost=config["ghost"],
                             coarse_grids_per_edge=size[
                                 "coarse_grids_per_edge"],
                             cover=size["cover"],
                             refine_ratio=config["refine_ratio"],
                             gamma=config["gamma"], cfl=config["cfl"],
                             domain=config["domain"])
        g = self.grid
        n_fine_grids = (g.n_fine // g.subgrid) ** 3
        self.n_subgrids = g.coarse_grids_per_edge ** 3 + n_fine_grids
        # both levels' interior cells, the covered coarse ones included
        self.cells_per_step = g.n_coarse ** 3 + g.n_fine ** 3
        self.hydro_evaluations_per_step = 3 * self.n_subgrids

    def initial_state(self, seed: int):
        return two_level_state(self.grid, self.config, seed, self.device)

    @staticmethod
    def levels(state):
        return tuple(state)

    def program(self):
        from repro_torch.configs.base import AggregationConfig, AMRHydroConfig
        from repro_torch.core import AMRSedovScenario, StrategyRunner
        from repro_torch.hydro.stepper import amr_courant_dt

        c, g = self.config, self.grid
        cfg = AMRHydroConfig(name=c["name"], coarse_subgrid=c["subgrid"],
                             fine_subgrid=c["subgrid"], ghost=c["ghost"],
                             coarse_grids_per_edge=g.coarse_grids_per_edge,
                             cover=g.cover, refine_ratio=c["refine_ratio"],
                             n_fields=c["n_fields"], gamma=c["gamma"],
                             cfl=c["cfl"], blast_energy=c["blast_energy"],
                             rho0=c["rho0"], domain=c["domain"],
                             dtype=c["dtype"])
        runner = StrategyRunner(AMRSedovScenario(cfg),
                                AggregationConfig(**self.mix["aggregation"]),
                                device=self.device)
        runner.warmup(wave_only=True)
        return SimpleNamespace(
            runner=runner, step=runner.rk3_step,
            courant=lambda s: amr_courant_dt(s[0], s[1], cfg))

    def reference(self):
        g = self.grid
        return SimpleNamespace(
            courant=lambda lv: ref.two_level_courant_dt(lv[0], lv[1], g),
            step=lambda lv, dt: ref.two_level_step(lv[0], lv[1], dt, g))
