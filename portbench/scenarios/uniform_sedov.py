"""The uniform Sedov blast: ``UniformSedovScenario`` under
``StrategyRunner``, one hydro family of ``subgrid^3`` tasks."""
from __future__ import annotations

from types import SimpleNamespace

import torch

from portbench.initial import uniform_state
from portbench.reference import step as ref
from portbench.reference.grid import Uniform


class Cell:
    def __init__(self, config: dict, mix: dict, device: torch.device):
        self.config, self.mix, self.device = config, mix, device
        self.grid = Uniform(subgrid=config["subgrid"], ghost=config["ghost"],
                            levels=mix["size"]["levels"],
                            gamma=config["gamma"], cfl=config["cfl"],
                            domain=config["domain"])
        self.n_subgrids = (2 ** self.grid.levels) ** 3
        self.cells_per_step = self.grid.n ** 3
        # sub-grids the hydro family evaluates per RK3 step
        self.hydro_evaluations_per_step = 3 * self.n_subgrids

    def initial_state(self, seed: int) -> torch.Tensor:
        return uniform_state(self.grid, self.config, seed, self.device)

    @staticmethod
    def levels(state):
        return (state,)

    def program(self):
        """The program's runner for this cell, warmed up on the cell's own
        wave, with its Courant dt."""
        from repro_torch.configs.base import AggregationConfig, HydroConfig
        from repro_torch.core import StrategyRunner, UniformSedovScenario
        from repro_torch.hydro.stepper import courant_dt

        c = self.config
        cfg = HydroConfig(name=c["name"], subgrid=c["subgrid"],
                          ghost=c["ghost"], levels=self.grid.levels,
                          n_fields=c["n_fields"], gamma=c["gamma"],
                          cfl=c["cfl"], blast_energy=c["blast_energy"],
                          rho0=c["rho0"], domain=c["domain"],
                          dtype=c["dtype"])
        runner = StrategyRunner(UniformSedovScenario(cfg),
                                AggregationConfig(**self.mix["aggregation"]),
                                device=self.device)
        runner.warmup(wave_only=True)
        return SimpleNamespace(runner=runner, step=runner.rk3_step,
                               courant=lambda u: courant_dt(u, cfg))

    def reference(self):
        """The plain reference's Courant dt and step on level tuples, in
        the levels' own dtype."""
        g = self.grid
        return SimpleNamespace(
            courant=lambda lv: ref.uniform_courant_dt(lv[0], g),
            step=lambda lv, dt: (ref.uniform_step(lv[0], dt, g),))
