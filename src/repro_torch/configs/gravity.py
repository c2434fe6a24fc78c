"""Self-gravitating Sedov blast (the cross-solver aggregation workload).

* ``CONFIG``       — 64 sub-grids of 8^3 (levels=2): the reference's
  benchmark size.
* ``CONFIG_SMALL`` — 8 sub-grids of 8^3 (levels=1): the test size, where
  each family's iteration drains as one bucket-8 launch.

The paper's grid (Table II, 512 sub-grids) under gravity is
``GravityHydroConfig(hydro=repro_torch.configs.sedov.CONFIG)``.  Both
families, hydro ("hydro_rhs") and gravity ("gravity"), are submitted
interleaved into ONE ``AggregationExecutor`` per iteration.
"""
from repro_torch.configs.base import GravityHydroConfig, HydroConfig

CONFIG = GravityHydroConfig(hydro=HydroConfig(name="sedov", subgrid=8,
                                              ghost=3, levels=2))

CONFIG_SMALL = GravityHydroConfig(
    name="gravity_sedov_small",
    hydro=HydroConfig(name="sedov", subgrid=8, ghost=3, levels=1))
