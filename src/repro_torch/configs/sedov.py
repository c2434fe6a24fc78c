"""The paper's own benchmark scenario: Sedov-Taylor blast wave, AMR off.

Paper Table II: 8^3 sub-grids / 3 levels -> 512 leaves (262144 cells);
16^3 sub-grids / 2 levels -> 64 leaves (same 262144 cells).  ``CONFIG_16``
is the paper's strategy 1 (larger sub-grids) under any strategy; both run
on either layout, the slot_grid kernel splitting each 16^3 slot into two
x-slabs (``kernels.hydro_rhs.slab_plan``).
"""
from repro_torch.configs.base import HydroConfig

CONFIG = HydroConfig(name="sedov", subgrid=8, ghost=3, levels=3)
CONFIG_16 = HydroConfig(name="sedov16", subgrid=16, ghost=3, levels=2)
