"""The paper's own benchmark scenario: Sedov-Taylor blast wave, AMR off.

Paper Table II: 8^3 sub-grids / 3 levels -> 512 leaves (262144 cells);
16^3 sub-grids / 2 levels -> 64 leaves (same 262144 cells).  The port's
slot_grid kernel takes ``CONFIG``; ``CONFIG_16`` runs on the lane kernel
(``layout="slot_lane"``), the slot_grid kernel's shared memory being too
small for a 16^3 slot (ROADMAP.md).
"""
from repro_torch.configs.base import HydroConfig

CONFIG = HydroConfig(name="sedov", subgrid=8, ghost=3, levels=3)
CONFIG_16 = HydroConfig(name="sedov16", subgrid=16, ghost=3, levels=2)
