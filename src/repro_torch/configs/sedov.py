"""The paper's own benchmark scenario: Sedov-Taylor blast wave, AMR off.

Paper Table II: 8^3 sub-grids / 3 levels -> 512 leaves (262144 cells);
16^3 sub-grids / 2 levels -> 64 leaves (same 262144 cells).  The port's
kernel takes ``CONFIG``; ``CONFIG_16`` needs a tiled kernel (ROADMAP.md).
"""
from repro_torch.configs.base import HydroConfig

CONFIG = HydroConfig(name="sedov", subgrid=8, ghost=3, levels=3)
CONFIG_16 = HydroConfig(name="sedov16", subgrid=16, ghost=3, levels=2)
