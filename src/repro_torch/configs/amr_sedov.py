"""Two-level refined Sedov blast (the adaptive workload).

* ``CONFIG``       — both levels use 8^3 sub-grids (8 + 8 tasks per
  iteration).  Per-task shapes agree, so coarse and fine tasks share ONE
  ``TaskSignature`` family: one kernel serves both levels, the per-level
  cell width riding in as a per-task argument.
* ``CONFIG_MIXED`` — the coarse level is a single 16^3 sub-grid while the
  fine level stays 8^3: two ``TaskSignature`` families aggregate through
  one executor.  Its 16^3 family runs on either layout on the card (the
  slot_grid kernel splits a 16^3 slot into two x-slabs).

Both refine the central half of the domain at 2x resolution, which fully
contains the Sedov blast sphere.
"""
from repro_torch.configs.base import AMRHydroConfig

CONFIG = AMRHydroConfig()

CONFIG_MIXED = AMRHydroConfig(name="amr_sedov_mixed", coarse_subgrid=16,
                              coarse_grids_per_edge=1)
