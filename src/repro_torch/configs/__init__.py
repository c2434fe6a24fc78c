from repro_torch.configs.base import (  # noqa: F401
    AggregationConfig, AMRHydroConfig, GravityHydroConfig, HydroConfig,
    validate_ladder,
)
