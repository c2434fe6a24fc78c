from repro_torch.configs.base import (  # noqa: F401
    AggregationConfig, GravityHydroConfig, HydroConfig, validate_ladder,
)
