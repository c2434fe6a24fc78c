from repro_torch.configs.base import (  # noqa: F401
    AggregationConfig, HydroConfig, validate_ladder,
)
