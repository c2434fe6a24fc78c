"""Data helpers of the port: the synthetic training stream and the serving
engine's bucket choice."""
from repro_torch.data.pipeline import (  # noqa: F401
    DataConfig, SyntheticLMStream, length_bucket, make_batch_specs,
)
