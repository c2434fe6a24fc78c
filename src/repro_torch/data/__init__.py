"""Data helpers of the port: the serving engine's bucket choice."""
from repro_torch.data.pipeline import length_bucket  # noqa: F401
