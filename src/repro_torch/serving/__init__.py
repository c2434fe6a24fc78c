"""The serving engine: continuous batching over the port's decode path."""
from repro_torch.serving.engine import EngineOverloaded, Request, ServingEngine

__all__ = ["EngineOverloaded", "Request", "ServingEngine"]
