"""Aggregation runtime of the port: executors (CUDA streams), the
aggregation executor, scenarios and strategies."""
from repro_torch.core.aggregation import (  # noqa: F401
    AggregationExecutor, RangeFuture, SlotView, TaskFuture, TaskSignature,
    gather_futures, greedy_decomposition, make_s2_scatter,
)
from repro_torch.core.buffers import BufferPool, SlotRing  # noqa: F401
from repro_torch.core.executor import DeviceExecutor, ExecutorPool  # noqa: F401
from repro_torch.core.scenario import (  # noqa: F401
    AMRSedovScenario, GravityScenario, KernelFamily, Scenario,
    TaskPopulation, UniformSedovScenario,
)
from repro_torch.core.graphs import CaptureError, CapturedCall  # noqa: F401
from repro_torch.core.strategies import (  # noqa: F401
    AMRStrategyRunner, HydroStrategyRunner, StrategyRunner,
    available_strategies, s2,
)
