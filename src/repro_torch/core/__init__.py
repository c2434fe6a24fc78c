"""Aggregation runtime of the port: executors (CUDA streams), the
aggregation executor with its measured tuning, scenarios and strategies.

Fault injection and containment (``faults``), the warm-start tune store
and roofline prior (``tunestore``), and the sharded executor and tenant
batcher (``sharding``) are exported as the reference exports them.
"""
from repro_torch.core.aggregation import (  # noqa: F401
    AggregationExecutor, BucketCostModel, LaunchTimer, RangeFuture, SlotView,
    TaskFuture, TaskSignature, aggregation_region, derive_ladder,
    gather_futures, greedy_decomposition, greedy_launches, ladder_candidates,
    make_s2_scatter, reset_regions,
)
from repro_torch.core.buffers import BufferPool, SlotRing  # noqa: F401
from repro_torch.core.executor import DeviceExecutor, ExecutorPool  # noqa: F401
from repro_torch.core.faults import (  # noqa: F401
    BucketCompileError, FaultError, FaultInjector, FaultSpec,
    LaunchFaultError, NonFiniteStateError, QuarantineList, RegionFaultError,
    TaskFailedError, all_finite,
)
from repro_torch.core.scenario import (  # noqa: F401
    AMRSedovScenario, GravityScenario, KernelFamily, Scenario,
    TaskPopulation, UniformSedovScenario, stage_family,
)
from repro_torch.core.graphs import CaptureError, CapturedCall  # noqa: F401
from repro_torch.core.sharding import (  # noqa: F401
    ShardedAggregationExecutor, TenantBatcher,
)
from repro_torch.core.tunestore import (  # noqa: F401
    RooflinePrior, TuneStore, TuneStoreWarning,
)
from repro_torch.core.strategies import (  # noqa: F401
    AMRStrategyRunner, HydroStrategyRunner, RunContext, Strategy,
    StrategyRunner, available_strategies, get_strategy_class,
    register_strategy, s2,
)

__all__ = [
    "AggregationExecutor", "BucketCostModel", "LaunchTimer", "RangeFuture",
    "SlotView", "TaskFuture", "TaskSignature", "aggregation_region",
    "derive_ladder", "gather_futures", "greedy_decomposition",
    "greedy_launches", "ladder_candidates", "make_s2_scatter",
    "reset_regions",
    "BufferPool", "SlotRing", "DeviceExecutor", "ExecutorPool",
    "FaultError", "FaultSpec", "FaultInjector", "BucketCompileError",
    "LaunchFaultError", "TaskFailedError", "RegionFaultError",
    "NonFiniteStateError", "QuarantineList", "all_finite",
    "Scenario", "KernelFamily", "TaskPopulation", "stage_family",
    "UniformSedovScenario", "AMRSedovScenario", "GravityScenario",
    "CaptureError", "CapturedCall",
    "ShardedAggregationExecutor", "TenantBatcher",
    "TuneStore", "RooflinePrior", "TuneStoreWarning",
    "Strategy", "RunContext", "StrategyRunner", "available_strategies",
    "get_strategy_class", "register_strategy",
    "AMRStrategyRunner", "HydroStrategyRunner",
]
