"""Logical-axis sharding rules and the port's mesh (``api``), and
data-parallel training, the resilient loop and elastic re-placement
(``fault_tolerance``), exported as the reference exports them."""
from repro_torch.distributed.api import (  # noqa: F401
    DEFAULT_RULES, Mesh, NamedSharding, PartitionSpec, ShardingRules,
    constrain, current_rules, logical_rules, place, process_group, spec_for,
    subgrid_mesh,
)
from repro_torch.distributed.fault_tolerance import (  # noqa: F401
    SimulatedFailure, make_dp_train_step, rescale_state, residual_init,
    resilient_loop,
)

__all__ = [
    "ShardingRules", "constrain", "current_rules", "logical_rules",
    "spec_for", "SimulatedFailure", "make_dp_train_step", "rescale_state",
    "residual_init", "resilient_loop",
]
