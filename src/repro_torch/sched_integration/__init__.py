# The paper's scheduler integrated as first-class framework features (PyTorch
# port): MoE expert placement, serving-request dispatch, the fabric-batched
# mapping-event pipeline, and the chaos tier (topology + failure timelines).
from repro_torch.sched_integration.expert_placement import (
    apply_placement,
    makespan,
    placement_permutation,
    plan_expert_placement,
    round_robin_assignment,
)
from repro_torch.sched_integration.cost_model import (
    CostCell,
    CostModelRegistry,
    registry_from_dryrun_artifacts,
    scaled_cell,
)
from repro_torch.sched_integration.fabric import (
    MappingFabric,
    eft_dispatch_numpy,
    heft_rt_fast,
    make_policy_fabric,
    pow2_bucket,
    service_time_matrix,
)
from repro_torch.sched_integration.serve_scheduler import (
    POLICIES,
    Replica,
    Request,
    ServeResult,
    default_fleet,
    goodput,
    make_requests,
    mesh_fleet,
    simulate_serving,
)
from repro_torch.sched_integration.fleet import (
    FAILURE_KINDS,
    FailureEvent,
    FleetController,
    FleetControllerConfig,
    ResizeEvent,
    grown_replica_factory,
    load_failure_timeline,
    make_spike_requests,
    merge_event,
    split_event,
    validate_failure_timeline,
)
from repro_torch.sched_integration.topology import (
    Link,
    Topology,
    fully_connected,
    migration_bytes,
    parse_link_target,
    spine_topology,
)

__all__ = [
    "apply_placement", "makespan", "placement_permutation",
    "plan_expert_placement", "round_robin_assignment",
    "CostCell", "CostModelRegistry", "registry_from_dryrun_artifacts",
    "scaled_cell",
    "MappingFabric", "eft_dispatch_numpy", "heft_rt_fast",
    "make_policy_fabric", "pow2_bucket", "service_time_matrix",
    "POLICIES", "Replica", "Request", "ServeResult", "default_fleet",
    "goodput", "make_requests", "mesh_fleet", "simulate_serving",
    "FAILURE_KINDS", "FailureEvent", "FleetController",
    "FleetControllerConfig", "ResizeEvent", "grown_replica_factory",
    "load_failure_timeline", "make_spike_requests", "merge_event",
    "split_event", "validate_failure_timeline",
    "Link", "Topology", "fully_connected", "migration_bytes",
    "parse_link_target", "spine_topology",
]
