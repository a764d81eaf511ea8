# The paper's scheduler integrated as a framework feature: the
# fabric-batched, device-resident mapping-event pipeline.  (Serving dispatch,
# expert placement, the fleet and the chaos tier are still to port.)
from repro_torch.sched_integration.fabric import (
    MappingFabric,
    eft_dispatch_numpy,
    heft_rt_fast,
    make_policy_fabric,
    pow2_bucket,
    service_time_matrix,
)

__all__ = [
    "MappingFabric", "eft_dispatch_numpy", "heft_rt_fast",
    "make_policy_fabric", "pow2_bucket", "service_time_matrix",
]
