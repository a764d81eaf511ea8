# CEDR-equivalent runtime environment: application DAGs, the discrete-event
# SoC simulator (daemon + worker threads + mapping events), workload
# generation, and the calibrated scheduling-overhead models.
from repro_torch.runtime.apps import (
    AppDAG,
    get_app,
    high_latency_workload,
    low_latency_workload,
    make_soc,
    paper_soc_pe_types,
)
from repro_torch.runtime.overhead import (
    HW_MODEL,
    SW_MODEL,
    ZERO_MODEL,
    OverheadModel,
    hw_compute_s,
    hw_overhead_s,
    hw_transfer_s,
    sw_overhead_s,
)
from repro_torch.runtime.simulator import (
    DISPATCHERS,
    CedrSimulator,
    SimResult,
    dispatch_earliest_idle,
    dispatch_heft_rt,
    make_dispatch_fabric,
)
from repro_torch.runtime.workload import (
    frames_per_second,
    high_latency_arrivals,
    injection_mbps,
    low_latency_arrivals,
    make_arrivals,
    paper_injection_sweep_mbps,
)

__all__ = [
    "AppDAG", "get_app", "high_latency_workload", "low_latency_workload",
    "make_soc", "paper_soc_pe_types",
    "HW_MODEL", "SW_MODEL", "ZERO_MODEL", "OverheadModel",
    "hw_compute_s", "hw_overhead_s", "hw_transfer_s", "sw_overhead_s",
    "DISPATCHERS", "CedrSimulator", "SimResult", "dispatch_earliest_idle",
    "dispatch_heft_rt", "make_dispatch_fabric",
    "frames_per_second", "high_latency_arrivals", "injection_mbps",
    "low_latency_arrivals", "make_arrivals", "paper_injection_sweep_mbps",
]
