# HEFT_RT in PyTorch: the plain reference scheduler (heft_rt), its float64
# numpy twin, and copies of the reference's numpy-only hardware cycle and
# resource models.
from repro_torch.core.heft_rt import (
    ScheduleResult,
    eft_assign,
    heft_rt,
    heft_rt_batched,
    heft_rt_numpy,
    priority_order,
)
from repro_torch.core.queue_model import (
    CycleReport,
    first_decision_worst_case,
    hw_latency_ns,
    oddeven_sort_cycles,
    per_decision_latency_ns,
    simulate_mapping_event,
    worst_case_cycles,
)
from repro_torch.core.resource_model import (
    PAPER_CRITICAL_PATH_NS,
    PAPER_DESIGN,
    PAPER_PER_DECISION_NS,
    SchedulerDesign,
    critical_path_ns,
    total_luts,
    total_registers,
    utilization,
)

__all__ = [
    "ScheduleResult", "eft_assign", "heft_rt", "heft_rt_batched",
    "heft_rt_numpy", "priority_order",
    "CycleReport", "first_decision_worst_case", "hw_latency_ns",
    "oddeven_sort_cycles", "per_decision_latency_ns", "simulate_mapping_event",
    "worst_case_cycles",
    "PAPER_CRITICAL_PATH_NS", "PAPER_DESIGN", "PAPER_PER_DECISION_NS",
    "SchedulerDesign", "critical_path_ns", "total_luts", "total_registers",
    "utilization",
]
