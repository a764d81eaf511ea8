# repro_torch.obs — tracing + metrics copied from the reference (bounded-ring
# Tracer with Perfetto export, Counter/Gauge/log-bucketed Histogram registry,
# the REPRO_LOG leveled logger) and the device-resident scheduler counters
# in PyTorch.
from repro_torch.obs.device import (
    COUNTER_NAMES,
    NUM_COUNTERS,
    accumulate_counters,
    accumulate_counters_np,
    counters_dict,
    zero_counters,
)
from repro_torch.obs.log import LOG_LEVELS, get_logger, log_level
from repro_torch.obs.metrics import (
    HIST_BUCKETS,
    HIST_MIN_S,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Stopwatch,
    time_s,
)
from repro_torch.obs.trace import (
    NULL_TRACER,
    TraceEvent,
    Tracer,
    validate_chrome_trace,
)

__all__ = [
    "COUNTER_NAMES", "NUM_COUNTERS", "accumulate_counters",
    "accumulate_counters_np", "counters_dict", "zero_counters",
    "LOG_LEVELS", "get_logger", "log_level",
    "HIST_BUCKETS", "HIST_MIN_S", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "Stopwatch", "time_s",
    "NULL_TRACER", "TraceEvent", "Tracer", "validate_chrome_trace",
]
