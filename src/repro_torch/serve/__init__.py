# Serving: the single-replica engine (dense oracle + block-paged continuous
# batching with the in-tick HEFT_RT decision) and the HEFT_RT front end.
from repro_torch.serve.engine import HeftFrontEnd, ReplicaHandle, ServeEngine
from repro_torch.serve.paging import PagePool, PagedRuntime

__all__ = ["HeftFrontEnd", "PagePool", "PagedRuntime", "ReplicaHandle",
           "ServeEngine"]
