"""The HEFT_RT decision kernel's least time over its device time, in the
traced sub-window (%).  Device time: the ``event_kernel`` launches of
``csrc/fused_decision.cu`` by name in the profiler's trace (the in-tick
decisions and the host events both launch it).  Least time:
``bounds.event_bound`` of each decision's real queue (its requests, the
replicas), summed over the decisions made in the sub-window."""

from bench import bounds

KERNEL = "event_kernel"


def read(run):
    if run.profile is None:
        return None
    t0, t1 = run.prof_window
    names = [n for n in run.profile["kernel_s"] if KERNEL in n]
    device_s = sum(run.profile["kernel_s"][n] for n in names)
    launches = sum(run.profile["launches"][n] for n in names)
    made = [reqs for _, reqs, _, t in run.decisions if t0 <= t <= t1]
    if not launches or launches != len(made):
        return None
    P = len(run.spec.cell["speeds"])
    least_ms = sum(bounds.event_bound(1, len(r), P, True)[0] for r in made)
    return 100.0 * least_ms / (device_s * 1e3)
