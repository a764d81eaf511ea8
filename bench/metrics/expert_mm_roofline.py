"""The routed-expert product's least time over its device time, in the
traced sub-window (%).  Device time: the grouped GEMM kernels of
``bench/expert_mm.py`` by name in the profiler's trace.  Least time:
``expert_mm.least_ms`` of each decode tick and each admission's prefill of
the sub-window, summed: a tick's routed rows are its active lanes' pairs
(``active`` · top_k a MoE layer) and its experts the ``experts`` arg of its
``engine.decode_tick`` span; an admission's, the ``experts`` and ``rows``
args of its ``engine.admit`` span.  None without a device trace, without
MoE, or where the trace's GEMM launches are not three a MoE layer of each
tick and prefill."""

from bench import expert_mm


def read(run):
    cfg = run.spec.model
    layers = expert_mm.moe_layers(cfg)
    if run.profile is None or not layers:
        return None
    t0, t1 = run.prof_window
    names = [n for n in run.profile["kernel_s"] if expert_mm.is_product(n)]
    device_s = sum(run.profile["kernel_s"][n] for n in names)
    launches = sum(run.profile["launches"][n] for n in names
                   if expert_mm.GEMM in n)

    def inside(spans):
        return [a for s, d, a in spans if t0 <= s and s + d <= t1]

    ticks = [a for a in inside(run.spans.get("engine.decode_tick", []))
             if a.get("active", 0) > 0]
    admits = [a for a in inside(run.spans.get("engine.admit", []))
              if "rows" in a]
    k = cfg["moe"]["top_k"]
    work = [(a.get("experts"), a["active"] * k * layers) for a in ticks]
    work += [(a["experts"], a["rows"]) for a in admits]
    events = len(ticks) + len(admits)
    if not events or any(e is None for e, _ in work) or \
            launches != expert_mm.GEMMS_A_LAYER * layers * events:
        return None
    least = sum(expert_mm.least_ms(cfg, run.params, e, r) for e, r in work)
    return 100.0 * least / (device_s * 1e3)
