"""A MoE model's decode tick: its least time over its span, the median over
the window's ticks (%).  The least time is ``bounds.tick_bound`` with the
routed experts the tick's active lanes read, the ``experts`` arg of its
``engine.decode_tick`` span (distinct experts summed over the MoE
layers): every other weight read once (the embedding only at the lanes'
rows), each lane's live cached tokens read once, its new token written
once.  None for a model without MoE or a trace without the arg."""

from bench import bounds, stats
from bench.metrics._common import window


def read(run):
    cfg, lanes = run.spec.model, run.spec.traffic["lanes"]
    spans = run.spans.get("engine.decode_tick", [])
    if cfg.get("moe") is None or len(spans) != len(run.ticks):
        return None
    s, e = window(run)
    shares = []
    for (_, _, t1, n, keys), (_, d, args) in zip(run.ticks, spans):
        if n == 0 or not stats.in_window(t1, s, e):
            continue
        experts = args.get("experts")
        if experts is None:
            return None
        wb = bounds.tick_weight_bytes(run.params, lanes, cfg["d_model"],
                                      experts)
        ms = bounds.tick_bound(cfg, wb, keys, lanes, params=run.params,
                               experts_read=experts)[0]
        shares.append(ms / (d * 1e3))
    p = stats.percentile(shares, 50)
    return None if p is None else 100.0 * p
