"""A decode tick's least time over its span, the median over the window's
ticks (%).  The least time is ``bounds.tick_bound``: every weight read
once (the embedding only at the lanes' rows), each lane's live cached
tokens read once (not the whole ``max_len``), its new token written once,
each lane's state read and written once."""

from bench import bounds, stats
from bench.metrics._common import ticks_with_spans


def read(run):
    cfg, lanes = run.spec.model, run.spec.traffic["lanes"]
    wb = bounds.tick_weight_bytes(run.params, lanes, cfg["d_model"])
    shares = [bounds.tick_bound(cfg, wb, keys, lanes)[0] / (d * 1e3)
              for _, keys, d in ticks_with_spans(run)]
    p = stats.percentile(shares, 50)
    return None if p is None else 100.0 * p
