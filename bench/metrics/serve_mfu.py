"""The model's operations of every prompt admitted and every token decoded
inside the window, over the window's seconds times the card's 989 TFLOP/s
(bf16, dense) (%).  Operations from the configuration's shapes
(``bounds.prefill_flops`` / ``decode_flops``): attention over the keys each
token really attends, not the cache's ``max_len``."""

from bench import bounds, stats


def read(run):
    cfg, params = run.spec.model, run.params
    s, e = run.window_start, run.window_end
    ops = sum(bounds.prefill_flops(cfg, params, S0)
              for _, _, _, t1, S0 in run.admits if stats.in_window(t1, s, e))
    ops += sum(bounds.decode_flops(cfg, params, n, keys)
               for _, _, t1, n, keys in run.ticks
               if n > 0 and stats.in_window(t1, s, e))
    return 100.0 * ops / ((e - s) * bounds.BF16_OPS_PER_S)
