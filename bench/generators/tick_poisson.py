"""Requests arriving per iteration of the front end's loop, from a seed.

The serving front end takes arrivals as the iteration (one tick of every
replica plus the admissions) at which each request becomes visible.  This
generator makes such a schedule from a traffic file's parameters:

* an opening fill of ``fill`` requests at iteration 0 (one a lane);
* then a Poisson process over iterations, at ``rate`` requests an
  iteration times a repeating profile of ``cycle`` = [[iterations,
  multiplier], ...] (a steady mix has [[1, 1.0]]; a burst alternates a
  multiplier above 1 with 0), starting at iteration 1, up to ``horizon``
  iterations;
* prompt and output lengths from the ``prompt`` / ``output`` laws:
  ``{"law": "log_uniform", "low", "high"}``, ``{"law": "uniform", "low",
  "high"}`` (integers, both ends in) or ``{"law": "fixed", "value"}``;
  prompts are then made acceptable to the model's prefill (a length above
  the configuration's ``prefill_multiple`` rounded up to a multiple of it);
* prompt token ids uniform over the vocabulary.

Every seed gets the same work: lengths and the Poisson process's
exponential gaps are stratified, each block of ``block`` draws taking the
law's quantiles at (k + 1/2) / block, k = 0 .. block-1, in an order the
seed shuffles (the opening fill is a block of its own).  So two seeds
differ in which request comes when, and in the tokens, and not in the mix
of sizes or the mean gap.
"""

from __future__ import annotations

import math

import numpy as np


def _quantile(law: dict, u: np.ndarray) -> np.ndarray:
    kind = law["law"]
    if kind == "log_uniform":
        lo, hi = law["low"], law["high"]
        return np.rint(lo * (hi / lo) ** u).astype(np.int64)
    if kind == "uniform":
        lo, hi = law["low"], law["high"]
        return lo + np.floor(u * (hi - lo + 1)).astype(np.int64)
    if kind == "fixed":
        return np.full(u.shape, law["value"], dtype=np.int64)
    raise ValueError(f"unknown length law {kind!r}")


def stratified(rng, n: int, block: int) -> np.ndarray:
    """n values in (0, 1): blocks of the midpoints (k + 1/2) / block, each
    block in its own shuffled order."""
    mids = (np.arange(block) + 0.5) / block
    blocks = [rng.permutation(mids) for _ in range(math.ceil(n / block))]
    return np.concatenate(blocks)[:n]


def prefill_length(n: int, multiple: int) -> int:
    """The prompt length a prefill accepts: at most ``multiple`` as is,
    above it the next multiple."""
    return n if n <= multiple else -(-n // multiple) * multiple


def arrival_ticks(rng, rate: float, cycle: list, horizon: int,
                  block: int) -> list[int]:
    """Iterations (1 .. horizon) of a Poisson process of ``rate`` a
    iteration shaped by ``cycle``, its unit gaps stratified."""
    mult = np.concatenate([np.full(int(k), float(m)) for k, m in cycle])
    lam = rate * np.resize(mult, horizon)            # iterations 1 .. horizon
    cum = np.cumsum(lam)
    n = int(cum[-1] * 1.2) + block
    gaps = -np.log1p(-stratified(rng, n, block))
    events = np.cumsum(gaps)
    events = events[events <= cum[-1]]
    return (np.searchsorted(cum, events) + 1).tolist()


def generate(traffic: dict, cell: dict, config: dict, seed: int,
             fill: int) -> dict:
    """``{"requests": [(prompt int32 array, new_tokens)], "arrival_ticks":
    [...]}`` for one run."""
    rng = np.random.default_rng(seed)
    block = traffic["block"]
    ticks = [0] * fill + arrival_ticks(rng, cell["rate"], traffic["cycle"],
                                       traffic["horizon"], block)
    n = len(ticks)

    def draw(law):
        # the fill is one block of its own: the same sizes for every seed
        u = np.concatenate([stratified(rng, fill, fill),
                            stratified(rng, n - fill, block)])
        return _quantile(law, u)

    prompts, outputs = draw(traffic["prompt"]), draw(traffic["output"])
    multiple = config["prefill_multiple"]
    vocab = config["model"]["vocab_size"]
    requests = []
    for p, o in zip(prompts, outputs):
        p = prefill_length(int(p), multiple)
        toks = rng.integers(0, vocab, p, dtype=np.int64).astype(np.int32)
        requests.append((toks, int(o)))
    return {"requests": requests, "arrival_ticks": ticks}


def warmup(traffic: dict, config: dict, seed: int) -> dict:
    """A few requests at the mix's shapes: the shortest, middle and longest
    prompt the law gives, two at iteration 0 and the rest at iteration 1
    (so the in-tick decision runs too), ``warmup_tokens`` new tokens each."""
    rng = np.random.default_rng(seed)
    u = np.array([0.0, 0.5, 1.0 - 1e-9])
    multiple = config["prefill_multiple"]
    vocab = config["model"]["vocab_size"]
    lens = [prefill_length(int(p), multiple)
            for p in _quantile(traffic["prompt"], u)]
    lens += lens[:1]
    requests = [(rng.integers(0, vocab, p, dtype=np.int64).astype(np.int32),
                 traffic["warmup_tokens"]) for p in lens]
    return {"requests": requests,
            "arrival_ticks": [0, 0] + [1] * (len(lens) - 2)}
