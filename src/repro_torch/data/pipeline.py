"""Deterministic, resumable, sharding-aware synthetic token pipeline.

Every batch is a pure function of (seed, step) — restart at step k reproduces
the exact stream (the checkpoint/restart invariant), and any host can
materialize any shard independently (multi-host readiness).  Tokens follow a
Zipf-like marginal with a Markov twist so MoE routers see realistic skewed
expert loads (feeding the HEFT_RT expert-placement integration) and the loss
actually decreases during the example training runs.

The port's copy of ``repro.data.pipeline``: numpy only, and every batch
bitwise the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # stationary Zipf-ish distribution over the vocab
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** -cfg.zipf_a
        self._probs = p / p.sum()

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        """(tokens, labels) for ``step`` — pure function of (seed, step)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, 0xC0FFEE]))
        seq = rng.choice(cfg.vocab_size, size=(cfg.global_batch, cfg.seq_len + 1),
                         p=self._probs)
        # Markov twist: with prob .5 repeat-shift the previous token (+1 mod V)
        # so there is learnable next-token structure.
        rep = rng.random((cfg.global_batch, cfg.seq_len)) < 0.5
        nxt = (seq[:, :-1] + 1) % cfg.vocab_size
        seq[:, 1:] = np.where(rep, nxt, seq[:, 1:])
        tokens = seq[:, :-1].astype(np.int32)
        labels = seq[:, 1:].astype(np.int32)
        return {"tokens": tokens, "labels": labels}

    def shard_at(self, step: int, shard: int, num_shards: int) -> dict[str, np.ndarray]:
        """Per-host slice of the global batch (batch-major contiguous)."""
        b = self.batch_at(step)
        n = self.cfg.global_batch
        lo, hi = shard * n // num_shards, (shard + 1) * n // num_shards
        return {k: v[lo:hi] for k, v in b.items()}
