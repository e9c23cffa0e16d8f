"""Synthetic-corpus data pipeline: deterministic, shardable, resumable (the
port's own copy of ``repro.train.data``, numpy only; its batches equal the
original's bit for bit).

``batch_at(step) -> {tokens, labels}`` is a pure function of (seed, step,
host shard), so a restart at step *k* replays the exact stream, and a failed
host's shard can be re-keyed elsewhere. Documents are Zipf-sampled token runs
with copy spans and arithmetic-progression spans, so a ~100M-param model
shows a falling loss within a few hundred steps.
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
    n_hosts: int = 1
    host_id: int = 0


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.global_batch % cfg.n_hosts:
            raise ValueError("global_batch must divide n_hosts")
        self.local_batch = cfg.global_batch // cfg.n_hosts

    def _doc(self, rng: np.random.Generator, length: int) -> np.ndarray:
        v = self.cfg.vocab_size
        out = np.empty(length, np.int64)
        i = 0
        while i < length:
            kind = rng.integers(0, 3)
            span = int(rng.integers(8, 64))
            span = min(span, length - i)
            if kind == 0:  # zipf unigrams
                toks = rng.zipf(1.3, span) % v
            elif kind == 1 and i >= span:  # copy an earlier span
                start = int(rng.integers(0, i - span + 1))
                toks = out[start : start + span]
            else:  # arithmetic progression mod v
                a0 = int(rng.integers(0, v))
                d = int(rng.integers(1, 7))
                toks = (a0 + d * np.arange(span)) % v
            out[i : i + span] = toks
            i += span
        return out

    def batch_at(self, step: int) -> dict:
        """Pure function of (seed, step, host): replayable and re-shardable."""
        c = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step, c.host_id]))
        toks = np.stack([self._doc(rng, c.seq_len + 1) for _ in range(self.local_batch)])
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }
