"""Synthetic-corpus data pipeline: deterministic, packed, shardable.

No external datasets ship with this container, so the pipeline synthesizes a
structured corpus (a zipf-distributed token stream with local n-gram
correlations — enough signal for loss to drop measurably during the e2e
training example) and packs it into fixed-length training windows with
next-token labels.  The iterator is stateless-resumable: batch i is a pure
function of (seed, i), so checkpoint-resume needs only the step counter.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    ngram: int = 3            # order of the synthetic correlations


class PackedDataset:
    """Deterministic packed LM batches: (tokens, labels) int32."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.RandomState(cfg.seed)
        v = cfg.vocab_size
        # fixed n-gram transition structure: each context class prefers a
        # small set of successor tokens (gives the model something to learn)
        self._succ = rng.randint(0, v, size=(997, 8)).astype(np.int32)

    def batch(self, index: int) -> tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        rng = np.random.RandomState((cfg.seed * 1_000_003 + index)
                                    % (2 ** 31 - 1))
        B, S, v = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        # zipf base stream (clipped into vocab)
        toks = rng.zipf(cfg.zipf_a, size=(B, S + 1)).astype(np.int64)
        toks = (toks - 1) % v
        # overlay n-gram correlations on 50% of positions
        ctx = np.zeros((B,), np.int64)
        for t in range(1, S + 1):
            ctx = (ctx * 31 + toks[:, t - 1]) % 997
            use = rng.rand(B) < 0.5
            pick = self._succ[ctx, rng.randint(0, 8, size=B)]
            toks[:, t] = np.where(use, pick, toks[:, t])
        toks = toks.astype(np.int32)
        return toks[:, :-1], toks[:, 1:]

    def __iter__(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        i = 0
        while True:
            yield self.batch(i)
            i += 1
