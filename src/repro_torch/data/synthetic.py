"""Synthetic token pipeline (a copy of ``TokenPipeline`` in
``repro/data/synthetic.py``).

Deterministic numpy batches with a Zipf-ish marginal and a learnable
bigram structure. The same seed gives the same int32 tokens as the
reference, bit for bit, so both packages train on the same data.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class TokenPipeline:
    vocab_size: int
    seq_len: int
    seed: int = 0
    order: int = 1  # bigram structure

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        v = self.vocab_size
        # sparse-ish row-stochastic bigram table
        logits = rng.randn(v, 8)
        self._next = rng.randint(0, v, size=(v, 8))
        self._probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)

    def _sample_seq(self, rng) -> np.ndarray:
        out = np.empty(self.seq_len, np.int32)
        t = rng.randint(self.vocab_size)
        for i in range(self.seq_len):
            out[i] = t
            j = rng.choice(8, p=self._probs[t])
            t = int(self._next[t, j])
        return out

    def batches(self, batch_shape: Tuple[int, ...],
                seed: Optional[int] = None) -> Iterator[dict]:
        """Yields {"tokens": int32 array of batch_shape + (seq_len,)}."""
        rng = np.random.RandomState(self.seed if seed is None else seed)
        n = int(np.prod(batch_shape))
        while True:
            toks = np.stack([self._sample_seq(rng) for _ in range(n)])
            yield {"tokens": toks.reshape(*batch_shape, self.seq_len)}
