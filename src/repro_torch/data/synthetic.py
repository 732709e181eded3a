"""Synthetic data (a copy of ``repro/data/synthetic.py``).

* ``TokenPipeline``: deterministic numpy token batches with a Zipf-ish
  marginal and a learnable bigram structure, and ``fixed_group_batches``,
  one fixed (G, b, S) batch of it (Fig 4).
* Fig 3's classification sets (``gaussian_classification``,
  ``maxpool2x2_twice``).

The same seed gives the same arrays as the reference, bit for bit, so
both packages train on the same data.
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


def fixed_group_batches(vocab_size: int, seq_len: int, n_groups: int,
                        per_group: int, seed: int = 0) -> dict:
    """A fixed (G, b, S) batch: each group's local dataset shard, for the
    paper's full-batch local GD mode."""
    pipe = TokenPipeline(vocab_size, seq_len, seed)
    return next(pipe.batches((n_groups, per_group)))


def gaussian_classification(n: int = 500, side: int = 28, n_classes: int = 10,
                            seed: int = 0):
    """Fig 3's MNIST-shaped set: class-conditional Gaussians on a side*side
    grid. Returns (x (n, side*side) float32, labels (n,) int32)."""
    rng = np.random.RandomState(seed)
    means = rng.randn(n_classes, side * side) * 2.0
    labels = rng.randint(0, n_classes, size=n)
    x = means[labels] + rng.randn(n, side * side)
    return x.astype(np.float32), labels.astype(np.int32)


def maxpool2x2_twice(x: np.ndarray, side: int = 28) -> np.ndarray:
    """Fig 3's 'Non-Intersected' variant: two 2x2 max-pools shrink the
    input to (side/4)^2 features so parameters (49*10=490) < samples (500)
    and the intersection assumption fails."""
    n = x.shape[0]
    img = x.reshape(n, side, side)
    for _ in range(2):
        s = img.shape[1] // 2
        img = img.reshape(n, s, 2, s, 2).max(axis=(2, 4))
    return img.reshape(n, -1)
