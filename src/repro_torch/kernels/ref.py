"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``).

They return new tensors and leave their inputs alone. The wrappers take
them for CPU tensors; the tests and ``chip_smoke.py`` hold the CUDA
kernels against them. Each repeats its kernel's order of operations.
Python scalars enter as float32, as in the reference (``1 - b1`` is
formed in double and then rounded, like JAX's weakly typed constants).
"""
from __future__ import annotations

import torch


def sgd_ref(p, g, *, lr):
    """One SGD step: p - lr*g."""
    return p - lr * g


def momentum_ref(p, g, mu, *, lr, beta=0.9):
    """One heavy-ball step. Returns (new_p, new_mu)."""
    mu_ = beta * mu + g
    return p - lr * mu_, mu_


def adamw_bias_correction(count, b1=0.9, b2=0.999):
    """(..., 2) float32 ``[1 - b1**c, 1 - b2**c]`` for a post-increment
    count tensor, computed on the count's device in float32 as the
    reference does (``optim/__init__.py`` packed_adamw)."""
    c = count.to(torch.float32)
    pw = torch.pow(torch.tensor([b1, b2], dtype=torch.float32,
                                device=c.device), c[..., None])
    return 1.0 - pw


def adamw_ref(p, g, m, v, bc, *, lr, b1=0.9, b2=0.999, eps=1e-8, wd=0.0):
    """One AdamW step on (G, N) rows; ``bc`` is the (G, 2) bias
    correction. Returns (new_p, new_m, new_v)."""
    bc1, bc2 = bc[:, 0:1], bc[:, 1:2]
    m_ = b1 * m + (1 - b1) * g
    v_ = b2 * v + (1 - b2) * g * g
    upd = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
    return p - lr * (upd + wd * p), m_, v_


def sq_norm_groups_ref(x):
    """Per-row sum of squares of (G, N) -> (G,) float32."""
    return torch.sum(torch.square(x.to(torch.float32)), dim=-1)
