"""Carry the reference's arrays into the port.

The reference makes its params with ``jax.random``, whose numbers a
``torch.Generator`` cannot reproduce. To run both packages from one
start, hand the reference's params over as numpy arrays: a nested dict
(``jax.device_get(params)``) or the flat ``"a/b/c"``-keyed mapping of a
``repro/checkpoint/io.py`` npz. Nothing here imports the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree


def params_from_numpy(arrays, device="cpu") -> dict:
    """Nested dict of numpy arrays (or an npz-style flat mapping with
    ``/``-joined keys) -> nested dict of tensors on ``device``."""
    if any("/" in k for k in arrays):
        arrays = tree.unflatten([tuple(k.split("/")) for k in arrays],
                                list(arrays.values()))
    return tree.tree_map(
        lambda a: torch.tensor(np.asarray(a), device=device), arrays)


def buffer_from_numpy(buf, device="cpu") -> torch.Tensor:
    """A packed (G, N) or (N,) buffer -> contiguous float32 tensor."""
    return torch.tensor(np.asarray(buf, np.float32), device=device)
