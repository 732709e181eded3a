"""Per-row squared L2 norm (counterpart of ``repro/kernels/sq_norm.py``).

``sq_norm_groups`` reduces a (G, N) float32 buffer to (G,): the traj
``grad_sq`` of every local step and both consensus metrics of every
round. On a CUDA tensor it launches ``repro_sq_norm_groups``
(``csrc/sq_norm.cu``: one launch, the last block of each row sums the
row's partials in a fixed order) with its partials and tickets scratch,
allocated once per (device, rows, stream); on a CPU tensor it takes
``ref.sq_norm_groups_ref``. ``sq_norm`` is its one-row case, as in the
reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (build, check_rows, resolve_impl, sm_count,
                                 stream_of)
from repro_torch.kernels.ref import sq_norm_groups_ref

launches = 0     # kernel launches since the count was last set to 0
RESIDENT_PER_SM = 8      # at most 2048 threads an SM, 256 a block
_scratch: dict = {}      # (device index, rows, stream) -> (partials, tickets)


def sq_norm_groups(x, *, impl="auto"):
    """Per-row sum of squares of (G, N) float32 -> (G,) float32."""
    global launches
    rows, n = check_rows("sq_norm_groups", x)
    if resolve_impl(impl, x.device) == "torch":
        return sq_norm_groups_ref(x)
    stream = stream_of(x)
    key = (x.device.index, rows, stream)
    scratch = _scratch.get(key)
    if scratch is None:
        cap = max(rows, RESIDENT_PER_SM * sm_count(x.device.index))
        scratch = _scratch[key] = (
            torch.empty((cap,), dtype=torch.float32, device=x.device),
            torch.zeros((rows,), dtype=torch.int32, device=x.device))
    partials, tickets = scratch
    out = torch.empty((rows,), dtype=torch.float32, device=x.device)
    build.launch("sq_norm", "repro_sq_norm_groups", x.data_ptr(),
                 partials.data_ptr(), tickets.data_ptr(), out.data_ptr(),
                 rows, n, partials.numel(), stream)
    launches += 1
    return out


def sq_norm(x, *, impl="auto"):
    """Sum of squares of a flat 1-D float32 buffer -> 0-d float32, through
    ``sq_norm_groups`` on the one-row view ``x[None]``."""
    if x.dim() != 1:
        raise ValueError(f"sq_norm: expected a 1-D buffer, got "
                         f"{tuple(x.shape)}")
    return sq_norm_groups(x[None], impl=impl)[0]

