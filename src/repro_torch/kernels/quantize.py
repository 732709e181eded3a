"""Per-row int8 quantize and dequantize (counterpart of
``repro/kernels/quantize.py``).

``quantize_int8`` turns (rows, chunk) float32 and its stochastic-rounding
noise u in [0, 1) into int8 q and one float32 scale per row, (rows, 1);
``dequantize_int8`` multiplies back. Any chunk width. On a CUDA tensor
each launches its kernel of ``csrc/quantize.cu`` (one warp per row over a
grid-stride loop) or raises; on a CPU tensor it takes
``ref.quantize_int8_ref`` / ``ref.dequantize_int8_ref``. The kernels
round like the plain versions, and the pair composes to ``qdq_int8`` bit
for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (build, check_buffer, grid_blocks,
                                 resolve_impl, stream_of)
from repro_torch.kernels.ref import dequantize_int8_ref, quantize_int8_ref

# kernel launches since a count was last set to 0
launches = {"quantize_int8": 0, "dequantize_int8": 0}


def quantize_int8(x, u, *, impl="auto"):
    """(rows, chunk) float32 + noise of the same shape -> (q int8
    (rows, chunk), scales float32 (rows, 1)), new tensors."""
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"quantize_int8: expected (rows, chunk >= 1), got "
                         f"{tuple(x.shape)}")
    check_buffer("quantize_int8", x, x.shape, x.device)
    check_buffer("quantize_int8 u", u, x.shape, x.device)
    if resolve_impl(impl, x.device) == "torch":
        return quantize_int8_ref(x, u)
    rows, chunk = x.shape
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scales = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    build.launch("quantize", "repro_quantize_int8", x.data_ptr(),
                 u.data_ptr(), q.data_ptr(), scales.data_ptr(), rows, chunk,
                 grid_blocks(x.device, -(-rows // 8)), stream_of(x))
    launches["quantize_int8"] += 1
    return q, scales


def dequantize_int8(q, scales, *, impl="auto"):
    """(rows, chunk) int8 + (rows, 1) float32 scales -> (rows, chunk)
    float32 (a new tensor)."""
    if q.dim() != 2:
        raise ValueError(f"dequantize_int8: expected (rows, chunk), got "
                         f"{tuple(q.shape)}")
    check_buffer("dequantize_int8", q, q.shape, q.device, torch.int8)
    check_buffer("dequantize_int8 scales", scales, (q.shape[0], 1), q.device)
    if resolve_impl(impl, q.device) == "torch":
        return dequantize_int8_ref(q, scales)
    rows, chunk = q.shape
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    build.launch("quantize", "repro_dequantize_int8", q.data_ptr(),
                 scales.data_ptr(), out.data_ptr(), rows, chunk,
                 grid_blocks(q.device, -(-rows // 8)), stream_of(q))
    launches["dequantize_int8"] += 1
    return out
