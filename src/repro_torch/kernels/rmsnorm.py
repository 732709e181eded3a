"""RMSNorm over the last axis (counterpart of ``repro/kernels/rmsnorm.py``).

x (..., D) float32 or bfloat16 and w (D,): ``x * rsqrt(mean(x^2) + eps)
* w`` in float32 math, returned in x's dtype. On a CUDA tensor it
launches ``repro_rmsnorm`` (``csrc/rmsnorm.cu``, one warp per row over a
grid-stride loop, so any row count); on a CPU tensor it takes
``ref.rmsnorm_ref``. No model path of either package calls it: the
models normalise with plain tensor code (``models/layers.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, grid_blocks, resolve_impl, stream_of
from repro_torch.kernels.ref import rmsnorm_ref

launches = 0     # kernel launches since the count was last set to 0
DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm(x, w, *, eps: float = 1e-5, block_rows: int = 128, impl="auto"):
    """x (..., D) float32 or bfloat16, w (D,) -> x's shape and dtype.

    ``block_rows`` is the reference's VMEM tiling of the rows (it pads the
    rows to a multiple of it; the result does not depend on it): it must
    be at least 1, and the CUDA kernel takes its rows a warp each on its
    own."""
    global launches
    if x.dtype not in DTYPES or x.dim() < 1:
        raise ValueError(f"rmsnorm: x must be (..., D) float32 or bfloat16, "
                         f"got {x.dtype} {tuple(x.shape)}")
    d = x.shape[-1]
    if w.shape != (d,) or w.device != x.device:
        raise ValueError(f"rmsnorm: w must be ({d},) on {x.device}, got "
                         f"{tuple(w.shape)} on {w.device}")
    if block_rows < 1:
        raise ValueError(f"rmsnorm: block_rows must be >= 1, got {block_rows}")
    if resolve_impl(impl, x.device) == "torch":
        return rmsnorm_ref(x, w, eps)
    xr = x.reshape(-1, d).contiguous()
    wf = w.to(torch.float32).contiguous()
    out = torch.empty_like(xr)
    rows = xr.shape[0]
    build.launch("rmsnorm", "repro_rmsnorm", xr.data_ptr(), wf.data_ptr(),
                 out.data_ptr(), rows, d, int(x.dtype == torch.bfloat16),
                 grid_blocks(x.device, -(-rows // 8)), stream_of(x), eps)
    launches += 1
    return out.reshape(x.shape)
