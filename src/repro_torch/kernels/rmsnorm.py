"""RMSNorm over the last axis (counterpart of ``repro/kernels/rmsnorm.py``).

x (..., D) float32 or bfloat16 and w (D,): ``x * rsqrt(mean(x^2) + eps)
* w`` in float32 math, returned in x's dtype. On a CUDA tensor it
launches ``repro_rmsnorm`` (``csrc/rmsnorm.cu``: each row read once and
held in registers, in the layout ``layout`` picks by D; any row count);
on a CPU tensor it takes ``ref.rmsnorm_ref``. No model path of either
package calls it: the models normalise with plain tensor code
(``models/layers.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, resolve_impl, stream_of
from repro_torch.kernels.ref import rmsnorm_ref

launches = 0     # kernel launches since the count was last set to 0
DTYPES = (torch.float32, torch.bfloat16)
MAX_VECS = 8         # 16-byte vectors a thread holds (csrc/rmsnorm.cu kMaxVecs)
NARROW_VECS = 4      # what a narrow row aims at per lane
WIDE_THREADS = (128, 256, 512)


def layout(d: int, itemsize: int, vectors: bool = True) -> tuple:
    """The kernel's layout for rows of ``d`` elements of ``itemsize``
    bytes -> (tpr, nv, threads): tpr threads take one row, each holding nv
    16-byte vectors (lane l its vectors l, l + tpr, ...), in blocks of
    ``threads``. ``vectors`` is False where a pointer is not 16-byte
    aligned.

    - narrow rows (at most 32 * MAX_VECS vectors): the fewest lanes, a
      power of two up to 32, that hold the row in about NARROW_VECS
      vectors each, and 256 // tpr rows a block;
    - wide rows: one block a row, the fewest threads of WIDE_THREADS that
      hold it in at most MAX_VECS vectors each;
    - nv = 0: the streaming kernel, one warp per row in blocks of 256,
      where D is no multiple of the vector, a pointer is unaligned, or the
      row is too wide for the registers."""
    vec = 16 // itemsize
    if not vectors or d % vec:
        return 32, 0, 256
    nvec = d // vec
    if nvec <= 32 * MAX_VECS:
        tpr = 1
        while tpr < 32 and tpr * NARROW_VECS < nvec:
            tpr *= 2
        return tpr, -(-nvec // tpr), 256
    for threads in WIDE_THREADS:
        if nvec <= threads * MAX_VECS:
            return threads, -(-nvec // threads), threads
    return 32, 0, 256


def rmsnorm(x, w, *, eps: float = 1e-5, block_rows: int = 128, impl="auto"):
    """x (..., D) float32 or bfloat16, w (D,) -> x's shape and dtype.

    ``block_rows`` is the reference's VMEM tiling of the rows (it pads the
    rows to a multiple of it; the result does not depend on it): it must
    be at least 1, and the CUDA kernel groups its rows by ``layout``."""
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
    aligned = all(t.data_ptr() % 16 == 0 for t in (xr, wf, out))
    tpr, nv, threads = layout(d, xr.element_size(), aligned)
    build.launch("rmsnorm", "repro_rmsnorm", xr.data_ptr(), wf.data_ptr(),
                 out.data_ptr(), xr.shape[0], d,
                 int(x.dtype == torch.bfloat16), tpr, nv, threads,
                 stream_of(x), eps)
    launches += 1
    return out.reshape(x.shape)
