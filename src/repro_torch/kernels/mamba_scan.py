"""Mamba2 SSD intra-chunk computation, forward only (counterpart of
``repro/kernels/mamba_scan.py``).

For every (batch, chunk, head): the inclusive cumsum of dt*a, the causal
decay weights, ``(C B^T * W) x``, the chunk's summarized state and its
decay. On a CUDA tensor it launches ``repro_mamba_chunk``
(``csrc/mamba_scan.cu``, one block per (batch*chunk, head)); on a CPU
tensor it takes ``ref.mamba_chunk_ref``. Neither package has a backward
for it, so an input that requires a gradient is refused. No model path
of either package calls it: the reference's ``mamba_forward`` computes
the intra-chunk product in jnp.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, resolve_impl, stream_of
from repro_torch.kernels.ref import mamba_chunk_ref

launches = 0     # kernel launches since the count was last set to 0
MAX_SMEM = 232_448       # bytes of shared memory a block may have (227 KB)


def smem_bytes(L: int, N: int, P: int) -> int:
    """The kernel's dynamic shared memory (``Geometry::smem_bytes``): B
    and C transposed to (N, L + 4), x of a head in C's place, the causal
    32 x 32 tiles of the weights and three (L,) vectors, each length
    padded (L to 32, N to 4, P to 8)."""
    lp, np_, pp = -(-L // 32) * 32, -(-N // 4) * 4, -(-P // 8) * 8
    ls, tr = lp + 4, lp // 32
    return 4 * (np_ * ls + max(np_ * ls, lp * pp) + tr * (tr + 1) // 2 * 1024
                + 3 * lp)


def mamba_chunk(xh, bmat, cmat, dt, a, *, impl="auto"):
    """xh (B,c,L,H,P) float32 or bfloat16, bmat and cmat (B,c,L,N), dt
    (B,c,L,H), a (H,) float32 -> (y (B,c,L,H,P) in xh's dtype, states
    (B,c,H,N,P), chunk decay (B,c,H), cum (B,c,L,H)), the last three
    float32."""
    global launches
    if xh.dim() != 5 or xh.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mamba_chunk: xh must be (B,c,L,H,P) float32 or "
                         f"bfloat16, got {xh.dtype} {tuple(xh.shape)}")
    B, c, L, H, P = xh.shape
    if L < 1:
        raise ValueError("mamba_chunk: a chunk holds at least one step")
    N = bmat.shape[-1] if bmat.dim() == 4 else -1
    for name, t, shape in (("bmat", bmat, (B, c, L, N)),
                           ("cmat", cmat, (B, c, L, N)),
                           ("dt", dt, (B, c, L, H)), ("a", a, (H,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"mamba_chunk: {name} must be float32 {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != xh.device:
            raise ValueError(f"mamba_chunk: tensors on {t.device} and "
                             f"{xh.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xh, bmat, cmat, dt, a)):
        raise NotImplementedError(
            "mamba_chunk is forward only in both packages: it has no "
            "backward")
    if resolve_impl(impl, xh.device) == "torch":
        return mamba_chunk_ref(xh, bmat, cmat, dt, a)
    if smem_bytes(L, N, P) > MAX_SMEM:
        raise ValueError(
            f"mamba_chunk: chunk {L}, state {N} and head_dim {P} need "
            f"{smem_bytes(L, N, P)} bytes of shared memory a block; the "
            f"kernel has {MAX_SMEM}")
    xh, bmat, cmat, dt, a = (t.contiguous() for t in (xh, bmat, cmat, dt, a))
    f32 = dict(dtype=torch.float32, device=xh.device)
    y = torch.empty_like(xh)
    states = torch.empty((B, c, H, N, P), **f32)
    decay = torch.empty((B, c, H), **f32)
    cum = torch.empty((B, c, L, H), **f32)
    build.launch("mamba_scan", "repro_mamba_chunk", xh.data_ptr(),
                 bmat.data_ptr(), cmat.data_ptr(), dt.data_ptr(), a.data_ptr(),
                 y.data_ptr(), states.data_ptr(), decay.data_ptr(),
                 cum.data_ptr(), B * c, L, H, N, P,
                 int(xh.dtype == torch.bfloat16), stream_of(xh))
    launches += 1
    return y, states, decay, cum
