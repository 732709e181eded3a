"""Mamba2 SSD intra-chunk computation, forward only (counterpart of
``repro/kernels/mamba_scan.py``).

For every (batch, chunk, head): the inclusive cumsum of dt*a, the causal
decay weights, ``(C B^T * W) x``, the chunk's summarized state and its
decay. On a CUDA tensor it launches ``repro_mamba_chunk``
(``csrc/mamba_scan.cu``: one block per (batch*chunk, group of up to four
heads), C B^T once a block, the three products on the TF32 tensor cores
with the 3xTF32 split); on a CPU tensor it takes ``ref.mamba_chunk_ref``.
The kernel takes chunks of up to ``MAX_CHUNK`` steps (the reference's
configs use 128) and any N and P whose tiles fit one block's shared
memory. Neither package has a backward for it, so an input that requires
a gradient is refused. No model path of either package calls it: the
reference's ``mamba_forward`` computes the intra-chunk product in jnp.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, resolve_impl, stream_of
from repro_torch.kernels.ref import mamba_chunk_ref

launches = 0     # kernel launches since the count was last set to 0
MAX_SMEM = 232_448       # bytes of shared memory a block may have (227 KB)
MAX_CHUNK = 128          # steps a chunk: 8 row tiles of 16 (kMaxL)
HEADS_A_BLOCK = 4        # kHeads
CB_BYTES = 36_864        # C B^T's causal blocks: 4 pairs x 9 x 2 x 32 float4


def _up(x: int, to: int) -> int:
    return -(-x // to) * to


def smem_bytes(L: int, N: int, P: int, itemsize: int = 4) -> int:
    """The kernel's dynamic shared memory (``Geometry::bytes``): B, then
    C (x in its place once C B^T is done), each (L, row) with L padded to
    16 and rows padded to 4 floats past a multiple of 32 (8 elements for
    bfloat16 x), C B^T's causal blocks, cum, dt and the state weights of
    four heads, and the current head's factors of the weights W (row
    factors of the blocks below the diagonal, column factors, a flag a
    head)."""
    lp, sn = _up(L, 16), _up(N, 32) + 4
    sx = _up(P, 32) + (4 if itemsize == 4 else 8)
    b, x = 4 * lp * sn, itemsize * lp * sx
    tiles = lp // 16
    return (b + max(b, x) + CB_BYTES + 3 * 4 * HEADS_A_BLOCK * lp
            + 4 * (8 * tiles * (tiles - 1) + lp + HEADS_A_BLOCK))


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
    need = smem_bytes(L, N, P, xh.element_size())
    if L > MAX_CHUNK or need > MAX_SMEM:
        raise ValueError(
            f"mamba_chunk: the kernel takes chunks of up to {MAX_CHUNK} "
            f"steps within {MAX_SMEM} bytes of shared memory a block; chunk "
            f"{L}, state {N} and head_dim {P} need {need}")
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
