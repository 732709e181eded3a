"""Causal flash attention, forward only (counterpart of
``repro/kernels/flash_attention.py``).

q (B, H, S, hd) against k, v (B, KV, S, hd); KV may divide H (GQA), the
kernel reads KV head h // (H // KV) where the reference repeats the
heads first. On a CUDA tensor it launches ``repro_flash_attention``
(``csrc/flash_attention.cu``: TF32 tensor cores with a 3xTF32 split,
within the float32 tolerance); on a CPU tensor it takes
``ref.flash_attention_ref``. Neither package has a backward for it, so
an input that requires a gradient is refused.

The kernel is instantiated at the head dims ``KERNEL_HEAD_DIMS``; any
other hd up to ``MAX_HEAD_DIM`` is zero-padded to the next of them
(``pad_head_dim``), which is exact: zero columns of q and k add nothing
to q k^T, v's zero columns are cut from the output, and the scores keep
the scale 1/sqrt(hd) of the true hd. ``takes(hd)`` is the admitted set.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build, resolve_impl, stream_of
from repro_torch.kernels.ref import flash_attention_ref

launches = 0     # kernel launches since the count was last set to 0
KERNEL_HEAD_DIMS = (8, 16, 32, 64, 112, 128)    # the kernel's instantiations
MAX_HEAD_DIM = 128
TILE = 64        # query rows of a tile (the kernel's kRowsQ)


def takes(hd: int) -> bool:
    """Whether the kernel takes head dim ``hd`` (padded where needed)."""
    return 1 <= hd <= MAX_HEAD_DIM


def kernel_width(hd: int) -> int:
    """The instantiated head dim that ``hd`` runs at: the least one >= hd."""
    return next(w for w in KERNEL_HEAD_DIMS if w >= hd)


def pad_head_dim(t, width: int):
    """``t`` (..., hd) with zero columns appended up to ``width``."""
    return torch.nn.functional.pad(t, (0, width - t.shape[-1]))


def tile_schedule(S: int) -> list:
    """The query tiles each block along the kernel's grid x axis takes, in
    order (every (b, h) pair has its own row of such blocks): block x
    takes tiles nq - 1 - x and x, so every block does nq + 1 key tiles
    (the middle tile alone where nq is odd)."""
    nq = -(-S // TILE)
    return [[nq - 1 - x] + ([x] if x != nq - 1 - x else [])
            for x in range((nq + 1) // 2)]


def flash_attention(q, k, v, *, block_q: int = 128, block_k: int = 128,
                    impl="auto"):
    """q (B,H,S,hd), k/v (B,KV,S,hd) float32 or bfloat16 -> (B,H,S,hd) in
    q.dtype, causal. ``block_q``/``block_k`` are the reference's tiling:
    S must be a multiple of each (after clamping them to S), as the
    reference asserts; the CUDA kernel tiles by 64 on its own."""
    global launches
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"expected q (B,H,S,hd) and k, v (B,KV,S,hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, hd = q.shape
    KV = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, S, hd) or H % KV:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    block_q, block_k = min(block_q, S), min(block_k, S)
    if S % block_q or S % block_k:
        raise ValueError(f"sequence {S} is not a multiple of the blocks "
                         f"({block_q}, {block_k})")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward only in both packages: it has no "
            "backward (ROADMAP.md Queue B, flash_attention); train with "
            "attn_impl='blocked'")
    if resolve_impl(impl, q.device) == "torch":
        return flash_attention_ref(q, k, v, causal=True)
    if not takes(hd):
        raise ValueError(
            f"flash_attention: the kernel takes head_dim up to "
            f"{MAX_HEAD_DIM}, got {hd} (ROADMAP.md Queue C: wider heads "
            "stay refused on the card)")
    if B * H > 65535:
        raise ValueError("flash_attention: at most 65535 (batch, head) pairs")
    width = kernel_width(hd)
    if width != hd:
        q, k, v = (pad_head_dim(t, width) for t in (q, k, v))
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty_like(q)
    build.launch("flash_attention", "repro_flash_attention", q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV, S,
                 width, int(q.dtype == torch.bfloat16), stream_of(q),
                 1.0 / math.sqrt(hd))
    launches += 1
    return out if width == hd else out[..., :hd].contiguous()


def _aligned(t):
    """t contiguous and starting on a 16-byte grain (the kernel's cp.async
    copies are 16 bytes): a view that starts off the grain is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
