"""The public single-call entry points of the kernels (counterpart of
``repro/kernels/ops.py``): the reference's eleven functions, with its
names and argument order, each fronting one kernel module.

Every function takes ``impl="auto"`` (see ``kernels.resolve_impl``) and
runs on the device of its tensors: a CUDA tensor launches the kernel or
raises, a CPU tensor takes the plain version. The reference's optimizer
wrappers take flat 1-D buffers and donate them; here they update those
buffers in place, through a one-row (1, n) view, and return the same
tensors. ``fused_adamw``'s ``count`` (an int or a tensor, the
post-increment step) becomes the kernel's bias correction on the
buffers' device (``ref.adamw_bias_correction``). The packed training
round and the serve path call the kernel modules directly, as the
reference's do.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_adamw as _ad
from repro_torch.kernels import fused_momentum as _mo
from repro_torch.kernels import fused_sgd as _sg
from repro_torch.kernels import mamba_scan as _ms
from repro_torch.kernels import quantize as _qz
from repro_torch.kernels import rmsnorm as _rn
from repro_torch.kernels import sq_norm as _sq


def flash_attention(q, k, v, block_q: int = 128, block_k: int = 128, *,
                    impl="auto"):
    return _fa.flash_attention(q, k, v, block_q=block_q, block_k=block_k,
                               impl=impl)


def paged_decode_attention(q, pool, rows_k, rows_v, lengths,
                           page_size: int, n_kv: int, *, impl="auto"):
    return _da.paged_decode_attention(q, pool, rows_k, rows_v, lengths,
                                      page_size=page_size, n_kv=n_kv,
                                      impl=impl)


def rmsnorm(x, w, eps: float = 1e-5, block_rows: int = 128, *, impl="auto"):
    return _rn.rmsnorm(x, w, eps=eps, block_rows=block_rows, impl=impl)


def _row(t):
    """The (1, n) view of a flat 1-D buffer, for the (G, N) kernels."""
    if t.dim() != 1:
        raise ValueError(f"expected a flat 1-D buffer, got {tuple(t.shape)}")
    return t.view(1, -1)


def fused_adamw(p, g, m, v, count, lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8, wd: float = 0.0, *,
                impl="auto"):
    """In place on the flat ``p``, ``m`` and ``v``; returns them."""
    count = torch.as_tensor(count, device=p.device)
    _ad.fused_adamw(_row(p), _row(g), _row(m), _row(v), count, lr=lr, b1=b1,
                    b2=b2, eps=eps, wd=wd, impl=impl)
    return p, m, v


def fused_sgd(p, g, lr: float, *, impl="auto"):
    """In place on the flat ``p``; returns it."""
    _sg.fused_sgd(_row(p), _row(g), lr=lr, impl=impl)
    return p


def fused_momentum(p, g, mu, lr: float, beta: float = 0.9, *, impl="auto"):
    """In place on the flat ``p`` and ``mu``; returns them."""
    _mo.fused_momentum(_row(p), _row(g), _row(mu), lr=lr, beta=beta,
                       impl=impl)
    return p, mu


def sq_norm(x, *, impl="auto"):
    return _sq.sq_norm(x, impl=impl)


def sq_norm_groups(x, *, impl="auto"):
    return _sq.sq_norm_groups(x, impl=impl)


def mamba_chunk(xh, bmat, cmat, dt, a, *, impl="auto"):
    return _ms.mamba_chunk(xh, bmat, cmat, dt, a, impl=impl)


def quantize_int8(x, u, *, impl="auto"):
    return _qz.quantize_int8(x, u, impl=impl)


def dequantize_int8(q, scales, *, impl="auto"):
    return _qz.dequantize_int8(q, scales, impl=impl)
