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


# -- the exchange epilogue (counterpart of repro/kernels/exchange_epilogue.py)
# Divisors are tensors on the operand's device: PyTorch's CUDA division by
# a Python scalar multiplies by its reciprocal, which can differ from the
# true quotient in the last bit; the kernels divide (__fdiv_rn).


def qdq_int8_ref(rows, u):
    """Per-row int8 quantize and dequantize of (rows, chunk) float32 with
    stochastic-rounding noise ``u`` in [0, 1): scale = amax/127 (1 for an
    all-zero row), q = clip(floor(x/scale + u), -127, 127), out q*scale."""
    amax = rows.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / amax.new_tensor(127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.floor(rows / scale + u), -127.0, 127.0)
    return q * scale


def _encode_decode(kind, d, u, chunk):
    """The codec's quantize+dequantize on a (G, N) delta (N a multiple of
    ``chunk`` for int8; ``u`` laid out as (G*N/chunk, chunk) rows)."""
    if kind in ("bf16", "fp16"):
        dt = torch.bfloat16 if kind == "bf16" else torch.float16
        return d.to(dt).to(torch.float32)
    return qdq_int8_ref(d.reshape(-1, chunk), u.reshape(-1, chunk)
                        ).reshape(d.shape)


def _mix(y, w):
    """One mixing application on (G, N) rows: the mean over G as a
    sequential sum over g then one division by G, broadcast back (w None),
    or the W-row contraction y_i = sum_k w[i, k] * y_k as a sequential sum
    over k, each product and sum rounded on its own."""
    g = y.shape[0]
    if w is None:
        acc = y[0].clone()
        for k in range(1, g):
            acc = acc + y[k]
        return (acc / y.new_tensor(float(g))).expand_as(y)
    out = torch.empty_like(y)
    for i in range(g):
        acc = w[i, 0] * y[0]
        for k in range(1, g):
            acc = acc + w[i, k] * y[k]
        out[i] = acc
    return out


def codec_mix_ref(x, x0, *, kind, u=None, w=None, hops=1, chunk=0,
                  residual=None, tau=None):
    """The fused exchange epilogue on (G, N) float32 rows, as the staged
    ops of the exchange. Returns (mixed, residual_out); residual_out is
    None except for ``thresh``.

    int8/bf16/fp16: each hop encodes y - ref (hop 0: x - x0), decodes,
    adds the decoded delta to ref and mixes ref: one hop and the exact
    mean when ``w`` is None, ``hops`` hops of the (G, G) float32 ``w``
    otherwise. ``u``: (hops, G*ceil(N/chunk), chunk) noise for int8;
    the columns are zero-padded to a chunk multiple and sliced back (zero
    chunks quantize to zero). thresh: c = (x - x0) + residual; entries
    with |c| >= tau (the (G, 1) per-row threshold) and |c| > 0 are sent,
    the rest stay in the residual; mean mixing only."""
    if kind == "thresh":
        c = (x - x0) + residual
        keep = (c.abs() >= tau) & (c.abs() > 0)
        d_hat = torch.where(keep, c, torch.zeros_like(c))
        return _mix(x0 + d_hat, None).contiguous(), c - d_hat
    n = x.shape[-1]
    if kind == "int8":
        x, x0 = torch.nn.functional.pad(x, (0, (-n) % chunk)), \
            torch.nn.functional.pad(x0, (0, (-n) % chunk))
    y, ref = x, x0
    for h in range(1 if w is None else hops):
        ref = ref + _encode_decode(kind, y - ref,
                                   None if u is None else u[h], chunk)
        y = _mix(ref, w)
    return y[:, :n].contiguous(), None
