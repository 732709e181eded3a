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


# -- attention (counterparts of repro/kernels/decode_attention.py and
# repro/kernels/ref.py flash_attention_ref)

NEG_INF = -1e30


def flash_attention_ref(q, k, v, causal=True, hd=None):
    """q (B,H,S,hd), k/v (B,KV,S,hd) with KV dividing H -> (B,H,S,hd):
    plain softmax attention. The KV heads are repeated to H, as the
    reference's caller does before its kernel; the probabilities are cast
    to q's type before the product with v, as the reference's oracle
    does. ``hd``: the head dim whose root scales the scores (default the
    inputs' own; the true one for zero-padded inputs)."""
    B, H, S, width = q.shape
    if k.shape[1] != H:
        k = k.repeat_interleave(H // k.shape[1], dim=1)
        v = v.repeat_interleave(H // v.shape[1], dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32)
    s = s / torch.sqrt(s.new_tensor(float(hd or width)))
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype), v)


def paged_decode_attention_ref(q, pool, rows_k, rows_v, lengths, *,
                               page_size: int, n_kv: int, scale: float):
    """One-token GQA attention over the paged pool: q (B, H, hd); pool
    (n_pages, page_elems) float32; rows_k/rows_v (B, nblk) int32 pool rows;
    lengths (B,) int32 >= 1. Returns (B, H, hd) in q.dtype.

    The reference's page loop (``_cell_update`` over the pages, per slot):
    per page the masked scores, the online-softmax update of m, l and acc,
    and pages wholly past a slot's length leave its state alone. The loop
    stops after the last page any slot needs."""
    B, H, hd = q.shape
    g = H // n_kv
    used = page_size * n_kv * hd
    qf = q.to(torch.float32).reshape(B, n_kv, g, hd)
    m = torch.full((B, n_kv, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, n_kv, g, hd), dtype=torch.float32, device=q.device)
    live = -(-int(lengths.max()) // page_size)
    for j in range(min(live, rows_k.shape[1])):
        k = pool[rows_k[:, j].long(), :used].reshape(B, page_size, n_kv, hd)
        v = pool[rows_v[:, j].long(), :used].reshape(B, page_size, n_kv, hd)
        cols = j * page_size + torch.arange(page_size, device=q.device)
        s = torch.einsum("bkgd,bpkd->bkgp", qf, k) * scale
        s = torch.where(cols < lengths[:, None, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_new = l * corr + p.sum(dim=-1)
        acc_new = acc * corr[..., None] + torch.einsum("bkgp,bpkd->bkgd", p, v)
        valid = (j * page_size < lengths)[:, None, None]
        m = torch.where(valid, m_new, m)
        l = torch.where(valid, l_new, l)
        acc = torch.where(valid[..., None], acc_new, acc)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


# -- the last four (counterparts of repro/kernels/rmsnorm.py, quantize.py
# and mamba_scan.py)


def rmsnorm_ref(x, w, eps=1e-5):
    """x (..., D), w (D,): x * rsqrt(mean(x^2) + eps) * w in float32 math,
    returned in x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * w.to(torch.float32)
    return y.to(x.dtype)


def quantize_int8_ref(x, u):
    """(rows, chunk) float32 and noise u in [0, 1) -> (q int8 (rows, chunk),
    scales float32 (rows, 1)): scale = amax/127 per row (1 for an all-zero
    row), q = clip(floor(x/scale + u), -127, 127). The division is by a
    device tensor, as in ``qdq_int8_ref``, so the pair composes to it bit
    for bit."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / amax.new_tensor(127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.floor(x / scale + u), -127.0, 127.0)
    return q.to(torch.int8), scale


def dequantize_int8_ref(q, scales):
    """(rows, chunk) int8 and (rows, 1) float32 scales -> q * scale."""
    return q.to(torch.float32) * scales


def mamba_chunk_ref(xh, bmat, cmat, dt, a):
    """Mamba2 SSD intra-chunk for every chunk, in the kernel's batched
    layout: xh (B,c,L,H,P) float32 or bfloat16, bmat and cmat (B,c,L,N),
    dt (B,c,L,H), a (H,) -> (y (B,c,L,H,P) in xh's dtype, states
    (B,c,H,N,P), chunk decay (B,c,H), cum (B,c,L,H)), all float32 but y.

    cum is the inclusive cumsum of dt*a taken in sequence over L; the
    weight of key j for query i is exp(cum_i - cum_j)*dt_j where i >= j
    and 0 elsewhere (selected, never multiplied by a mask: above the
    diagonal the exp may overflow); y = (C B^T * W) x; the state is
    (B * exp(cum_last - cum) dt)^T x; the decay exp(cum_last)."""
    L = xh.shape[2]
    f32 = torch.float32
    xf = xh.to(f32)
    dt = dt.to(f32)
    da = dt * a.to(f32)
    cum = torch.empty_like(da)
    run = da[:, :, 0]
    cum[:, :, 0] = run
    for l in range(1, L):
        run = run + da[:, :, l]
        cum[:, :, l] = run
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=xh.device))[:, :, None]
    w = torch.where(causal, torch.exp(cum[:, :, :, None, :]
                                      - cum[:, :, None, :, :])
                    * dt[:, :, None, :, :], 0.0)          # (B,c,i,j,H)
    cb = torch.einsum("bcin,bcjn->bcij", cmat.to(f32), bmat.to(f32))
    y = torch.einsum("bcijh,bcjhp->bcihp", cb[..., None] * w, xf)
    last = cum[:, :, -1]                                  # (B,c,H)
    w_state = torch.exp(last[:, :, None] - cum) * dt      # (B,c,L,H)
    bw = bmat.to(f32)[..., None] * w_state[:, :, :, None, :]
    states = torch.einsum("bclnh,bclhp->bchnp", bw, xf)
    return y.to(xh.dtype), states, torch.exp(last), cum
