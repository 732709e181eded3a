"""Mamba2 (SSD) block (counterpart of ``repro/models/mamba.py``).

The chunked formulation of the reference, in plain PyTorch: within a
chunk of length L the state-space kernel is a masked (L, L) product, and
chunks are linked by a scan over per-chunk summarized states
(intra-chunk quadratic, inter-chunk linear). The reference computes the
intra-chunk part in jnp, not through its ``mamba_chunk`` kernel, and so
does the port (``kernels/mamba_scan.py`` stays behind ``kernels.ops``).

Shapes: d_inner = expand * d_model, split into H heads of head dim P=64
(P = d_inner for tiny configs). B/C projections are shared across heads,
state size N = cfg.ssm_state. Decode is the recurrence, one token at a
time, with an O(1) state (the conv window and the SSM state).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import pdef, rms_norm

P_HEADDIM = 64


def mamba_dims(cfg):
    di = cfg.d_inner
    p = min(P_HEADDIM, di)
    return di, di // p, p, cfg.ssm_state


def mamba_defs(cfg):
    d = cfg.d_model
    di, h, p, n = mamba_dims(cfg)
    return {
        "w_z": pdef((d, di), ("embed", "inner")),
        "w_x": pdef((d, di), ("embed", "inner")),
        "w_b": pdef((d, n), ("embed", None)),
        "w_c": pdef((d, n), ("embed", None)),
        "w_dt": pdef((d, h), ("embed", None)),
        "dt_bias": pdef((h,), (None,), init="zeros"),
        "a_log": pdef((h,), (None,), init="zeros"),
        "d_skip": pdef((h,), (None,), init="ones"),
        "conv_w": pdef((cfg.d_conv, di), (None, "inner"), scale=0.1),
        "conv_b": pdef((di,), ("inner",), init="zeros"),
        "norm": pdef((di,), ("inner",), init="ones"),
        "w_out": pdef((di, d), ("inner", "embed")),
    }


def _causal_conv(xc, conv_w, conv_b):
    """Depthwise causal conv, kernel K: a sum of shifted inputs."""
    K, S = conv_w.shape[0], xc.shape[1]
    out = xc * conv_w[K - 1]
    for k in range(1, K):
        shifted = F.pad(xc, (0, 0, k, 0))[:, :S]
        out = out + shifted * conv_w[K - 1 - k]
    return out + conv_b


def _ssm_inputs(p, x, cfg):
    dt_ = x.dtype
    f32 = torch.float32
    z = torch.einsum("bsd,di->bsi", x, p["w_z"].to(dt_))
    xc = torch.einsum("bsd,di->bsi", x, p["w_x"].to(dt_))
    bmat = torch.einsum("bsd,dn->bsn", x, p["w_b"].to(dt_)).to(f32)
    cmat = torch.einsum("bsd,dn->bsn", x, p["w_c"].to(dt_)).to(f32)
    dt = F.softplus(torch.einsum("bsd,dh->bsh", x, p["w_dt"].to(dt_)).to(f32)
                    + p["dt_bias"])
    a = -torch.exp(p["a_log"].to(f32))              # (H,) negative
    return z, xc, bmat, cmat, dt, a


def masked_decay(cum):
    """exp(cum_i - cum_j) for i >= j and 0 above the diagonal, cum
    (B,c,L,H) -> (B,c,i,j,H). The mask is applied before the exp: above
    the diagonal cum_i - cum_j > 0 grows with L and overflows float32 at
    the configs' chunk of 128, and the reference's where(mask, exp(.), 0)
    then has the gradient 0 * inf = NaN there. exp(-inf) = 0 gives the
    same values and a finite gradient."""
    L = cum.shape[2]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=cum.device))[None, None, :, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    return torch.exp(torch.where(mask, diff, -torch.inf))


def mamba_forward(p, x, cfg):
    """x (B,S,D) -> (B,S,D), S divisible by cfg.chunk_size."""
    B, S, D = x.shape
    di, H, P, N = mamba_dims(cfg)
    L = cfg.chunk_size
    if S % L:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {L}")
    c = S // L
    f32 = torch.float32

    z, xc, bmat, cmat, dt, a = _ssm_inputs(p, x, cfg)
    xc = F.silu(_causal_conv(xc, p["conv_w"].to(xc.dtype),
                             p["conv_b"].to(xc.dtype)))
    xh = xc.reshape(B, c, L, H, P).to(f32)
    bmat = bmat.reshape(B, c, L, N)
    cmat = cmat.reshape(B, c, L, N)
    dt = dt.reshape(B, c, L, H)
    cum = torch.cumsum(dt * a, dim=2)               # inclusive, in the chunk

    # intra-chunk (quadratic in L, masked): weight of input j on output i
    cb = torch.einsum("bcln,bcmn->bclm", cmat, bmat)             # (B,c,L,L)
    w_ij = masked_decay(cum) * dt[:, :, None, :, :]               # (B,c,i,j,H)
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", cb[..., None] * w_ij, xh)

    # per-chunk summarized states
    last = cum[:, :, -1:, :]                                     # (B,c,1,H)
    w_state = torch.exp(last - cum) * dt                         # (B,c,L,H)
    states = torch.einsum("bcln,bclhp->bchnp", bmat,
                          w_state[..., None] * xh)
    chunk_decay = torch.exp(last[:, :, 0])                       # (B,c,H)

    # inter-chunk scan
    s = torch.zeros((B, H, N, P), dtype=f32, device=x.device)
    y_inter = []
    for ci in range(c):
        y_inter.append(torch.einsum("bln,bhnp->blhp", cmat[:, ci], s)
                       * torch.exp(cum[:, ci])[..., None])
        s = chunk_decay[:, ci, :, None, None] * s + states[:, ci]
    y_inter = torch.stack(y_inter, 1)                            # (B,c,L,H,P)

    y = y_intra + y_inter + p["d_skip"][None, None, None, :, None] * xh
    y = y.reshape(B, S, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return torch.einsum("bsi,id->bsd", y, p["w_out"].to(x.dtype))


def mamba_cache_shapes(cfg, batch: int, dtype):
    """{leaf: (shape, dtype)} of the decode cache."""
    di, H, P, N = mamba_dims(cfg)
    return {"conv": ((batch, cfg.d_conv - 1, di), dtype),
            "ssm": ((batch, H, N, P), torch.float32)}


def init_mamba_cache(cfg, batch: int, dtype, device="cpu"):
    return {k: torch.zeros(s, dtype=dt, device=device)
            for k, (s, dt) in mamba_cache_shapes(cfg, batch, dtype).items()}


def mamba_decode(p, x, cfg, cache):
    """One token: x (B,1,D) -> (y (B,1,D), new cache)."""
    B = x.shape[0]
    di, H, P, N = mamba_dims(cfg)
    z, xc, bmat, cmat, dt, a = _ssm_inputs(p, x, cfg)
    window = torch.cat([cache["conv"], xc], dim=1)               # (B,K,di)
    xt = torch.einsum("bki,ki->bi", window, p["conv_w"].to(xc.dtype)) \
        + p["conv_b"].to(xc.dtype)
    xh = F.silu(xt).reshape(B, H, P).to(torch.float32)
    dt1 = dt[:, 0]                                               # (B,H)
    da = torch.exp(dt1 * a)
    s = cache["ssm"] * da[:, :, None, None] + \
        bmat[:, 0, None, :, None] * (dt1[:, :, None] * xh)[:, :, None, :]
    y = torch.einsum("bn,bhnp->bhp", cmat[:, 0], s)
    y = y + p["d_skip"][None, :, None] * xh
    y = y.reshape(B, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = torch.einsum("bsi,id->bsd", y, p["w_out"].to(x.dtype))
    return out, {"conv": window[:, 1:], "ssm": s}
