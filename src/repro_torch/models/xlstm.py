"""xLSTM blocks (counterpart of ``repro/models/xlstm.py``): mLSTM (matrix
memory, chunkwise gated linear attention) and sLSTM (scalar memory, a
scan over time).

The mLSTM recurrence  S_t = f_t S_{t-1} + i_t k_t v_t^T,
y_t = (q_t S_t) / max(|q_t n_t|, 1)  is computed chunkwise like the Mamba2
SSD: intra-chunk masked products and an inter-chunk state scan. Gates
are float32, the input gate clipped to [-8, 8] in place of the xLSTM
max-stabilizer state (the reference's simplification). sLSTM uses
diagonal recurrent weights (per channel).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import pdef, rms_norm
from repro_torch.models.mamba import masked_decay

ICLIP = 8.0


def xlstm_dims(cfg):
    di = cfg.expand * cfg.d_model
    return di, cfg.n_heads, di // cfg.n_heads


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_defs(cfg):
    d = cfg.d_model
    di, h, p = xlstm_dims(cfg)
    return {
        "w_up": pdef((d, 2 * di), ("embed", "inner")),
        "w_q": pdef((di, di), ("inner", None)),
        "w_k": pdef((di, di), ("inner", None)),
        "w_v": pdef((di, di), ("inner", None)),
        "w_if": pdef((d, 2 * h), ("embed", None), scale=0.01),
        "b_if": pdef((2 * h,), (None,), init="zeros"),
        "norm": pdef((di,), ("inner",), init="ones"),
        "w_down": pdef((di, d), ("inner", "embed")),
    }


def _mlstm_qkvg(p, x, cfg):
    di, H, P = xlstm_dims(cfg)
    dt_ = x.dtype
    u = torch.einsum("bsd,de->bse", x, p["w_up"].to(dt_))
    a, z = torch.chunk(u, 2, dim=-1)
    q = torch.einsum("bsi,ij->bsj", a, p["w_q"].to(dt_))
    # 1/sqrt(P) formed in float32 and cast, as the reference's
    sqrt_p = torch.tensor(math.sqrt(P), dtype=torch.float32).to(dt_)
    k = torch.einsum("bsi,ij->bsj", a, p["w_k"].to(dt_)) / sqrt_p.to(x.device)
    v = torch.einsum("bsi,ij->bsj", a, p["w_v"].to(dt_))
    gates = (torch.einsum("bsd,dg->bsg", x, p["w_if"].to(dt_))
             .to(torch.float32) + p["b_if"])
    i_raw, f_raw = torch.chunk(gates, 2, dim=-1)                  # (B,S,H)
    log_f = -F.softplus(-f_raw)                                   # log sigmoid
    ig = torch.exp(torch.clamp(i_raw, -ICLIP, ICLIP))
    B, S, _ = x.shape
    shp = (B, S, H, P)
    return q.reshape(shp), k.reshape(shp), v.reshape(shp), log_f, ig, z


def mlstm_forward(p, x, cfg):
    """x (B,S,D) -> (B,S,D); S divisible by cfg.chunk_size."""
    B, S, D = x.shape
    di, H, P = xlstm_dims(cfg)
    L = cfg.chunk_size
    if S % L:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {L}")
    c = S // L
    f32 = torch.float32
    q, k, v, log_f, ig, z = _mlstm_qkvg(p, x, cfg)

    qc = q.reshape(B, c, L, H, P).to(f32)
    kc = k.reshape(B, c, L, H, P).to(f32)
    vc = v.reshape(B, c, L, H, P).to(f32)
    igc = ig.reshape(B, c, L, H)
    cum = torch.cumsum(log_f.reshape(B, c, L, H), dim=2)

    # intra-chunk: weight of step j on step i (i >= j)
    w_ij = masked_decay(cum) * igc[:, :, None, :, :]              # (B,c,i,j,H)
    qk = torch.einsum("bclhp,bcmhp->bchlm", qc, kc)               # (B,c,H,L,L)
    wt = qk * w_ij.permute(0, 1, 4, 2, 3)                         # (B,c,H,i,j)
    y_intra = torch.einsum("bchlm,bcmhp->bclhp", wt, vc)

    # per-chunk summarized state and normalizer
    last = cum[:, :, -1:, :]
    w_st = torch.exp(last - cum) * igc                            # (B,c,L,H)
    kw = kc * w_st[..., None]
    states = torch.einsum("bclhp,bclhq->bchpq", kw, vc)
    nstates = kw.sum(2)                                           # (B,c,H,P)
    chunk_decay = torch.exp(last[:, :, 0])                        # (B,c,H)

    s = torch.zeros((B, H, P, P), dtype=f32, device=x.device)
    n = torch.zeros((B, H, P), dtype=f32, device=x.device)
    y_inter, n_inter = [], []
    for ci in range(c):
        expc = torch.exp(cum[:, ci])[..., None]                   # (B,L,H,1)
        y_inter.append(torch.einsum("blhp,bhpq->blhq", qc[:, ci], s) * expc)
        n_inter.append(torch.einsum("blhp,bhp->blh", qc[:, ci], n)[..., None]
                       * expc)
        s = chunk_decay[:, ci, :, None, None] * s + states[:, ci]
        n = chunk_decay[:, ci, :, None] * n + nstates[:, ci]

    n_intra = wt.sum(-1).permute(0, 1, 3, 2)[..., None]          # sum_j wt
    y = y_intra + torch.stack(y_inter, 1)
    nrm = n_intra + torch.stack(n_inter, 1)
    y = y / torch.clamp(torch.abs(nrm), min=1.0)
    y = y.reshape(B, S, di).to(x.dtype)
    y = rms_norm(y, p["norm"], cfg.norm_eps) * F.silu(z)
    return torch.einsum("bsi,id->bsd", y, p["w_down"].to(x.dtype))


def mlstm_cache_shapes(cfg, batch: int, dtype):
    """{leaf: (shape, dtype)} of the decode cache."""
    di, H, P = xlstm_dims(cfg)
    return {"s": ((batch, H, P, P), torch.float32),
            "n": ((batch, H, P), torch.float32)}


def init_mlstm_cache(cfg, batch: int, dtype, device="cpu"):
    return {k: torch.zeros(s, dtype=dt, device=device)
            for k, (s, dt) in mlstm_cache_shapes(cfg, batch, dtype).items()}


def mlstm_decode(p, x, cfg, cache):
    B = x.shape[0]
    di, H, P = xlstm_dims(cfg)
    q, k, v, log_f, ig, z = _mlstm_qkvg(p, x, cfg)
    f32 = torch.float32
    f = torch.exp(log_f[:, 0])                                    # (B,H)
    i_ = ig[:, 0]
    q1, k1, v1 = (t[:, 0].to(f32) for t in (q, k, v))
    s = f[:, :, None, None] * cache["s"] + \
        i_[:, :, None, None] * (k1[..., :, None] * v1[..., None, :])
    n = f[:, :, None] * cache["n"] + i_[:, :, None] * k1
    y = torch.einsum("bhp,bhpq->bhq", q1, s)
    den = torch.abs(torch.einsum("bhp,bhp->bh", q1, n))[..., None]
    y = (y / torch.clamp(den, min=1.0)).reshape(B, 1, di).to(x.dtype)
    y = rms_norm(y, p["norm"], cfg.norm_eps) * F.silu(z)
    out = torch.einsum("bsi,id->bsd", y, p["w_down"].to(x.dtype))
    return out, {"s": s, "n": n}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_defs(cfg):
    d = cfg.d_model
    di, _, _ = xlstm_dims(cfg)
    return {
        "w_gates": pdef((d, 4 * di), ("embed", "inner"), scale=0.01),
        "b_gates": pdef((4 * di,), ("inner",), init="zeros"),
        "r_gates": pdef((4, di), (None, "inner"), scale=0.01),
        "norm": pdef((di,), ("inner",), init="ones"),
        "w_down": pdef((di, d), ("inner", "embed")),
    }


def _slstm_step(p_r, carry, g):
    """g: the input's pre-activation gates (B, 4*di); p_r: (4, di)."""
    h, cst, n = carry
    gz, gi, gf, go = torch.chunk(g, 4, dim=-1)
    zt = torch.tanh(gz + h * p_r[0])
    it = torch.exp(torch.clamp(gi + h * p_r[1], -ICLIP, ICLIP))
    ft = torch.sigmoid(gf + h * p_r[2])
    ot = torch.sigmoid(go + h * p_r[3])
    c_new = ft * cst + it * zt
    n_new = ft * n + it
    h_new = ot * c_new / torch.clamp(n_new, min=1.0)
    return h_new, c_new, n_new


def _slstm_gates(p, x):
    return (torch.einsum("bsd,dg->bsg", x, p["w_gates"].to(x.dtype))
            .to(torch.float32) + p["b_gates"])


def slstm_forward(p, x, cfg):
    B, S, D = x.shape
    di, _, _ = xlstm_dims(cfg)
    g = _slstm_gates(p, x)
    r = p["r_gates"].to(torch.float32)
    h0 = torch.zeros((B, di), dtype=torch.float32, device=x.device)
    carry, hs = (h0, h0, h0), []
    for t in range(S):
        carry = _slstm_step(r, carry, g[:, t])
        hs.append(carry[0])
    hs = rms_norm(torch.stack(hs, 1).to(x.dtype), p["norm"], cfg.norm_eps)
    return torch.einsum("bsi,id->bsd", hs, p["w_down"].to(x.dtype))


def slstm_cache_shapes(cfg, batch: int, dtype):
    di, _, _ = xlstm_dims(cfg)
    sd = ((batch, di), torch.float32)
    return {"h": sd, "c": sd, "n": sd}


def init_slstm_cache(cfg, batch: int, dtype, device="cpu"):
    return {k: torch.zeros(s, dtype=dt, device=device)
            for k, (s, dt) in slstm_cache_shapes(cfg, batch, dtype).items()}


def slstm_decode(p, x, cfg, cache):
    g = _slstm_gates(p, x)[:, 0]
    r = p["r_gates"].to(torch.float32)
    h, c, n = _slstm_step(r, (cache["h"], cache["c"], cache["n"]), g)
    hs = rms_norm(h[:, None].to(x.dtype), p["norm"], cfg.norm_eps)
    out = torch.einsum("bsi,id->bsd", hs, p["w_down"].to(x.dtype))
    return out, {"h": h, "c": c, "n": n}
