"""GQA self attention for training, prefill and decode (counterpart of
``repro/models/attention.py``): the unblocked path, the blocked causal
online-softmax path (``rect`` and ``tri`` schedules) in plain PyTorch, and
the ``attn_impl="pallas"`` branch, which runs the port's
``flash_attention`` kernel (``kernels/flash_attention.py``; forward only,
as in the reference). The serve decode step projects one token per slot
(``project_qkv`` with (B, 1) positions) and attends over the paged pool
through ``kernels/decode_attention.py``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.models.layers import apply_rope, pdef, rms_norm

NEG_INF = -1e30


def attention_defs(cfg):
    d, h, kv, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    defs = {
        "wq": pdef((d, h, hd), ("embed", "heads", None)),
        "wk": pdef((d, kv, hd), ("embed", "kv_heads", None)),
        "wv": pdef((d, kv, hd), ("embed", "kv_heads", None)),
        "wo": pdef((h, hd, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = pdef((h, hd), ("heads", None), init="zeros")
        defs["bk"] = pdef((kv, hd), ("kv_heads", None), init="zeros")
        defs["bv"] = pdef((kv, hd), ("kv_heads", None), init="zeros")
    if cfg.qk_norm:
        defs["q_norm"] = pdef((hd,), (None,), init="ones")
        defs["k_norm"] = pdef((hd,), (None,), init="ones")
    return defs


def project_qkv(p, x, cfg, positions):
    """Self-attention projections with rotary embedding at ``positions``
    ((1, S) for a sequence, (B, 1) for one decode token per slot).
    Returns q (B,S,H,hd), k/v (B,S,KV,hd)."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def output_proj(p, attn_out):
    return torch.einsum("bshk,hkd->bsd", attn_out, p["wo"].to(attn_out.dtype))


def _gqa_scores(q, k):
    """q (B,Sq,H,hd), k (B,Sk,KV,hd) -> scores (B,KV,G,Sq,Sk)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    # 1/sqrt(hd) formed in float32, as the reference does
    scale = float(1.0 / torch.sqrt(torch.tensor(float(hd))))
    return torch.einsum("bqkgh,bskh->bkgqs", qg, k) * scale


def _gqa_out(probs, v):
    """probs (B,KV,G,Sq,Sk), v (B,Sk,KV,hd) -> (B,Sq,H,hd)."""
    B, KV, G, Sq, _ = probs.shape
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v)
    return out.reshape(B, Sq, KV * G, v.shape[-1])


def full_attention(q, k, v, mask):
    """Unblocked path. mask broadcastable to (Sq, Sk) bool, True = attend."""
    s = _gqa_scores(q, k).to(torch.float32)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return _gqa_out(p, v)


def blocked_causal_attention(q, k, v, block: int, schedule: str = "tri"):
    """Causal self attention over (q-block, kv-block) pairs with an
    online softmax per query block. ``tri`` visits the lower triangle
    only; ``rect`` visits every pair and masks the ones above it."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    if S % block:
        raise ValueError(f"sequence {S} is not a multiple of block {block}")
    nb = S // block
    if schedule == "tri":
        pairs = [(i, j) for i in range(nb) for j in range(i + 1)]
    elif schedule == "rect":
        pairs = [(i, j) for i in range(nb) for j in range(nb)]
    else:
        raise ValueError(schedule)

    qb = q.reshape(B, nb, block, H, hd)
    kb = k.reshape(B, nb, block, KV, hd)
    vb = v.reshape(B, nb, block, KV, hd)
    tri_mask = torch.tril(torch.ones((block, block), dtype=torch.bool,
                                     device=q.device))
    f32 = dict(dtype=torch.float32, device=q.device)
    m = [torch.full((B, KV, G, block), NEG_INF, **f32)] * nb
    l = [torch.zeros((B, KV, G, block), **f32)] * nb
    acc = [torch.zeros((B, block, H, hd), **f32)] * nb

    for i, j in pairs:
        s = _gqa_scores(qb[:, i], kb[:, j]).to(torch.float32)
        if j == i:
            s = torch.where(tri_mask, s, NEG_INF)
        elif j > i:
            s = torch.full_like(s, NEG_INF)
        m_new = torch.maximum(m[i], torch.amax(s, dim=-1))
        corr = torch.exp(m[i] - m_new)
        pblk = torch.exp(s - m_new[..., None])
        l[i] = l[i] * corr + torch.sum(pblk, dim=-1)
        pv = _gqa_out(pblk.to(q.dtype), vb[:, j]).to(torch.float32)
        corr_q = corr.permute(0, 3, 1, 2).reshape(B, block, H)[..., None]
        acc[i] = acc[i] * corr_q + pv
        m[i] = m_new

    l_q = torch.stack(l).permute(0, 1, 4, 2, 3).reshape(nb, B, block, H)
    out = torch.stack(acc) / torch.clamp(l_q[..., None], min=1e-30)
    return out.transpose(0, 1).reshape(B, S, H, hd).to(q.dtype)


def pallas_causal_attention(q, k, v, block: int, impl="auto"):
    """The ``attn_impl="pallas"`` branch: q (B,S,H,hd), k/v (B,S,KV,hd)
    through the flash kernel at the reference's block ``min(block, 128)``.
    The kernel reads KV head h // g, so the reference's repeat of the KV
    heads is not needed."""
    bq = min(block, 128)
    out = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), block_q=bq, block_k=bq,
                             impl=impl)
    return out.transpose(1, 2)


def attention_forward(p, x, cfg, *, schedule="tri", block=512,
                      return_kv=False, impl="auto"):
    """x (B,S,D) -> (B,S,D) causal self attention, and with ``return_kv``
    also the (k, v) it attended over (the serve prefill pages them).
    The blocked path runs when the sequence holds at least two whole
    blocks, through the flash kernel under ``attn_impl="pallas"``
    (``impl`` picks the kernel or its plain version); otherwise the
    unblocked one (the reference's branch condition)."""
    S = x.shape[1]
    q, k, v = project_qkv(p, x, cfg, torch.arange(S, device=x.device)[None])
    blocked = S % block == 0 and S // block >= 2
    if blocked and cfg.attn_impl == "pallas" and S % min(block, 128) == 0:
        out = pallas_causal_attention(q, k, v, block, impl)
    elif blocked:
        out = blocked_causal_attention(q, k, v, block, schedule)
    else:
        out = full_attention(q, k, v, torch.tril(torch.ones(
            (S, S), dtype=torch.bool, device=x.device)))
    y = output_proj(p, out)
    return (y, (k, v)) if return_kv else y
