"""GQA attention for training, prefill and decode (counterpart of
``repro/models/attention.py``): the unblocked path (causal, or
non-causal for whisper's encoder, and cross attention over another
sequence), the blocked causal online-softmax path (``rect`` and ``tri``
schedules) in plain PyTorch, and the ``attn_impl="pallas"`` branch,
which runs the port's ``flash_attention`` kernel
(``kernels/flash_attention.py``; forward only, as in the reference).

Two decodes: the serve engine projects one token per slot
(``project_qkv`` with (B, 1) positions) and attends over the paged pool
through ``kernels/decode_attention.py``; ``Model.decode_step`` keeps the
reference's ring-buffer cache (``decode_attention``: slot ``pos % W``,
RoPE at absolute positions before caching, so a position past the
window overwrites the oldest slot) in plain PyTorch, as the reference
does, and whisper's cross attention reads fixed encoder K/V
(``cross_attention_cache`` / ``cross_attention_decode``).
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


def project_qkv(p, x, x_kv, cfg, positions, kv_positions, use_rope=True):
    """Projections of the queries from x and the keys and values from
    x_kv (x itself in self attention), with rotary embedding at
    ``positions`` / ``kv_positions`` ((1, S) for a sequence, (B, 1) for
    one decode token per slot) unless ``use_rope`` is off.
    Returns q (B,Sq,H,hd), k/v (B,Sk,KV,hd)."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x_kv, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x_kv, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
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


def full_attention(q, k, v, mask=None):
    """Unblocked path (short sequences, the encoder, cross attention).
    mask broadcastable to (Sq, Sk) bool, True = attend; None attends
    everywhere."""
    s = _gqa_scores(q, k).to(torch.float32)
    if mask is not None:
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


def attention_forward(p, x, cfg, *, causal=True, x_kv=None, use_rope=True,
                      positions=None, kv_positions=None, schedule="tri",
                      block=512, return_kv=False, impl="auto"):
    """x (B,S,D) -> (B,S,D); cross attention over x_kv (B,Sk,D) when it
    is given. With ``return_kv`` also the (k, v) it attended over (the
    prefills cache them). Causal self attention runs blocked when the
    sequence holds at least two whole blocks, through the flash kernel
    under ``attn_impl="pallas"`` (``impl`` picks the kernel or its plain
    version); everything else runs unblocked, causal or not (the
    reference's branch condition)."""
    S = x.shape[1]
    x_kv = x if x_kv is None else x_kv
    Sk = x_kv.shape[1]
    if positions is None:
        positions = torch.arange(S, device=x.device)[None]
    if kv_positions is None:
        kv_positions = torch.arange(Sk, device=x.device)[None]
    q, k, v = project_qkv(p, x, x_kv, cfg, positions, kv_positions, use_rope)
    blocked = causal and S == Sk and S % block == 0 and S // block >= 2
    if blocked and cfg.attn_impl == "pallas" and S % min(block, 128) == 0:
        out = pallas_causal_attention(q, k, v, block, impl)
    elif blocked:
        out = blocked_causal_attention(q, k, v, block, schedule)
    else:
        mask = None
        if causal:
            mask = torch.ones((S, Sk), dtype=torch.bool,
                              device=x.device).tril(Sk - S)
        out = full_attention(q, k, v, mask)
    y = output_proj(p, out)
    return (y, (k, v)) if return_kv else y


def kv_cache_shapes(cfg, batch: int, cache_len: int, dtype):
    """{leaf: (shape, dtype)} of one layer's ring cache."""
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {"k": ((batch, cache_len, kv, hd), dtype),
            "v": ((batch, cache_len, kv, hd), dtype),
            "slot_pos": ((cache_len,), torch.int32)}


def init_kv_cache(cfg, batch: int, cache_len: int, dtype, device="cpu"):
    """One layer's empty ring cache: zero K/V, every slot's absolute
    position -1 (empty)."""
    out = {k: torch.zeros(s, dtype=dt, device=device) for k, (s, dt) in
           kv_cache_shapes(cfg, batch, cache_len, dtype).items()}
    out["slot_pos"].fill_(-1)
    return out


def decode_attention(p, x, cfg, cache, pos):
    """One-token decode over a ring cache of W slots. x (B,1,D); pos the
    absolute position (an int). The token's K/V go to slot ``pos % W``
    with RoPE applied at ``pos`` first, so overwriting the oldest slot
    past the window is safe; slots whose position is -1 are masked.
    Returns (y (B,1,D), the new cache); the old one is left as it was."""
    B = x.shape[0]
    W = cache["k"].shape[1]
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = project_qkv(p, x, x, cfg, positions, positions)
    slot = pos % W
    k, v = cache["k"].clone(), cache["v"].clone()
    k[:, slot] = k_new[:, 0]
    v[:, slot] = v_new[:, 0]
    slot_pos = cache["slot_pos"].clone()
    slot_pos[slot] = pos
    s = _gqa_scores(q, k).to(torch.float32)              # (B,KV,G,1,W)
    s = torch.where(slot_pos >= 0, s, NEG_INF)
    probs = torch.softmax(s, dim=-1).to(x.dtype)
    y = output_proj(p, _gqa_out(probs, v))
    return y, {"k": k, "v": v, "slot_pos": slot_pos}


def cross_attention_cache(p, enc_out, cfg):
    """Cross-attention K/V of the encoder output (whisper), computed once
    for a whole decode: (B, n_frames, KV, hd) each."""
    dt = enc_out.dtype
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"].to(dt))
    if cfg.qkv_bias:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return k, v


def cross_attention_decode(p, x, cfg, k, v):
    """One token's cross attention over the fixed encoder K/V (no
    RoPE). x (B,1,D) -> (B,1,D)."""
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
    s = _gqa_scores(q, k).to(torch.float32)
    probs = torch.softmax(s, dim=-1).to(dt)
    return output_proj(p, _gqa_out(probs, v))
