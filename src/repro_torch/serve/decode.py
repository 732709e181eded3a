"""Fixed-shape decode and prefill programs over the paged pool
(counterpart of ``repro/serve/decode.py``, dense family).

The scheduler hands each call plain arrays: tokens (B,), per-slot
positions (B,), page tables (B, layers_kv, max_blocks) and an ``active``
mask (B,). Inactive slots run the same step against the trash
page (position 0, length 1, rows 0): finite garbage that no active slot
reads. Every op of the step is batch-elementwise over the slots, and
admissions and retirements never change a shape, so a request's tokens do
not depend on what the other slots hold.

The reference compiles each program once with jit; here ``step`` and
``prefill`` are per-layer Python loops over the same operations, and the
pool is updated in place. Decode attention goes through
``kernels/decode_attention.py`` and, with ``attn_impl="pallas"`` and a
prompt bucket of at least two 512-blocks, the prefill through
``kernels/flash_attention.py``: the kernels on a CUDA device under
``impl="auto"`` or ``"cuda"``, their plain versions under ``"torch"``.

Families: dense only. moe, hybrid and ssm wait for their models
(ROADMAP.md Queue A item 9); vlm and audio are refused with the
reference's reason.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import IMPLS
from repro_torch.models import api as mapi
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlpm
from repro_torch.models.layers import rms_norm
from repro_torch.serve.paging import (PageGeom, make_geom, write_prefill_kv,
                                      write_token_kv)

SERVE_FAMILIES = ("dense",)


def _refuse(fam: str):
    if fam in ("moe", "hybrid", "ssm"):
        raise NotImplementedError(
            f"serve family {fam!r} is not ported yet: only 'dense' is "
            "(ROADMAP.md Queue A item 9, the remaining model families)")
    raise NotImplementedError(
        f"serve does not support family {fam!r}: its decode path needs "
        "per-request modality inputs (vlm patches / audio encoder frames) "
        "outside the engine's token-slot contract — serve a "
        "dense/moe/hybrid/ssm config instead, or drive this family's "
        "generation directly through Model.decode_step (static batch, "
        "no scheduler)")


def _check_family(cfg):
    if cfg.family not in SERVE_FAMILIES or cfg.is_moe:
        _refuse("moe" if cfg.is_moe else cfg.family)


def geom_for(model, *, n_slots: int, page_size: int, max_len: int,
             slack_slots: int = 0, n_pages: Optional[int] = None) -> PageGeom:
    cfg = model.cfg
    _check_family(cfg)
    return make_geom(page_size=page_size, n_kv=cfg.n_kv_heads,
                     head_dim=cfg.resolved_head_dim,
                     n_layers_kv=cfg.n_layers, max_len=max_len,
                     state_size=0, n_slots=n_slots,
                     slack_slots=slack_slots, n_pages=n_pages)


def _make_attn(impl: str, geom: PageGeom):
    """Decode-attention callable; ``impl`` is resolved per call against
    the tensors' device (``kernels.resolve_impl``)."""
    ps, n_kv = geom.page_size, geom.n_kv

    def f(q, pool, rk, rv, lengths):
        return da.paged_decode_attention(q, pool, rk, rv, lengths,
                                         page_size=ps, n_kv=n_kv, impl=impl)
    return f


@dataclasses.dataclass
class Programs:
    """The entry points the engine drives; the pool is updated in place
    and returned, as the reference's donated pool is:

    step(params, pool, tokens (B,), pos (B,), rows_k, rows_v
         (B, layers_kv, max_blocks), active (B,))
      -> (greedy tokens (B,) int32, pool)
    prefill(params, pool, tokens (1, P), length, rows_k, rows_v
            (layers_kv, max_blocks))
      -> (first generated token (1,) int32, pool)

    ``step_logits`` / ``prefill_logits`` take the same arguments and
    return the (B, padded_vocab) float32 logits the tokens are the argmax
    of. (The reference's recurrent-state rows come with the recurrent
    families.)"""
    family: str
    geom: PageGeom
    step: Callable
    prefill: Callable
    step_logits: Callable
    prefill_logits: Callable


def _dev(x, device, dtype=torch.int32):
    return torch.as_tensor(x, device=device).to(dtype)


def _build_decoder_programs(model, geom, attn_fn, impl):
    cfg = model.cfg
    eps = cfg.norm_eps
    dtype = getattr(torch, cfg.dtype)
    ps = geom.page_size

    def step_logits(params, pool, tokens, pos, rows_k, rows_v, active):
        dev = pool.device
        tokens, pos = _dev(tokens, dev), _dev(pos, dev)
        active = _dev(active, dev, torch.bool)
        # one contiguous (B, max_blocks) table per layer, layer axis first
        rows_k = _dev(rows_k, dev).transpose(0, 1).contiguous()
        rows_v = _dev(rows_v, dev).transpose(0, 1).contiguous()
        B = tokens.shape[0]
        x = mapi._embed_lookup(params["embed"], tokens[:, None], dtype)
        positions = pos[:, None]
        blk, off, lengths = pos // ps, pos % ps, pos + 1
        layers = mapi._layer_params(params["blocks"], cfg.n_layers)
        for p, rk, rv in zip(layers, rows_k, rows_v):
            h = rms_norm(x, p["norm1"], eps)
            q, k, v = attn.project_qkv(p["attn"], h, cfg, positions)
            write_token_kv(pool, rk, blk, off, k[:, 0].reshape(B, -1), active)
            write_token_kv(pool, rv, blk, off, v[:, 0].reshape(B, -1), active)
            a = attn_fn(q[:, 0], pool, rk, rv, lengths)
            x = x + attn.output_proj(p["attn"], a[:, None].to(x.dtype))
            h2 = rms_norm(x, p["norm2"], eps)
            x = x + mlpm.mlp_forward(p["mlp"], h2, cfg)
        return mapi._logits(params, x, cfg), pool

    def prefill_logits(params, pool, tokens, length, rows_k, rows_v):
        # the prompt right-padded to the bucket P (a page multiple): a real
        # token t attends to positions <= t < length only, and the pad's
        # pages are hidden by the decode kernel's length mask
        dev = pool.device
        tokens = _dev(tokens, dev)
        rows_k, rows_v = _dev(rows_k, dev), _dev(rows_v, dev)
        length = int(length)
        P = tokens.shape[1]
        nblk_p = P // ps
        x = mapi._embed_lookup(params["embed"], tokens, dtype)
        layers = mapi._layer_params(params["blocks"], cfg.n_layers)
        for p, rk, rv in zip(layers, rows_k, rows_v):
            h, (k, v) = attn.attention_forward(
                p["attn"], rms_norm(x, p["norm1"], eps), cfg,
                schedule="tri", return_kv=True, impl=impl)
            x = x + h
            h2 = rms_norm(x, p["norm2"], eps)
            x = x + mlpm.mlp_forward(p["mlp"], h2, cfg)
            write_prefill_kv(pool, rk[:nblk_p], k.reshape(nblk_p, -1))
            write_prefill_kv(pool, rv[:nblk_p], v.reshape(nblk_p, -1))
        return mapi._logits(params, x[:, length - 1:length], cfg), pool

    return step_logits, prefill_logits


def build_programs(model, geom: PageGeom, impl: str = "auto") -> Programs:
    cfg = model.cfg
    _check_family(cfg)
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (have {IMPLS})")
    step_logits, prefill_logits = _build_decoder_programs(
        model, geom, _make_attn(impl, geom), impl)

    def greedy(fn):
        def run(*args):
            logits, pool = fn(*args)
            return mapi._greedy(logits, cfg.vocab_size), pool
        return run

    return Programs(family=cfg.family, geom=geom, step=greedy(step_logits),
                    prefill=greedy(prefill_logits), step_logits=step_logits,
                    prefill_logits=prefill_logits)
