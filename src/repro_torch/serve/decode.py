"""Fixed-shape decode and prefill programs over the paged pool
(counterpart of ``repro/serve/decode.py``).

The scheduler hands each call plain arrays: tokens (B,), per-slot
positions (B,), page tables (B, layers_kv, max_blocks), state rows (B,
state_rows) and an ``active`` mask (B,). Inactive slots run the same
step against the trash page (position 0, length 1, rows 0): finite
garbage that no active slot reads. Every op of the step is
batch-elementwise over the slots, and admissions and retirements never
change a shape, so a request's tokens do not depend on what the other
slots hold (for moe, under ``densemask`` in the prefill: dispatch's
capacity drops make a token's output depend on the batch).

Per family:
  dense/moe  per-layer paged KV; attention through the decode kernel;
             a batched prefill (one ``attention_forward`` pass a layer
             over the prompt right-padded to its bucket) writes whole
             pages.
  hybrid     mamba state rows plus the n_attn KV tables of zamba2's
             SHARED attention block; the prefill runs the same per-token
             core as the step, token by token (the recurrence is
             stepwise), so prefill and stepwise decode are bit-equal.
  ssm        state rows only (no KV pages); the model's ``decode_step``
             (its ring-cache API, whose cache is the state alone) is the
             token core, the prefill likewise token by token.
  vlm/audio  refused, as in the reference: their decode needs modality
             inputs outside the token-slot contract; drive them through
             ``Model.decode_step`` (a static batch on a ring cache).

The reference's prefill scans the whole padded bucket and masks the pad
steps (their state is kept, their K/V go to the trash row); the port's
loop stops at the prompt's length, which gives the same pool and token.

Recurrent state lives in the pool as packed flat buffers (one
``optim/packing`` Layout a config, slot-major). Freed rows are recycled
dirty, so a prefill starts from a zeros buffer, never from the pool.

The reference compiles each program once with jit; here ``step`` and
``prefill`` are per-layer Python loops over the same operations, and the
pool is updated in place. Decode attention goes through
``kernels/decode_attention.py`` and, with ``attn_impl="pallas"`` and a
prompt bucket of at least two 512-blocks, the dense/moe prefill through
``kernels/flash_attention.py``: the kernels on a CUDA device under
``impl="auto"`` or ``"cuda"``, their plain versions under ``"torch"``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import tree
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import IMPLS
from repro_torch.models import api as mapi
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mam
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import rms_norm
from repro_torch.optim.packing import Layout, layout_of, pack, unpack
from repro_torch.serve.paging import (PageGeom, make_geom, read_state,
                                      write_prefill_kv, write_state,
                                      write_token_kv)

SERVE_FAMILIES = ("dense", "moe", "hybrid", "ssm")


def _refuse(fam: str):
    raise NotImplementedError(
        f"serve does not support family {fam!r}: its decode path needs "
        "per-request modality inputs (vlm patches / audio encoder frames) "
        "outside the engine's token-slot contract — serve a "
        "dense/moe/hybrid/ssm config instead, or drive this family's "
        "generation directly through Model.decode_step (static batch, "
        "no scheduler)")


def _check_family(cfg):
    if cfg.family not in SERVE_FAMILIES:
        _refuse(cfg.family)


# ---------------------------------------------------------------------------
# State layouts (recurrent families)
# ---------------------------------------------------------------------------


def _meta(shapes, lead=()):
    """{leaf: (shape, dtype)} with the batch axis dropped and ``lead``
    axes prepended -> a tree of ``meta`` tensors."""
    return {k: torch.empty(lead + s[1:], dtype=dt, device="meta")
            for k, (s, dt) in shapes.items()}


def state_layout_for(model) -> Optional[Layout]:
    """packing.Layout of ONE slot's recurrent-state tree (no batch axis;
    packs with a leading B axis to (B, size)). None for the KV-only
    families."""
    cfg = model.cfg
    dtype = getattr(torch, cfg.dtype)
    fam = cfg.family
    if fam in ("dense", "moe"):
        return None
    if fam == "hybrid":
        return layout_of(_meta(mam.mamba_cache_shapes(cfg, 1, dtype),
                               (cfg.n_layers,)))
    if fam == "ssm":
        n_groups, n_m = mapi.xlstm_groups(cfg)
        return layout_of({
            "mlstm": _meta(xl.mlstm_cache_shapes(cfg, 1, dtype),
                           (n_groups, n_m)),
            "slstm": _meta(xl.slstm_cache_shapes(cfg, 1, dtype),
                           (n_groups,))})
    _refuse(fam)


def _to_slot_major(fam, state):
    """Cache axis order -> slot-major (B leading on every leaf), so each
    slot's state is one packed buffer."""
    if fam == "hybrid":                       # (L, B, ...) -> (B, L, ...)
        return tree.tree_map(lambda l: l.movedim(1, 0), state)
    return {"mlstm": tree.tree_map(lambda l: l.movedim(2, 0),
                                   state["mlstm"]),
            "slstm": tree.tree_map(lambda l: l.movedim(1, 0),
                                   state["slstm"])}


def _from_slot_major(fam, state):
    if fam == "hybrid":                       # (B, L, ...) -> (L, B, ...)
        return tree.tree_map(lambda l: l.movedim(0, 1), state)
    return {"mlstm": tree.tree_map(lambda l: l.movedim(0, 2),
                                   state["mlstm"]),
            "slstm": tree.tree_map(lambda l: l.movedim(0, 1),
                                   state["slstm"])}


def _zero_state(fam, layout, batch: int, device):
    """Fresh per-slot state in cache axis order, from a zeros buffer,
    never from the pool (freed rows are recycled dirty)."""
    return _from_slot_major(fam, unpack(torch.zeros(
        (batch, layout.size), dtype=torch.float32, device=device), layout))


# ---------------------------------------------------------------------------
# Geometry / attention
# ---------------------------------------------------------------------------


def geom_for(model, *, n_slots: int, page_size: int, max_len: int,
             slack_slots: int = 0, n_pages: Optional[int] = None) -> PageGeom:
    cfg = model.cfg
    _check_family(cfg)
    layout = state_layout_for(model)
    if cfg.family in ("dense", "moe"):
        n_layers_kv = cfg.n_layers
    elif cfg.family == "hybrid":
        n_layers_kv = max(cfg.n_layers // cfg.attn_every, 1)
    else:
        n_layers_kv = 0
    return make_geom(
        page_size=page_size,
        n_kv=cfg.n_kv_heads if n_layers_kv else 0,
        head_dim=cfg.resolved_head_dim if n_layers_kv else 0,
        n_layers_kv=n_layers_kv, max_len=max_len,
        state_size=layout.size if layout is not None else 0,
        n_slots=n_slots, slack_slots=slack_slots, n_pages=n_pages)


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
         (B, layers_kv, max_blocks), active (B,), srows (B, state_rows))
      -> (greedy tokens (B,) int32, pool)
    prefill(params, pool, tokens (1, P), length, rows_k, rows_v
            (layers_kv, max_blocks), srows (state_rows,))
      -> (first generated token (1,) int32, pool)

    ``step_logits`` / ``prefill_logits`` take the same arguments and
    return the (B, padded_vocab) float32 logits the tokens are the argmax
    of. Arguments a family does not use (``srows`` for dense and moe,
    which may omit it; the page tables for ssm, whose geometry has none)
    are ignored."""
    family: str
    geom: PageGeom
    state_layout: Optional[Layout]
    step: Callable
    prefill: Callable
    step_logits: Callable
    prefill_logits: Callable


def _dev(x, device, dtype=torch.int32):
    return torch.as_tensor(x, device=device).to(dtype)


def _token_places(pos, ps):
    """A decode token's (B, 1) positions, page block, in-page offset and
    the attended length, for every slot at position ``pos`` (B,)."""
    return pos[:, None], pos // ps, pos % ps, pos + 1


def _attend_token(p, x, cfg, pool, rk, rv, places, active, attn_fn):
    """One decode token's self attention over the paged pool for every
    slot: its K and V written at each slot's position (inactive slots to
    the trash row), then attention over the slot's pages. x is the
    normed input (B, 1, D); rk/rv (B, max_blocks); ``places`` from
    ``_token_places``. Returns (B, 1, D)."""
    B = x.shape[0]
    positions, blk, off, lengths = places
    q, k, v = attn.project_qkv(p, x, x, cfg, positions, positions)
    write_token_kv(pool, rk, blk, off, k[:, 0].reshape(B, -1), active)
    write_token_kv(pool, rv, blk, off, v[:, 0].reshape(B, -1), active)
    a = attn_fn(q[:, 0], pool, rk, rv, lengths)
    return attn.output_proj(p, a[:, None].to(x.dtype))


def _build_decoder_programs(model, geom, attn_fn, impl):
    cfg = model.cfg
    eps = cfg.norm_eps
    dtype = getattr(torch, cfg.dtype)
    ps = geom.page_size

    def step_logits(params, pool, tokens, pos, rows_k, rows_v, active,
                    srows=None):
        dev = pool.device
        tokens, pos = _dev(tokens, dev), _dev(pos, dev)
        active = _dev(active, dev, torch.bool)
        # one contiguous (B, max_blocks) table per layer, layer axis first
        rows_k = _dev(rows_k, dev).transpose(0, 1).contiguous()
        rows_v = _dev(rows_v, dev).transpose(0, 1).contiguous()
        x = mapi._embed_lookup(params["embed"], tokens[:, None], dtype)
        places = _token_places(pos, ps)
        layers = mapi._layer_params(params["blocks"], cfg.n_layers)
        for p, rk, rv in zip(layers, rows_k, rows_v):
            x = x + _attend_token(p["attn"], rms_norm(x, p["norm1"], eps),
                                  cfg, pool, rk, rv, places, active,
                                  attn_fn)
            x = x + mapi._decode_ffn(p, rms_norm(x, p["norm2"], eps),
                                     cfg)
        return mapi._logits(params, x, cfg), pool

    def prefill_logits(params, pool, tokens, length, rows_k, rows_v,
                       srows=None):
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
            x = x + mapi._ffn(p, rms_norm(x, p["norm2"], eps), cfg)[0]
            write_prefill_kv(pool, rk[:nblk_p], k.reshape(nblk_p, -1))
            write_prefill_kv(pool, rv[:nblk_p], v.reshape(nblk_p, -1))
        return mapi._logits(params, x[:, length - 1:length], cfg), pool

    return step_logits, prefill_logits


def _recurrent_programs(fam, layout, token):
    """step / prefill of a recurrent family around its per-token core
    ``token(params, pool, state, tokens (B,), pos (B,), rows_k, rows_v
    (B, layers_kv, max_blocks), active) -> (logits, new state)``; state in
    cache axis order."""

    def step_logits(params, pool, tokens, pos, rows_k, rows_v, active,
                    srows):
        dev = pool.device
        srows = _dev(srows, dev)
        active = _dev(active, dev, torch.bool)
        state = _from_slot_major(fam, unpack(
            read_state(pool, srows, layout.size), layout))
        logits, state = token(params, pool, state, _dev(tokens, dev),
                              _dev(pos, dev), _dev(rows_k, dev),
                              _dev(rows_v, dev), active)
        write_state(pool, srows, pack(_to_slot_major(fam, state), layout),
                    active)
        return logits, pool

    def prefill_logits(params, pool, tokens, length, rows_k, rows_v, srows):
        dev = pool.device
        tokens = _dev(tokens, dev)
        rk, rv = _dev(rows_k, dev)[None], _dev(rows_v, dev)[None]
        active = torch.ones((1,), dtype=torch.bool, device=dev)
        state = _zero_state(fam, layout, 1, dev)
        for t in range(int(length)):
            pos = torch.full((1,), t, dtype=torch.int32, device=dev)
            logits, state = token(params, pool, state, tokens[:, t], pos,
                                  rk, rv, active)
        write_state(pool, _dev(srows, dev)[None],
                    pack(_to_slot_major(fam, state), layout))
        return logits, pool

    return step_logits, prefill_logits


def _build_hybrid_programs(model, geom, attn_fn, layout):
    cfg = model.cfg
    eps = cfg.norm_eps
    dtype = getattr(torch, cfg.dtype)
    every = cfg.attn_every
    n_attn = max(cfg.n_layers // every, 1)

    def token(params, pool, state, tokens, pos, rows_k, rows_v, active):
        x = mapi._embed_lookup(params["embed"], tokens[:, None], dtype)
        sh = params["shared_attn"]
        places = _token_places(pos, geom.page_size)
        new = []
        for idx, p in enumerate(mapi._layer_params(params["blocks"],
                                                   cfg.n_layers)):
            x, mc = mapi._mamba_block_decode(
                p, x, cfg, {k: v[idx] for k, v in state.items()})
            new.append(mc)
            if idx % every == every - 1:
                slot = min(idx // every, n_attn - 1)
                x = x + _attend_token(
                    sh["attn"], rms_norm(x, sh["norm"], eps), cfg, pool,
                    rows_k[:, slot].contiguous(),
                    rows_v[:, slot].contiguous(), places, active, attn_fn)
        return mapi._logits(params, x, cfg), {
            k: torch.stack([m[k] for m in new]) for k in new[0]}

    return _recurrent_programs("hybrid", layout, token)


def _build_ssm_programs(model, layout):
    def token(params, pool, state, tokens, pos, rows_k, rows_v, active):
        logits, state = model.decode_step(params, state, tokens[:, None],
                                          pos)
        return logits[:, 0], state

    return _recurrent_programs("ssm", layout, token)


def build_programs(model, geom: PageGeom, impl: str = "auto") -> Programs:
    cfg = model.cfg
    _check_family(cfg)
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (have {IMPLS})")
    layout = state_layout_for(model)
    if cfg.family in ("dense", "moe"):
        step_logits, prefill_logits = _build_decoder_programs(
            model, geom, _make_attn(impl, geom), impl)
    elif cfg.family == "hybrid":
        step_logits, prefill_logits = _build_hybrid_programs(
            model, geom, _make_attn(impl, geom), layout)
    else:
        step_logits, prefill_logits = _build_ssm_programs(model, layout)

    # no autograd in serving (the reference's programs are jitted forward
    # passes): inference mode also saves the host part of every op
    step_logits = torch.inference_mode()(step_logits)
    prefill_logits = torch.inference_mode()(prefill_logits)

    def greedy(fn):
        def run(*args, **kw):
            logits, pool = fn(*args, **kw)
            return mapi._greedy(logits, cfg.vocab_size), pool
        return run

    return Programs(family=cfg.family, geom=geom, state_layout=layout,
                    step=greedy(step_logits), prefill=greedy(prefill_logits),
                    step_logits=step_logits, prefill_logits=prefill_logits)
