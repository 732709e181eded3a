"""Paged decode attention (counterpart of
``repro/kernels/decode_attention.py``).

One decode step's GQA attention for every batch slot against the K and V
pages of the serve pool (``serve/paging.py``): q (B, H, hd) against pool
rows ``rows_k[b, j]`` / ``rows_v[b, j]``, masked at each slot's length.
On a CUDA tensor it launches ``repro_paged_decode_attention``
(``csrc/decode_attention.cu``: each slot's pages cut into spans of
``span_pages`` pages, one block a span, the last block of a slot merging
the spans' partials in a fixed order) with its partials and tickets
scratch, allocated once per (device, stream, size); on a CPU tensor it
takes ``ref.paged_decode_attention_ref``. The kernel takes any head dim
up to ``MAX_HEAD_DIM`` and from 1 to ``MAX_GROUP`` query heads per KV
head (``takes``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import (build, ptr, resolve_impl, sm_count,
                                 stream_of)
from repro_torch.kernels.ref import paged_decode_attention_ref

launches = 0     # kernel launches since the count was last set to 0
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 128
MAX_GROUP = 16                       # query heads per KV head
HEADS_A_BLOCK = 8                    # query heads a block (kMaxGB)
MAX_SPAN_PAGES = 128                 # page-table entries a span (kMaxSpanPages)
MIN_SPAN_TOKENS = 32                 # tokens a span at least
BLOCKS_PER_SM = 4                    # blocks the span split aims to keep in flight
_scratch: dict = {}   # (device index, stream, B, H, hd, S) -> (partials, tickets)


def span_pages(B: int, n_kv: int, g: int, nblk: int, page_size: int,
               sms: int) -> int:
    """Pages a span: a slot's nblk pages cut into as many spans as keep
    about ``BLOCKS_PER_SM`` blocks an SM in flight over the grid of B *
    n_kv * ceil(g / 8) blocks a span (one wave: measured fastest on an
    H100 at paper-lenet's and qwen3-32b's decode, PERF.md), but no span
    under ``MIN_SPAN_TOKENS`` tokens and none over ``MAX_SPAN_PAGES``
    pages; from the shapes alone (the lengths stay on the device)."""
    blocks = B * n_kv * -(-g // HEADS_A_BLOCK)
    spans = max(1, BLOCKS_PER_SM * sms // blocks)
    least = max(1, MIN_SPAN_TOKENS // page_size)
    return min(MAX_SPAN_PAGES, max(least, -(-nblk // spans)))


def takes(hd: int, g: int) -> bool:
    """Whether the kernel takes head dim ``hd`` with ``g`` query heads per
    KV head."""
    return 1 <= hd <= MAX_HEAD_DIM and 1 <= g <= MAX_GROUP


def _check(q, pool, rows_k, rows_v, lengths, page_size, n_kv):
    if q.dim() != 3 or q.dtype not in DTYPES:
        raise ValueError(f"q must be (B, H, hd) float32 or bfloat16, got "
                         f"{q.dtype} {tuple(q.shape)}")
    B, H, hd = q.shape
    if H % n_kv:
        raise ValueError(f"{H} query heads are not a multiple of {n_kv} "
                         "KV heads")
    if pool.dim() != 2 or pool.dtype != torch.float32:
        raise ValueError("pool must be (n_pages, page_elems) float32")
    if pool.shape[1] < page_size * n_kv * hd:
        raise ValueError(f"pool rows of {pool.shape[1]} elements cannot "
                         f"hold a page of {page_size * n_kv * hd}")
    for name, t, shape in (("rows_k", rows_k, (B, rows_k.shape[-1])),
                           ("rows_v", rows_v, (B, rows_k.shape[-1])),
                           ("lengths", lengths, (B,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be int32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (pool, rows_k, rows_v, lengths):
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")


def paged_decode_attention(q, pool, rows_k, rows_v, lengths, *,
                           page_size: int, n_kv: int, impl="auto"):
    """q (B, H, hd) float32 or bfloat16; pool (n_pages, page_elems)
    float32; rows_k/rows_v (B, nblk) int32 pool-row tables; lengths (B,)
    int32 (>= 1). Returns (B, H, hd) in q.dtype."""
    global launches
    _check(q, pool, rows_k, rows_v, lengths, page_size, n_kv)
    B, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    if resolve_impl(impl, q.device) == "torch":
        return paged_decode_attention_ref(q, pool, rows_k, rows_v, lengths,
                                          page_size=page_size, n_kv=n_kv,
                                          scale=scale)
    if B > 65535 or not takes(hd, H // n_kv):
        raise ValueError(
            f"paged_decode_attention: the kernel takes at most 65535 slots, "
            f"head_dim up to {MAX_HEAD_DIM} and 1 to {MAX_GROUP} query heads "
            f"per KV head; got B {B}, head_dim {hd}, {H // n_kv} (ROADMAP.md "
            "Queue C: wider heads stay refused on the card)")
    # the kernel computes in float32: a bfloat16 query is widened (exact)
    # and the result rounded back, as the kernel's store would
    qf = q.to(torch.float32).contiguous()
    pool = pool.contiguous()
    rows_k, rows_v = rows_k.contiguous(), rows_v.contiguous()
    lengths = lengths.contiguous()
    out = torch.empty_like(qf)
    nblk = rows_k.shape[1]
    pps = span_pages(B, n_kv, H // n_kv, nblk, page_size,
                     sm_count(q.device.index))
    spans = max(1, -(-nblk // pps))
    stream = stream_of(q)
    partials = tickets = None
    if spans > 1:
        key = (q.device.index, stream, B, H, hd, spans)
        if key not in _scratch:
            _scratch[key] = (
                torch.empty((B * H * spans * (hd + 2),), dtype=torch.float32,
                            device=q.device),
                torch.zeros((B * H,), dtype=torch.int32, device=q.device))
        partials, tickets = _scratch[key]
    build.launch("decode_attention", "repro_paged_decode_attention",
                 qf.data_ptr(), pool.data_ptr(), rows_k.data_ptr(),
                 rows_v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                 ptr(partials), ptr(tickets), B, n_kv, H // n_kv, hd,
                 page_size, nblk, pool.shape[1], pps, stream, scale)
    launches += 1
    return out.to(q.dtype)
