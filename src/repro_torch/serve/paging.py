"""Paged caches for the serve engine (counterpart of
``repro/serve/paging.py``).

ONE float32 pool ``(n_pages, page_elems)`` on the device holds every
request's cache:

  - KV pages: page row j of a request stores ``page_size`` tokens x
    ``n_kv`` heads x ``head_dim`` floats of one layer's K (or V),
    token-major, which is what the decode kernel
    (``kernels/decode_attention.py``) reads.
  - Recurrent-state rows: a slot's packed Mamba or xLSTM state (one flat
    buffer through ``optim/packing``) split into ``page_elems``-wide
    rows (``packing.pad_rows``) on its own pool rows.

``page_elems`` is rounded up to a multiple of 256, the reference's chunk
quantum.

Row 0 is the trash page: inactive batch slots write and read there, so
the decode step never branches on activity. Real allocations start at
row 1 and never include it.

Allocation is whole-request and host-side (``FreeList``): a request's
full page budget is claimed at admission and freed at retirement;
admission defers (backpressure) when the pool is short.

The reference's writes are functional (``.at[].set``) and rely on jit
donating the pool; here the writes update the pool in place with
``index_put_``, so a token costs no copy of the pool. Several inactive
slots may write the trash row in one call, in no fixed order; no active
slot ever reads it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.optim.packing import pad_rows

ALIGN = 256        # the reference's chunk quantum
TRASH_ROW = 0      # reserved pool row for masked/inactive traffic


def _round_up(n: int, q: int) -> int:
    return q * ((n + q - 1) // q)


@dataclasses.dataclass(frozen=True)
class PageGeom:
    """Static pool geometry for one (model config, engine config) pair."""
    page_size: int          # tokens per KV page
    n_kv: int               # KV heads (0 for ssm: no KV pages)
    head_dim: int
    n_layers_kv: int        # layers that own KV tables (0 for ssm)
    max_blocks: int         # KV page-table length per layer per slot
    state_size: int         # packed recurrent-state f32 elements per slot
    page_elems: int         # pool row width (chunk-aligned)
    state_rows: int         # pool rows per slot of recurrent state
    n_pages: int            # total pool rows incl. the trash row

    @property
    def kv_rows_per_slot(self) -> int:
        return 2 * self.n_layers_kv * self.max_blocks

    @property
    def rows_per_slot(self) -> int:
        return self.kv_rows_per_slot + self.state_rows

    def pool(self, device="cpu") -> torch.Tensor:
        return torch.zeros((self.n_pages, self.page_elems),
                           dtype=torch.float32, device=device)


def make_geom(*, page_size: int, n_kv: int, head_dim: int,
              n_layers_kv: int, max_len: int, state_size: int,
              n_slots: int, slack_slots: int = 0,
              n_pages: Optional[int] = None) -> PageGeom:
    """Rows wide enough for a KV page (and a state-row split), and enough
    rows for ``n_slots + slack_slots`` requests (or ``n_pages``)."""
    kv_elems = page_size * n_kv * head_dim
    page_elems = _round_up(max(kv_elems, 1), ALIGN)
    max_blocks = -(-max_len // page_size) if n_layers_kv else 0
    state_rows = -(-state_size // page_elems) if state_size else 0
    geom = PageGeom(page_size=page_size, n_kv=n_kv, head_dim=head_dim,
                    n_layers_kv=n_layers_kv, max_blocks=max_blocks,
                    state_size=state_size, page_elems=page_elems,
                    state_rows=state_rows, n_pages=0)
    need = 1 + (n_slots + slack_slots) * geom.rows_per_slot
    return dataclasses.replace(geom, n_pages=n_pages if n_pages else need)


class FreeList:
    """Host-side pool-row allocator. Row 0 (trash) is never handed out."""

    def __init__(self, n_pages: int):
        self._free = list(range(n_pages - 1, 0, -1))

    def available(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[np.ndarray]:
        """n rows as int32, or None if the pool is short (the engine then
        defers admission rather than allocating part of a request)."""
        if n > len(self._free):
            return None
        return np.asarray([self._free.pop() for _ in range(n)], np.int32)

    def free(self, rows: np.ndarray) -> None:
        for r in rows.reshape(-1).tolist():
            if r == TRASH_ROW:
                raise ValueError("the trash row can never be freed")
            self._free.append(r)


def write_token_kv(pool, rows, blk, off, vec, valid=None) -> None:
    """Scatter one decode step's per-slot K (or V) vectors into the pool,
    in place. rows (B, nblk) page table of ONE layer's K or V; blk/off (B,)
    block index and in-page offset; vec (B, n_kv*hd); valid (B,) bool or
    None. Invalid slots write to the trash row at offset 0."""
    row = torch.gather(rows, 1, blk[:, None].long())[:, 0]
    if valid is not None:
        row = torch.where(valid, row, TRASH_ROW)
        off = torch.where(valid, off, 0)
    width = vec.shape[-1]
    cols = off[:, None].long() * width + torch.arange(
        width, device=vec.device)[None]
    pool.index_put_((row[:, None].long(), cols), vec.to(pool.dtype))


def write_prefill_kv(pool, rows, mat) -> None:
    """Scatter a whole prefill's pages of one layer's K (or V), in place.
    rows (nblk,) page table of the prefilling slot; mat (nblk, page_size *
    n_kv * hd), token-major per page. Pages past the prompt length land
    on the slot's own rows; the decode kernel's length mask hides them."""
    pool[rows.long(), :mat.shape[-1]] = mat.to(pool.dtype)


def read_state(pool, rows, size: int):
    """Gather each slot's packed recurrent state: rows (B, state_rows) ->
    (B, size) float32 (the last row's padding cut off)."""
    return pool[rows.long()].reshape(rows.shape[0], -1)[:, :size]


def write_state(pool, rows, buf, valid=None) -> None:
    """Scatter each slot's packed state buffer back, in place: buf (B,
    size) split into pool-row-wide tiles (``packing.pad_rows``). Invalid
    slots write to the trash row."""
    tiles = pad_rows(buf.to(pool.dtype), pool.shape[-1])         # (B, R, E)
    if valid is not None:
        rows = torch.where(valid[:, None], rows, TRASH_ROW)
    pool.index_put_((rows.long(),), tiles)
