"""The Python side of the kernels' work split, which the CPU can check
though it cannot run the kernels: ``rmsnorm.layout`` (which threads of
``csrc/rmsnorm.cu`` take which row and which 16-byte vectors of it),
``flash_attention.tile_schedule`` (which query tiles each block of
``csrc/flash_attention.cu`` takes), ``decode_attention.span_pages`` (how
many pages of a slot each block of ``csrc/decode_attention.cu`` takes);
and mirrors kept here of four kernels' split, which no wrapper needs:
``sgd_schedule`` (which strips of the active rows each block of
``sgd_strips`` in ``csrc/fused_update.cu`` updates), ``norm_schedule`` /
``norm_finish_sum`` (which strips each block of a row of
``csrc/sq_norm.cu`` sums, and the order in which the row's last block
sums the partials), ``decode_schedule`` / ``decode_emulate`` (which
tokens each (span, warp, lane group) of the decode kernel reads, and its
online softmax and merges in float32) and ``mamba_blocks`` (which causal
16 x 16 blocks each warp of ``csrc/mamba_scan.cu`` computes), their
constants read from the sources. The assignments repeat the kernels'
index arithmetic; each must reach every row and column, every (query
tile, head), every live token or every causal entry exactly once, and no
inactive row, no token past a slot's length and no entry above the
diagonal. (On the card, ``chip_smoke.py`` holds the kernels to their
plain versions and, where it says so, bit-equal on a rerun.)"""
import os
import re

import numpy as np
import pytest

from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import rmsnorm as rn

CSRC = os.path.join(os.path.dirname(fa.__file__), "csrc")


def _cu_int(stem, expr):
    """The integer a ``constexpr`` line of ``csrc/<stem>.cu`` gives, where
    ``expr`` matches it (sums and products of constants of the same
    file)."""
    src = open(os.path.join(CSRC, stem + ".cu")).read()
    value = re.search(r"constexpr \w+ " + expr + r" = ([^;]+);", src).group(1)
    value = value.replace("static_cast<int64_t>", "")
    value = re.sub(r"\bk\w+\b", lambda m: str(_cu_int(stem, m.group())),
                   value)
    return int(eval(value, {}))   # noqa: S307 -- products of integers


SGD_STRIP = _cu_int("fused_update", "kStrip")     # float4s, one a thread
NORM_THREADS = _cu_int("sq_norm", "kThreads")
NORM_STRIP = _cu_int("sq_norm", "kStrip")         # kThreads x kU float4s

# chip_smoke.py RMS_FULL, RMS_WIDE and RMS_EDGE (rows flattened), and
# ragged widths
RMS_SHAPES = [(4096, 3584), (4096, 7168), (262_144, 128), (4096, 5120),
              (4096, 3588), (4, 64), (16, 128), (31, 33), (300, 256), (1, 16),
              (5, 4100), (3, 1000), (2, 8196), (2, 40_000)]


def _columns(d, itemsize, tpr, nv):
    """How often each column of one row is taken: lane l of the row's tpr
    holds vectors l + i * tpr (i < nv) below nvec; the streaming kernel
    (nv 0) walks a warp's lanes over vectors or, where D is no multiple
    of the vector, over elements."""
    vec = 16 // itemsize
    hits = np.zeros(d, np.int64)
    if nv == 0:
        step = vec if d % vec == 0 else 1
        for lane in range(32):
            for k in range(lane * step, d, 32 * step):
                hits[k:k + step] += 1
        return hits
    nvec = d // vec
    for lane in range(tpr):
        for i in range(nv):
            j = lane + i * tpr
            if j < nvec:
                hits[j * vec:(j + 1) * vec] += 1
    return hits


def _rows(rows, tpr, threads, grid):
    """How often each row is taken: threads // tpr row groups a block,
    block b's group s takes rows b * per + s, stepping by grid * per."""
    per = threads // tpr
    first = (np.arange(grid)[:, None] * per + np.arange(per)).ravel()
    taken = first[:, None] + np.arange(-(-rows // (grid * per)))[None, :] * (
        grid * per)
    return np.bincount(taken[taken < rows], minlength=rows)


@pytest.mark.parametrize("shape", RMS_SHAPES)
@pytest.mark.parametrize("itemsize", [4, 2])
def test_rmsnorm_layout_covers_each_element_once(shape, itemsize):
    rows, d = shape
    for aligned in (True, False):
        tpr, nv, threads = rn.layout(d, itemsize, aligned)
        assert threads % 32 == 0 and threads <= 1024
        if nv:
            assert aligned and d % (16 // itemsize) == 0
            assert tpr & (tpr - 1) == 0 and 1 <= nv <= rn.MAX_VECS
            assert (threads % tpr == 0) if tpr <= 32 else tpr == threads
            # no thread holds a vector slot that is always empty
            assert (nv - 1) * tpr < d // (16 // itemsize)
        else:
            assert (tpr, threads) == (32, 256)
        np.testing.assert_array_equal(_columns(d, itemsize, tpr, nv), 1)
        groups = -(-rows // (threads // tpr))
        for grid in {1, min(groups, 132 * 3), groups}:
            np.testing.assert_array_equal(_rows(rows, tpr, threads, grid), 1)


def test_rmsnorm_layout_by_width():
    """The chosen layouts at the widths the card times: a narrow row
    shares a warp, a wide one gets a block, unaligned goes streaming."""
    assert rn.layout(128, 4) == (8, 4, 256)       # qwen3-32b qk-norm
    assert rn.layout(3584, 4) == (128, 7, 128)    # zamba2-7b d_model
    assert rn.layout(7168, 4) == (256, 7, 256)    # zamba2-7b d_inner
    assert rn.layout(5120, 4) == (256, 5, 256)    # qwen3-32b d_model
    assert rn.layout(3584, 2) == (128, 4, 128)
    assert rn.layout(33, 4)[1] == rn.layout(3584, 4, False)[1] == 0


@pytest.mark.parametrize("S", [1, 16, 40, 63, 64, 65, 127, 128, 129, 256,
                               1000, 1024, 1088, 2048, 4097])
def test_flash_schedule_visits_each_tile_once(S):
    B, H = 2, 3                       # the grid's y axis: one row per (b, h)
    nq = -(-S // fa.TILE)
    sched = fa.tile_schedule(S)
    seen = {}
    for bh in range(B * H):
        for x, tiles in enumerate(sched):
            # the kernel: first = nq - 1 - x, then x unless it is the same
            assert tiles == ([nq - 1 - x] + ([x] if x != nq - 1 - x else []))
            for tile in tiles:
                seen[(tile, bh)] = seen.get((tile, bh), 0) + 1
    assert seen == {(i, bh): 1 for i in range(nq) for bh in range(B * H)}
    assert len(sched) == (nq + 1) // 2    # the kernel's grid x
    work = [sum(i + 1 for i in tiles) for tiles in sched]  # key tiles
    assert all(w == nq + 1 for w in work[:nq // 2])
    if nq % 2:
        assert work[-1] == nq // 2 + 1    # the middle tile alone


def head_len(start: int, n: int) -> int:
    """Elements of a row that starts ``start`` floats past a 16-byte grain
    before its first float4 (``head_len`` in both sources)."""
    return min((4 - start % 4) % 4, n)


def sgd_schedule(rows: int, n: int, active, grid: int, offset: int = 0):
    """What each block of ``sgd_strips`` (csrc/fused_update.cu, its loop
    ``for (int64_t s = blockIdx.x; s < total; s += gridDim.x)`` and the
    row cursor) updates, in its order: for block b, a list of (row,
    first, last) column ranges. The strips of the active rows are
    numbered in row order (``strips_per_row``: SGD_STRIP float4s of a
    row's body each, at least one a row); block b takes strip b, b +
    grid, ...; the first strip of a row also takes its ragged head and
    tail. ``offset``: the buffer's start, in floats past a 16-byte
    grain."""
    act = [r for r in range(rows) if active is None or active[r]]
    per_row = max(1, -(-(n // 4) // SGD_STRIP))
    out = [[] for _ in range(grid)]
    for s in range(len(act) * per_row):
        r, c = act[s // per_row], s % per_row
        head = head_len(offset + r * n, n)
        nvec = (n - head) // 4
        first, last = c * SGD_STRIP, min(nvec, (c + 1) * SGD_STRIP)
        if first < last:
            out[s % grid].append((r, head + 4 * first, head + 4 * last))
        if c == 0:
            out[s % grid] += [(r, 0, head), (r, head + 4 * nvec, n)]
    return out


def norm_blocks_per_row(rows: int, n: int, resident: int,
                        capacity: int) -> int:
    """``blocks_per_row`` of csrc/sq_norm.cu: the ``resident`` blocks
    shared over the rows, at least 1, at most one a strip and
    ``capacity // rows``."""
    return max(1, min(resident // rows, -(-(n // 4) // NORM_STRIP),
                      capacity // rows))


def norm_schedule(n: int, bpr: int, start: int = 0):
    """What each of a row's ``bpr`` blocks of ``sq_norm_rows`` sums (its
    loop ``for (int64_t k0 = blockIdx.x * kStrip + threadIdx.x; ...; k0 +=
    bpr * kStrip)``): for block x, a list of [first, last) column ranges
    of a row that starts ``start`` floats past a 16-byte grain. Block x
    takes strips x, x + bpr, ... of the float4 body; block 0 also the
    ragged head and tail."""
    head = head_len(start, n)
    nvec = (n - head) // 4
    out = [[] for _ in range(bpr)]
    for s in range(-(-nvec // NORM_STRIP)):
        out[s % bpr].append((head + 4 * s * NORM_STRIP,
                             head + 4 * min(nvec, (s + 1) * NORM_STRIP)))
    out[0] += [(0, head), (head + 4 * nvec, n)]
    return out


def _block_sum(vals):
    """``block_sum`` of csrc/sq_norm.cu on one float32 a thread, in its
    order: shuffles down by 16, 8, 4, 2, 1 in each warp (a lane whose
    partner is past the warp keeps its own value), then warp 0 over the
    warp sums by kWarps / 2, ..., 1."""
    def warp(s, offsets):
        s = s.copy()
        for o in offsets:
            s = s + np.concatenate([s[o:], s[32 - o:]])
        return s[0]
    n_warps = NORM_THREADS // 32
    sums = [warp(vals[w * 32:(w + 1) * 32], (16, 8, 4, 2, 1))
            for w in range(n_warps)]
    lanes = np.zeros(32, np.float32)
    lanes[:len(sums)] = sums
    return warp(lanes, [n_warps >> i for i in range(1, n_warps.bit_length())])


def norm_finish_sum(partials) -> np.float32:
    """The row's sum as the block that draws the last ticket forms it
    (``for (int64_t k = threadIdx.x; k < bpr; k += kThreads) t +=
    partials[...]``, then ``block_sum``), in float32, whichever block
    that is."""
    partials = np.asarray(partials, np.float32)
    acc = np.zeros(NORM_THREADS, np.float32)
    for k in range(0, len(partials), NORM_THREADS):
        chunk = partials[k:k + NORM_THREADS]
        acc[:len(chunk)] += chunk
    return _block_sum(acc)


# ragged widths (shorter than a float4, a strip and a bit, several
# strips plus a tail) and the active masks of 1 to 4 rows of 4
SGD_WIDTHS = [1, 3, 5, 4099, 3 * 4 * SGD_STRIP + 7]
SGD_MASKS = [None, (1, 0, 0, 0), (0, 0, 1, 0), (0, 1, 1, 0), (1, 1, 0, 1),
             (0, 0, 0, 0)]


@pytest.mark.parametrize("n", SGD_WIDTHS)
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("active", SGD_MASKS)
def test_sgd_schedule_updates_each_active_element_once(n, offset, active):
    rows = 4
    want = np.zeros((rows, n), np.int64)
    for r in range(rows):
        want[r] = active is None or active[r]
    # the kernel's grids: one block a strip of every row (no mask), or of
    # one row (a mask), and smaller ones, as past CUDA's grid limit
    per_row = max(1, -(-(n // 4) // SGD_STRIP))
    for grid in (1, 3, 1056, per_row, rows * per_row):
        sched = sgd_schedule(rows, n, active, grid, offset)
        assert len(sched) == grid
        hits = np.zeros((rows, n), np.int64)
        for blk in sched:
            # the block's cursor over the rows only moves forward
            seen = [r for r, _, _ in blk]
            assert seen == sorted(seen)
            for r, first, last in blk:
                hits[r, first:last] += 1
        np.testing.assert_array_equal(hits, want)


def test_sgd_schedule_spreads_one_active_row_over_every_block():
    """A step of the per-group T_i schedule with one row of four active,
    on the masked grid (one block a strip of one row): every block
    updates one strip, where a grid over every row's strips would leave
    three quarters of its blocks without work."""
    n = 64 * 4 * SGD_STRIP
    grid = -(-(n // 4) // SGD_STRIP)
    sched = sgd_schedule(4, n, (0, 0, 1, 0), grid)
    work = [sum(last - first for _, first, last in blk) for blk in sched]
    assert min(work) == max(work) == 4 * SGD_STRIP
    wide = sgd_schedule(4, n, (0, 0, 1, 0), 4 * grid)
    assert sum(1 for blk in wide if blk) == grid


@pytest.mark.parametrize("n", [1, 3, 4099, 3 * 4 * NORM_STRIP + 7, 40_000])
@pytest.mark.parametrize("start", [0, 1, 2, 3])
@pytest.mark.parametrize("bpr", [1, 2, 7])
def test_sq_norm_schedule_sums_each_element_once(n, start, bpr):
    hits = np.zeros(n, np.int64)
    for blk in norm_schedule(n, bpr, start):
        for first, last in blk:
            hits[first:last] += 1
    np.testing.assert_array_equal(hits, 1)


@pytest.mark.parametrize("bpr", [1, 5, 256, 300, 1056])
def test_sq_norm_finish_takes_each_partial_once_in_a_fixed_order(bpr):
    """The row's last block sums the partials in one order whichever
    block draws the last ticket: each partial enters once (one-hot
    partials sum to 1), and the sum is a function of the partials alone,
    within float32 rounding of the exact sum."""
    for i in sorted({0, bpr // 2, bpr - 1}):
        onehot = np.zeros(bpr, np.float32)
        onehot[i] = 1.0
        assert norm_finish_sum(onehot) == 1.0
    parts = np.random.default_rng(bpr).random(bpr).astype(np.float32)
    got = norm_finish_sum(parts)
    assert got.dtype == np.float32 and got == norm_finish_sum(parts.copy())
    np.testing.assert_allclose(got, parts.astype(np.float64).sum(),
                               rtol=1e-6)


def test_sq_norm_blocks_per_row():
    """The resident blocks (132 SMs x 8) shared over the rows, clamped to
    the strips of a row and to the scratch."""
    n = 124_662_528                   # paper-lenet's packed buffer
    assert norm_blocks_per_row(4, n, 1056, 1056) == 264
    assert norm_blocks_per_row(1, n, 1056, 1056) == 1056
    assert norm_blocks_per_row(2000, n, 1056, 2000) == 1
    assert norm_blocks_per_row(4, 4099, 1056, 1056) == 1
    assert norm_blocks_per_row(4, 3 * 4 * NORM_STRIP + 7, 1056, 1056) == 4
    assert norm_blocks_per_row(4, 3, 1056, 1056) == 1


# -- paged_decode_attention: spans of a slot's pages, one merge

DECODE_WARPS = _cu_int("decode_attention", "kWarps")
DECODE_ELEMS = _cu_int("decode_attention", "kElems")     # floats a lane holds
DECODE_MAX_GB = _cu_int("decode_attention", "kMaxGB")
DECODE_SPAN_PAGES = _cu_int("decode_attention", "kMaxSpanPages")
NEG_INF = np.float32(-1e30)


def _decode_u(gb: int) -> int:
    """Tokens in flight a lane (``constexpr int U = GB <= a ? b : c``)."""
    src = open(os.path.join(CSRC, "decode_attention.cu")).read()
    a, b, c = map(int, re.search(
        r"constexpr int U = GB <= (\d+) \? (\d+) : (\d+);", src).groups())
    return b if gb <= a else c


def decode_lanes(hd: int, vec: bool = True) -> int:
    """Lanes a token (the launcher's dispatch): float4s of the token
    rounded up to a power of two, at least 2; 32 for scalar loads."""
    if not vec:
        return 32
    nv = hd // DECODE_ELEMS
    return next(lpt for lpt in (2, 4, 8, 16, 32) if nv <= lpt)


def decode_heads_a_block(g: int) -> int:
    """GB: the block's query heads rounded up to 1, 2, 4 or 8."""
    splits = -(-g // DECODE_MAX_GB)
    per = -(-g // splits)
    return next(gb for gb in (1, 2, 4, 8) if per <= gb)


def decode_schedule(length: int, nblk: int, ps: int, pps: int, lpt: int,
                    u: int):
    """What the blocks of one slot read (the kernel's loops ``for (int tw
    = it0 + warp * TPW; tw < it1; tw += U * kStep)`` over ``t = tw + slot
    + u * kStep``): the span count S, the (span, warp, lane group, token)
    reads in the order each group takes them, and the page-table entries
    each span loads (its own pages within the table, with the length)."""
    spans = max(1, -(-nblk // pps))
    tpw = 32 // lpt
    step = DECODE_WARPS * tpw
    ln = min(length, nblk * ps)
    reads, pages = [], {}
    for s in range(spans):
        t0 = s * pps * ps
        t1 = min(ln, t0 + pps * ps)
        pages[s] = list(range(s * pps, min(nblk, (s + 1) * pps)))
        for w in range(DECODE_WARPS):
            tw = t0 + w * tpw
            while tw < t1:
                for k in range(u):
                    for slot in range(tpw):
                        t = tw + slot + k * step
                        if t < t1:
                            reads.append((s, w, slot, t))
                tw += u * step
    return spans, reads, pages


def _merge(a, b):
    """Two (m, l, acc) partials of one head, as the kernel's lane-group
    shuffle merge forms them: each scaled by exp(m - max m), summed."""
    mx = np.maximum(a[0], b[0])
    ca, cb = np.exp(a[0] - mx), np.exp(b[0] - mx)
    return mx, np.float32(a[1] * ca + b[1] * cb), (a[2] * ca + b[2] * cb)


def merge_spans(partials):
    """The last block's merge of a head's S span partials (m, l, acc):
    lane j of a warp takes spans j, j + 32, ... (their max, then l
    scaled to it and summed in that order), a butterfly over the 32
    lanes; then acc scaled and summed in span order, divided by the sum
    of l clamped at 1e-30."""
    m = np.array([p[0] for p in partials], np.float32)
    lanes = np.full(32, NEG_INF, np.float32)
    for k, mk in enumerate(m):
        lanes[k % 32] = max(lanes[k % 32], mk)
    mx = lanes.max()
    ls = np.zeros(32, np.float32)
    for k, (mk, lk, _) in enumerate(partials):
        ls[k % 32] = np.float32(ls[k % 32] + lk * np.exp(mk - mx))
    for o in (16, 8, 4, 2, 1):
        ls = (ls + ls[np.arange(32) ^ o]).astype(np.float32)
    acc = np.zeros_like(partials[0][2])
    for mk, _, ak in partials:
        acc = (acc + ak * np.exp(mk - mx)).astype(np.float32)
    return acc / np.maximum(ls[0], np.float32(1e-30))


def decode_emulate(q, k, v, length, nblk, ps, pps, lpt, u):
    """One head of one slot as the kernel computes it, in float32: each
    lane group's online softmax over its tokens U at a time, the groups of
    a warp merged by the butterfly, the warps in warp order, the spans by
    ``merge_spans`` (or the one span's partial divided)."""
    hd = q.shape[0]
    scale = np.float32(1.0 / np.sqrt(hd))
    spans, reads, _ = decode_schedule(length, nblk, ps, pps, lpt, u)
    tpw, step = 32 // lpt, DECODE_WARPS * (32 // lpt)
    ln = min(length, nblk * ps)
    partials = []
    for s in range(spans):
        t0, t1 = s * pps * ps, min(ln, (s + 1) * pps * ps)
        warps = []
        for w in range(DECODE_WARPS):
            groups = []
            for slot in range(tpw):
                m, l, acc = NEG_INF, np.float32(0), np.zeros(hd, np.float32)
                tw = t0 + w * tpw
                while tw < t1:
                    ts = [tw + slot + i * step for i in range(u)]
                    live = np.array([t < t1 for t in ts])
                    tt = np.where(live, ts, 0)
                    sc = np.where(live, (k[tt] @ q).astype(np.float32) * scale,
                                  NEG_INF).astype(np.float32)
                    mx = np.maximum(m, sc.max())
                    corr = np.exp(m - mx)
                    p = np.where(live, np.exp(sc - mx), 0).astype(np.float32)
                    acc = (acc * corr + p @ v[tt]).astype(np.float32)
                    l, m = np.float32(l * corr + p.sum()), mx
                    tw += u * step
                groups.append((m, l, acc))
            o = 1
            while o < tpw:
                groups = [_merge(groups[j], groups[j ^ o]) for j in range(tpw)]
                o *= 2
            warps.append(groups[0])
        mx = max(wp[0] for wp in warps)
        lsum = np.float32(0)
        acc = np.zeros(hd, np.float32)
        for wm, wl, wa in warps:
            c = np.exp(wm - mx)
            lsum = np.float32(lsum + wl * c)
            acc = (acc + wa * c).astype(np.float32)
        partials.append((mx, lsum, acc))
    if spans == 1:
        return partials[0][2] / np.maximum(partials[0][1], np.float32(1e-30))
    return merge_spans(partials), partials


# (length, nblk, ps, hd, g, B): paper-lenet's step and one request,
# qwen3-32b's heads at a long and a short length, a trash-row slot of
# length 1, a slot whose later spans are all empty, lengths on and past
# the table's end, hd no multiple of 4, and small pages
DECODE_SLOTS = [(1056, 66, 16, 64, 1, 8), (528, 66, 16, 64, 1, 8),
                (1056, 66, 16, 64, 1, 1), (4096, 256, 16, 128, 8, 8),
                (17, 256, 16, 128, 8, 8), (1, 66, 16, 64, 1, 8),
                (130, 66, 16, 64, 1, 1), (5000, 66, 16, 64, 1, 8),
                (200, 40, 4, 3, 5, 2), (33, 12, 16, 50, 2, 3),
                (7, 5, 4, 8, 2, 3), (3, 2, 2, 4, 2, 65535)]


@pytest.mark.parametrize("slot_case", DECODE_SLOTS)
def test_decode_schedule_reads_each_live_token_once(slot_case):
    length, nblk, ps, hd, g, B = slot_case
    pps = da.span_pages(B, 2, g, nblk, ps, sms=132)
    assert 1 <= pps <= DECODE_SPAN_PAGES
    for vec in (hd % 4 == 0, False):
        lpt = decode_lanes(hd, vec)
        spans, reads, pages = decode_schedule(
            length, nblk, ps, pps, lpt, _decode_u(decode_heads_a_block(g)))
        assert spans <= 65535
        ln = min(length, nblk * ps)
        tokens = [t for _, _, _, t in reads]
        assert sorted(tokens) == list(range(ln))      # each once, none past
        for s, w, slot, t in reads:                   # in its own span
            assert s * pps * ps <= t < (s + 1) * pps * ps
            assert t // ps in pages[s]
        entries = sorted(p for s in range(spans) for p in pages[s])
        assert entries == list(range(nblk))           # each entry loaded once


def test_decode_span_pages():
    """As many spans as keep about four blocks an SM in flight over the
    grid, never under 32 tokens, at most kMaxSpanPages pages whatever the
    page size; paper-lenet's step, one request and qwen3-32b's heads on
    132 SMs."""
    sms = 132
    assert da.span_pages(8, 12, 1, 66, 16, sms) == 14    # paper-lenet: 5 spans
    assert da.span_pages(1, 12, 1, 66, 16, sms) == 2     # one request: 33
    assert da.span_pages(8, 8, 8, 256, 16, sms) == 32    # qwen3-32b: 8 spans
    assert da.span_pages(8, 8, 16, 256, 16, sms) == 64   # two blocks a KV head
    assert da.span_pages(1, 1, 1, 100_000, 1, sms) == DECODE_SPAN_PAGES
    assert da.span_pages(1, 1, 1, 10_000, 1, sms) == 32      # 32 tokens at least
    assert da.span_pages(1, 1, 1, 3, 512, sms) == 1
    assert da.span_pages(4, 1, 1, 0, 16, sms) >= 1
    assert -(-2 // da.span_pages(65535, 1, 1, 2, 2, sms)) == 1   # one span a slot
    assert da.HEADS_A_BLOCK == DECODE_MAX_GB
    assert da.MAX_SPAN_PAGES == DECODE_SPAN_PAGES


def _decode_inputs(length, hd, seed):
    rng = np.random.default_rng(seed)
    n = max(length, 1)
    q = rng.standard_normal(hd).astype(np.float32)
    k = rng.standard_normal((n, hd)).astype(np.float32)
    v = rng.standard_normal((n, hd)).astype(np.float32)
    return q, k, v


def _softmax64(q, k, v, length):
    s = k[:length].astype(np.float64) @ q / np.sqrt(q.shape[0])
    p = np.exp(s - s.max())
    return (p / p.sum()) @ v[:length]


@pytest.mark.parametrize("length,nblk,ps,hd,g,B", [
    (300, 66, 16, 16, 1, 1),       # 22 spans of 48 tokens, most empty
    (1, 66, 16, 16, 1, 8),         # a trash-row slot: spans 1-8 empty
    (140, 66, 16, 8, 1, 8),        # 2 live spans of 9
    (257, 40, 8, 32, 8, 2),        # lane groups of 8 lanes
    (45, 12, 4, 12, 2, 1),         # hd 12: 4 lanes, the scalar path too
])
def test_decode_merge_equals_the_softmax(length, nblk, ps, hd, g, B):
    """The kernel's arithmetic in float32 (lane-group online softmax, the
    butterfly, the warps, the span merge) against a float64 softmax,
    within the card's fp32 tolerance (chip_smoke.py ATTN_TOL)."""
    pps = da.span_pages(B, 4, g, nblk, ps, sms=132)
    q, k, v = _decode_inputs(length, hd, seed=length)
    want = _softmax64(q, k, v, length)
    for vec in (hd % 4 == 0, False):
        got = decode_emulate(q, k, v, length, nblk, ps, pps,
                             decode_lanes(hd, vec),
                             _decode_u(decode_heads_a_block(g)))
        out = got if isinstance(got, np.ndarray) else got[0]
        assert np.isfinite(out).all()
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
        if not isinstance(got, np.ndarray):
            parts = got[1]
            empty = [p for p in parts if p[0] == NEG_INF]
            assert len(empty) == len(parts) - -(-length // (pps * ps))
            for m, l, acc in empty:                   # the empty partial
                assert l == 0 and not acc.any()


def test_decode_merge_takes_each_partial_once():
    """One live span among empty ones gives that span's result exactly
    (each empty partial weighs exp(-1e30 - m) = 0, never a NaN); one-hot
    partials at equal m enter once each; all empty gives zeros."""
    hd = 8
    live = (np.float32(0.7), np.float32(2.5),
            np.arange(hd, dtype=np.float32))
    empty = (NEG_INF, np.float32(0), np.zeros(hd, np.float32))
    for at in (0, 5, 39):
        parts = [empty] * 40
        parts[at] = live
        got = merge_spans(parts)
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got, live[2] / live[1])
    onehot = [(np.float32(0), np.float32(1), np.eye(hd, dtype=np.float32)[i])
              for i in range(hd)]
    np.testing.assert_array_equal(merge_spans(onehot),
                                  np.full(hd, 1 / np.float32(hd), np.float32))
    assert not merge_spans([empty] * 3).any()


# -- mamba_chunk: causal 16 x 16 blocks, two row tiles a warp pair

MAMBA_WARPS = _cu_int("mamba_scan", "kWarps")
MAMBA_PAIRS = _cu_int("mamba_scan", "kPairs")
MAMBA_TILES = _cu_int("mamba_scan", "kTiles")
MAMBA_SLOTS = _cu_int("mamba_scan", "kSlots")
MAMBA_MAX_L = _cu_int("mamba_scan", "kMaxL")
MAMBA_PT = _cu_int("mamba_scan", "kPT")           # 8-column tiles a warp


def mamba_blocks(pair: int):
    """The (row tile, key tile) of each of a pair's causal blocks
    (``block_of``: row tile ``pair`` for keys 0..pair, then row tile
    ``kTiles - 1 - pair`` for keys 0..kTiles - 1 - pair)."""
    out = []
    for k in range(MAMBA_SLOTS):
        first = k <= pair
        out.append((pair, k) if first else
                   (MAMBA_TILES - 1 - pair, k - pair - 1))
    return out


def mamba_cb_blocks(warp: int):
    """The blocks of C B^T a warp computes: its pair's first
    ceil(kSlots / 2) blocks for the pair's first warp, the rest for the
    second (``mid`` in the kernel)."""
    pair, half = warp % MAMBA_PAIRS, warp // MAMBA_PAIRS
    mid = (MAMBA_SLOTS + 1) // 2
    blocks = mamba_blocks(pair)
    return blocks[:mid] if half == 0 else blocks[mid:]


@pytest.mark.parametrize("L", [1, 8, 15, 16, 17, 64, 96, 100, 127, 128])
def test_mamba_blocks_cover_the_causal_entries_once(L):
    """Each causal 16 x 16 block of the chunk is computed once (C B^T, by
    one warp) and used once (M x, by one pair), none above the diagonal;
    inside, the exp is evaluated exactly on j <= i < L."""
    tiles = -(-L // 16)
    computed = np.zeros((MAMBA_TILES, MAMBA_TILES), np.int64)
    for w in range(MAMBA_WARPS):
        for i, j in mamba_cb_blocks(w):
            if i < tiles:                       # the kernel skips the tile
                computed[i, j] += 1
    hits = np.zeros((16 * MAMBA_TILES, 16 * MAMBA_TILES), np.int64)
    evaluated = np.zeros_like(hits)
    for pair in range(MAMBA_PAIRS):
        blocks = mamba_blocks(pair)
        assert len(blocks) == MAMBA_SLOTS
        assert all(0 <= j <= i < MAMBA_TILES for i, j in blocks)
        for i, j in blocks:
            if i >= tiles:
                continue
            hits[16 * i:16 * i + 16, 16 * j:16 * j + 16] += 1
            rows = np.arange(16 * i, 16 * i + 16)[:, None]
            cols = np.arange(16 * j, 16 * j + 16)[None, :]
            # the mask before the exp: j <= i < L
            evaluated[16 * i:16 * i + 16, 16 * j:16 * j + 16] += (
                (cols <= rows) & (rows < L))
    causal = np.tril(np.ones((L, L), np.int64))
    np.testing.assert_array_equal(evaluated[:L, :L], causal)
    assert not evaluated[L:].any() and not evaluated[:, L:].any()
    tril = np.tril(np.ones((tiles, tiles), np.int64))
    np.testing.assert_array_equal(hits[::16, ::16][:tiles, :tiles], tril)
    np.testing.assert_array_equal(computed[:tiles, :tiles], tril)
    assert not hits[::16, ::16][tiles:].any() and not computed[tiles:].any()


def test_mamba_blocks_balance_the_pairs():
    """Row tiles w and kTiles - 1 - w: every pair takes kTiles + 1 of the
    kTiles (kTiles + 1) / 2 causal blocks of a full chunk, and its two
    warps split C B^T's 9 blocks 5 and 4."""
    assert MAMBA_TILES == 2 * MAMBA_PAIRS and MAMBA_MAX_L == 16 * MAMBA_TILES
    assert MAMBA_WARPS == 2 * MAMBA_PAIRS
    assert ms.MAX_CHUNK == MAMBA_MAX_L
    counts = [len(mamba_blocks(p)) for p in range(MAMBA_PAIRS)]
    assert counts == [MAMBA_SLOTS] * MAMBA_PAIRS
    assert sum(counts) == MAMBA_TILES * (MAMBA_TILES + 1) // 2
    per_warp = [len(mamba_cb_blocks(w)) for w in range(MAMBA_WARPS)]
    assert max(per_warp) - min(per_warp) == 1


@pytest.mark.parametrize("N,P", [(1, 1), (4, 4), (8, 8), (16, 16), (17, 40),
                                 (64, 64), (100, 72), (128, 128)])
def test_mamba_outputs_cover_each_entry_once(N, P):
    """Pair w takes the state's 16-row tiles w, w + kPairs, ... (``for
    (int n0 = 16 * pair; n0 < N; n0 += 16 * kPairs)``) and y's row tiles
    by ``mamba_blocks``; its warp h the column tiles of 8 * kPT columns
    from 8 * kPT * h, stepping by 16 * kPT (``for (int c0 = ...)``)."""
    pp = -(-P // 8) * 8
    cols = np.zeros(P, np.int64)
    for half in range(MAMBA_WARPS // MAMBA_PAIRS):
        for c0 in range(8 * MAMBA_PT * half, pp, 16 * MAMBA_PT):
            cols[c0:c0 + 8 * MAMBA_PT] += 1
    np.testing.assert_array_equal(cols, 1)
    rows = np.zeros(N, np.int64)
    for pair in range(MAMBA_PAIRS):
        for n0 in range(16 * pair, N, 16 * MAMBA_PAIRS):
            rows[n0:n0 + 16] += 1
    np.testing.assert_array_equal(rows, 1)
