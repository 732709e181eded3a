"""The Python side of four kernels' work split, which the CPU can check
though it cannot run the kernels: ``rmsnorm.layout`` (which threads of
``csrc/rmsnorm.cu`` take which row and which 16-byte vectors of it),
``flash_attention.tile_schedule`` (which query tiles each block of
``csrc/flash_attention.cu`` takes); and mirrors kept here of two kernels'
split, which no wrapper needs: ``sgd_schedule`` (which strips of the
active rows each block of ``sgd_strips`` in ``csrc/fused_update.cu``
updates) and ``norm_schedule`` / ``norm_finish_sum`` (which strips each
block of a row of ``csrc/sq_norm.cu`` sums, and the order in which the
row's last block sums the partials), their constants read from the
sources. The assignments repeat the kernels' index arithmetic; each must
reach every row and column, or every (query tile, head), exactly once,
and no inactive row. (On the card, ``chip_smoke.py`` holds both kernels
bit-equal to their plain versions and on a rerun.)"""
import os
import re

import numpy as np
import pytest

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn

CSRC = os.path.join(os.path.dirname(fa.__file__), "csrc")


def _cu_int(stem, expr):
    """The integer a ``constexpr`` line of ``csrc/<stem>.cu`` gives, where
    ``expr`` matches it (a product of constants of the same file)."""
    src = open(os.path.join(CSRC, stem + ".cu")).read()
    value = re.search(r"constexpr \w+ " + expr + r" = ([^;]+);", src).group(1)
    value = value.replace("static_cast<int64_t>", "")
    for name, v in re.findall(r"constexpr \w+ (k\w+) = (\d+);", src):
        value = re.sub(r"\b" + name + r"\b", v, value)
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
