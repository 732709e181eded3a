"""The Python side of two kernels' work split, which the CPU can check
though it cannot run the kernels: ``rmsnorm.layout`` (which threads of
``csrc/rmsnorm.cu`` take which row and which 16-byte vectors of it) and
``flash_attention.tile_schedule`` (which query tiles each block of
``csrc/flash_attention.cu`` takes). The assignments below repeat the
kernels' index arithmetic; each must reach every row and column, or
every (query tile, head), exactly once."""
import numpy as np
import pytest

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmsnorm as rn

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
