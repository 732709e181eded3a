"""The tolerance argument of the flash kernel's 3xTF32 products
(``csrc/flash_attention.cu``), emulated on the CPU in the kernel's order
and with its rounding:

- TF32 is ``cvt.rna`` (round half away from zero on the 13 low mantissa
  bits of a float32), and x = hi + lo with hi, lo both TF32;
- one ``mma.sync`` k step adds eight exact products of TF32 values to
  its float32 accumulator and truncates the sum (round toward zero);
- a product a.b is hi(a)lo(b) + lo(a)hi(b) + hi(a)hi(b): over two k
  steps, every small product first, then the hi.hi ones, into a fresh
  accumulator that a round-to-nearest float32 add folds into S or the
  output;
- the online softmax runs over 64-key tiles in float32, the division by
  the row sum last.

So emulated, causal attention stays within the float32 tolerance that
the card's check holds the kernel to (rtol 1e-5, atol 1e-6 against a
float64 evaluation). One long truncating chain into each accumulator
drifts past it, and so does one TF32 product a step. Inputs are seeded
numpy normals, as in the card's check."""
import numpy as np
import pytest

ATTN_TOL = dict(rtol=1e-5, atol=1e-6)       # chip_smoke.py ATTN_TOL
SHAPES = [(1, 2, 1024, 64), (1, 2, 384, 128)]
# the long chain's drift grows with the key count: at hd 128 over 384
# keys it stays inside the tolerance
LONG = [(1, 2, 1024, 64), (1, 1, 2048, 64)]
TILE = 64          # keys a tile (the kernel's kTile)
STEPS = 2          # k steps of 8 a fresh accumulator (the kernel's kSteps)


def rna_tf32(x):
    """float32 -> the nearest TF32 value, ties away from zero (the
    magnitude's bits rounded at bit 13; the sign bit is apart)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def rz_f32(x):
    """float64 -> float32, rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def mma(c, a, b):
    """One k step: c (float32) + a (.., M, 8) @ b (.., 8, N), the eight
    products of TF32 values summed exactly, the result truncated."""
    return rz_f32(c.astype(np.float64)
                  + a.astype(np.float64) @ b.astype(np.float64))


def dot(c, a, b, split_products=True, fold=STEPS):
    """c + a @ b over a's last axis, in k steps of 8 on the tensor cores.
    ``split_products``: the 3xTF32 split (else one TF32 product a step);
    ``fold``: k steps a fresh accumulator, folded into c by a
    round-to-nearest add (None: every step into c, one long chain)."""
    if split_products:
        (ah, al), (bh, bl) = split(a), split(b)
        terms = [(ah, bl), (al, bh)], [(ah, bh)]   # the small ones first
    else:
        terms = [], [(rna_tf32(a), rna_tf32(b))]
    steps = [slice(s, s + 8) for s in range(0, a.shape[-1], 8)]
    groups = [steps] if fold is None else [
        steps[i:i + fold] for i in range(0, len(steps), fold)]
    for group in groups:
        t = c if fold is None else np.zeros_like(c)
        for phase in terms:
            for sl in group:
                for x, y in phase:
                    t = mma(t, x[..., sl], y[..., sl, :])
        c = t if fold is None else c + t
    return c


def kernel_attention(q, k, v, **kw):
    """Causal attention of (B, H, S, hd) float32 as the kernel takes it:
    key tiles of 64 up to the diagonal, S and P @ V by ``dot``, the online
    softmax in float32 (mask -1e30, m, l and the rescale per row)."""
    S, hd = q.shape[-2:]
    scale = np.float32(1.0 / np.sqrt(hd))
    pad = -S % TILE
    k, v = (np.pad(a, [(0, 0)] * (a.ndim - 2) + [(0, pad), (0, 0)])
            for a in (k, v))
    m = np.full(q.shape[:-1] + (1,), -1e30, np.float32)
    l = np.zeros_like(m)
    acc = np.zeros_like(q)
    for k0 in range(0, S, TILE):        # rows from k0 on reach this tile
        rows = slice(k0, S)
        kt, vt = k[..., k0:k0 + TILE, :], v[..., k0:k0 + TILE, :]
        s = dot(np.zeros(q.shape[:-2] + (S - k0, TILE), np.float32),
                q[..., rows, :], np.swapaxes(kt, -1, -2), **kw) * scale
        col = k0 + np.arange(TILE)
        row = np.arange(k0, S)[:, None]
        s = np.where((col > row) | (col >= S), np.float32(-1e30), s)
        m_new = np.maximum(m[..., rows, :], s.max(-1, keepdims=True))
        corr = np.exp(m[..., rows, :] - m_new)
        p = np.exp(s - m_new)
        m[..., rows, :] = m_new
        l[..., rows, :] = l[..., rows, :] * corr + p.sum(-1, keepdims=True)
        acc[..., rows, :] = dot(acc[..., rows, :] * corr, p, vt, **kw)
    return acc / np.maximum(l, np.float32(1e-30))


def reference(q, k, v):
    q, k, v = (a.astype(np.float64) for a in (q, k, v))
    S, hd = q.shape[-2:]
    s = q @ np.swapaxes(k, -1, -2) / np.sqrt(hd)
    s = np.where(np.tril(np.ones((S, S), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    return (p / p.sum(-1, keepdims=True)) @ v


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(3))


def _outside(got, want):
    """Elements outside ATTN_TOL."""
    return int((np.abs(got - want) > ATTN_TOL["atol"]
                + ATTN_TOL["rtol"] * np.abs(want)).sum())


def test_rna_rounding():
    """Ties go away from zero, the 13 low bits are cleared, and hi + lo
    keeps 22 of the 24 significand bits."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)                 # TF32's step at 1
    for sign in (1, -1):
        x = np.array([sign * (one + ulp / 2)], np.float32)   # a tie
        assert rna_tf32(x)[0] == sign * (one + ulp)
        x = np.array([sign * (one + ulp / 4)], np.float32)
        assert rna_tf32(x)[0] == sign * one
    x = np.random.default_rng(1).standard_normal(4096).astype(np.float32)
    assert not (rna_tf32(x).view(np.uint32) & np.uint32(0x1FFF)).any()
    hi, lo = split(x)
    assert np.all(np.abs((hi.astype(np.float64) + lo) - x)
                  <= np.abs(x) * 2.0 ** -21)


def test_truncating_step():
    """A k step rounds toward zero: the sum's float32 neighbour nearer
    zero, also where round-to-nearest would go up."""
    a = np.zeros((1, 8), np.float32)
    b = np.zeros((8, 1), np.float32)
    a[0, :2], b[:2, 0] = 1.0, (1.0, 2.0 ** -24 * 1.5)
    c = np.zeros((1, 1), np.float32)
    assert mma(c, a, b)[0, 0] == np.float32(1.0)      # RN gives 1 + 2^-23
    assert mma(c, -a, b)[0, 0] == np.float32(-1.0)
    x = np.random.default_rng(2).standard_normal((64, 8)).astype(np.float32)
    y = np.random.default_rng(3).standard_normal((8, 64)).astype(np.float32)
    got = mma(np.zeros((64, 64), np.float32), rna_tf32(x), rna_tf32(y))
    exact = rna_tf32(x).astype(np.float64) @ rna_tf32(y).astype(np.float64)
    assert np.all(np.abs(got) <= np.abs(exact))
    assert np.all(np.abs(exact - got) < np.spacing(np.abs(got)))


@pytest.mark.parametrize("shape", SHAPES)
def test_3xtf32_within_float32_tolerance(shape):
    q, k, v = _qkv(shape)
    want = reference(q, k, v)
    got = kernel_attention(q, k, v)
    assert _outside(got, want) == 0, np.abs(got - want).max()
    np.testing.assert_allclose(got, want, **ATTN_TOL)


@pytest.mark.parametrize("shape", LONG)
def test_one_truncating_chain_misses_it(shape):
    """The split without the fresh accumulators: every k step truncates
    into S or the output directly, and the output's chain runs over the
    whole key range."""
    q, k, v = _qkv(shape)
    want = reference(q, k, v)
    got = kernel_attention(q, k, v, fold=None)
    assert _outside(got, want) > 0
    assert np.abs(got - want).max() > 2 * np.abs(
        kernel_attention(q, k, v) - want).max()


@pytest.mark.parametrize("shape", SHAPES)
def test_one_tf32_product_misses_it(shape):
    q, k, v = _qkv(shape)
    want = reference(q, k, v)
    got = kernel_attention(q, k, v, split_products=False)
    assert _outside(got, want) > got.size // 10
    assert np.abs(got - want).max() > 1e2 * ATTN_TOL["atol"]
