"""The tolerance argument of ``mamba_chunk``'s 3xTF32 products
(``csrc/mamba_scan.cu``), emulated on the CPU in the kernel's order and
with its rounding, for one (chunk, head):

- cum in sequence in float32 (dt * a rounded, then added), the state
  weights exp(cum_last - cum) * dt and the causal weights
  W[i, j] = exp(cum_i - cum_j) * dt_j, each product rounded, W masked to
  j <= i before the exp; where cum does not increase (dt a <= 0), W off
  the diagonal 16 x 16 blocks is factored as the kernel factors it,
  exp(cum_i - cum_r) * (exp(cum_r - cum_j) * dt_j) with r the last step
  of j's 16-step tile;
- C B^T, (C B^T * W) x and (B * w_state)^T x on the tensor cores: each
  operand split into TF32 hi + lo (``cvt.rna``'s rounding, which the
  kernel forms in integer arithmetic), a.b taken as hi.lo +
  lo.hi + hi.hi with the small products first, each ``mma.sync`` k step
  of 8 truncating its float32 sum, a fresh accumulator every two k steps
  folded in by a round-to-nearest add (``test_torch_tf32_split.dot``);
  L, N and P zero-padded as the kernel pads them (16, 8, 8). A zero
  block adds exact zeros, so the kernel's skipped blocks above the
  diagonal change nothing here.

So emulated, y and the state stay within the reference's 1e-4 and cum
and the decay within its 1e-5 (``tests/test_kernels.py``; chip_smoke.py
``MAMBA_YS`` and ``MAMBA_CUM``) of a float64 evaluation, at zamba2-7b's
(L 128, N 64, P 64), the reference test's shapes, the a = -50 case and
an increasing cum (a > 0).
One TF32 product a step does not stay within them, which is why the
kernel splits. Inputs are seeded numpy normals, as in the card's check."""
import numpy as np
import pytest

from test_torch_tf32_split import dot, rna_tf32, split

YS = dict(rtol=1e-4, atol=1e-4)         # chip_smoke.py MAMBA_YS
CUM = dict(rtol=1e-5, atol=1e-5)        # chip_smoke.py MAMBA_CUM
# (L, N, P): zamba2-7b's full width and the (L, N, P) of chip_smoke.py's
# MAMBA_EDGE
SHAPES = [(128, 64, 64), (8, 4, 4), (16, 8, 8), (96, 16, 8)]
A50 = (-50.0, float(np.log1p(np.exp(3.0))))   # a, dt: the decay overflows


def _inputs(L, N, P, seed=0, a=None, dt=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((L, P)).astype(np.float32)
    bm = rng.standard_normal((L, N)).astype(np.float32)
    cm = rng.standard_normal((L, N)).astype(np.float32)
    dtv = (np.log1p(np.exp(rng.standard_normal(L))).astype(np.float32)
           if dt is None else np.full(L, dt, np.float32))
    av = np.float32(-abs(rng.standard_normal()) - 0.1 if a is None else a)
    return x, bm, cm, dtv, av


def _pad(a, rows, cols):
    return np.pad(a, [(0, rows - a.shape[0]), (0, cols - a.shape[1])])


def kernel_chunk(x, bm, cm, dt, a, split_products=True):
    """(y, state, decay, cum) of one (chunk, head) as the kernel forms
    them, in float32."""
    L, P = x.shape
    N = bm.shape[1]
    Lp, Np, Pp = -(-L // 16) * 16, -(-N // 8) * 8, -(-P // 8) * 8
    cum = np.zeros(Lp, np.float32)
    run = np.float32(0.0)
    for l in range(L):
        da = np.float32(dt[l] * a)
        run = da if l == 0 else np.float32(run + da)
        cum[l] = run
    dtp = np.pad(dt, (0, Lp - L))
    last = cum[L - 1]
    ws = np.where(np.arange(Lp) < L,
                  np.exp(last - cum).astype(np.float32) * dtp, np.float32(0))
    xp, bp, cp = _pad(x, Lp, Pp), _pad(bm, Lp, Np), _pad(cm, Lp, Np)
    kw = dict(split_products=split_products)
    cb = dot(np.zeros((Lp, Lp), np.float32), cp, bp.T.copy(), **kw)
    i, j = np.arange(Lp)[:, None], np.arange(Lp)[None, :]
    live = (j <= i) & (i < L)
    diff = np.where(live, cum[:, None] - cum[None, :], np.float32(0))
    w = np.where(live, np.exp(diff).astype(np.float32) * dtp[None, :],
                 np.float32(0))
    if np.all(dt[:L] * a <= 0):             # cum does not increase: factored
        r = np.minimum(16 * (np.arange(Lp) // 16) + 15, L - 1)
        cd = np.exp(cum[r] - cum).astype(np.float32) * dtp
        below = live & (j // 16 < i // 16)
        rdiff = np.where(below, cum[:, None] - cum[r][None, :], np.float32(0))
        rf = np.exp(rdiff).astype(np.float32)
        w = np.where(below, rf * cd[None, :], w)
    y = dot(np.zeros((Lp, Pp), np.float32), (cb * w).astype(np.float32), xp,
            **kw)
    bw = (bp * ws[:, None]).astype(np.float32)
    st = dot(np.zeros((Np, Pp), np.float32), bw.T.copy(), xp, **kw)
    return y[:L, :P], st[:N, :P], np.exp(last), cum[:L]


def reference(x, bm, cm, dt, a):
    """The same function in float64."""
    x, bm, cm, dt = (v.astype(np.float64) for v in (x, bm, cm, dt))
    L = x.shape[0]
    cum = np.cumsum(dt * np.float64(a))
    diff = cum[:, None] - cum[None, :]
    causal = np.tril(np.ones((L, L), bool))
    w = np.where(causal, np.exp(np.where(causal, diff, 0.0)) * dt[None, :],
                 0.0)
    y = ((cm @ bm.T) * w) @ x
    ws = np.exp(cum[-1] - cum) * dt
    return y, (bm * ws[:, None]).T @ x, np.exp(cum[-1]), cum


def _outside(got, want, tol):
    return int((np.abs(got - want) > tol["atol"]
                + tol["rtol"] * np.abs(want)).sum())


def _check(got, want):
    for g in got:
        assert np.isfinite(g).all()
    for g, w, tol in zip(got, want, (YS, YS, CUM, CUM)):
        assert _outside(np.asarray(g, np.float64), w, tol) == 0, \
            np.abs(np.asarray(g, np.float64) - w).max()


@pytest.mark.parametrize("shape", SHAPES)
def test_3xtf32_within_the_reference_tolerance(shape):
    args = _inputs(*shape)
    _check(kernel_chunk(*args), reference(*args))


def test_3xtf32_large_decay_has_no_nan():
    """a = -50, dt = softplus(3): cum falls by ~150 a step, so exp(cum_i -
    cum_j) above the diagonal is inf; masked before the exp, every output
    stays finite and within the tolerance."""
    args = _inputs(128, 64, 64, seed=3, a=A50[0], dt=A50[1])
    got = kernel_chunk(*args)
    _check(got, reference(*args))
    assert got[2] == 0.0                      # exp(cum_last) underflows


def test_3xtf32_increasing_cum():
    """a > 0: cum increases, so the kernel takes exp(cum_i - cum_j) on
    every block (the factors could overflow); still within tolerance."""
    args = _inputs(128, 64, 64, seed=6, a=0.002)
    _check(kernel_chunk(*args), reference(*args))


@pytest.mark.parametrize("shape", [(128, 64, 64), (96, 16, 8)])
def test_one_tf32_product_misses_it(shape):
    """One TF32 product a step (no lo terms): y leaves the 1e-4
    tolerance, and its error is far above the split's."""
    args = _inputs(*shape)
    want = reference(*args)
    one = kernel_chunk(*args, split_products=False)
    three = kernel_chunk(*args)
    assert _outside(one[0], want[0], YS) > 0
    assert np.abs(one[0] - want[0]).max() > 10 * np.abs(
        three[0] - want[0]).max()


def test_bfloat16_x_is_exact_in_tf32():
    """A bfloat16 x has 8 significant bits: its TF32 hi is itself and its
    lo is 0, so the kernel's product with it adds exact zeros."""
    x = np.random.default_rng(5).standard_normal(4096).astype(np.float32)
    xb = (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)
    hi, lo = split(xb)
    np.testing.assert_array_equal(hi, xb)
    assert not lo.any()
    np.testing.assert_array_equal(rna_tf32(xb), xb)
