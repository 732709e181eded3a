"""The port's convex problems (``data/convex.py``) and the Fig 3/4 data
(``data/synthetic.py``) against the reference's, on the same inputs.

The data are numpy draws from the same seeds: bit-equal. Each loss and
its gradient (autograd against ``jax.grad``) agrees at float32 within
rtol 1e-6; a gradient entry also within atol 1e-6 of the gradient's
largest entry (an entry that is a sum of products carries rounding of the
order of the sum's largest terms, and the two frameworks sum in another
order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import convex as jconvex
from repro.data import synthetic as jsyn
from repro_torch.core.reference import grad_of
from repro_torch.data import convex as tconvex
from repro_torch.data import synthetic as tsyn

VAL_TOL = dict(rtol=1e-6)


def points(d, n=4, seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(d) * scale).astype(np.float32) for _ in range(n)]


def assert_losses_agree(jlosses, tlosses, ws):
    assert len(jlosses) == len(tlosses)
    for jf, tf in zip(jlosses, tlosses):
        jg, tg = jax.grad(jf), grad_of(tf)
        for w in ws:
            np.testing.assert_allclose(float(tf(torch.tensor(w))),
                                       float(jf(jnp.asarray(w))), **VAL_TOL)
            want = np.asarray(jg(jnp.asarray(w)))
            np.testing.assert_allclose(tg(torch.tensor(w)).numpy(), want,
                                       rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())


def test_beck_teboulle_losses():
    """Inside and outside both sets, on their boundaries (where max(., 0)
    ties: both frameworks split the gradient evenly) and at the disk's
    centre (the 1e-30 under the sqrt)."""
    ws = points(2, scale=1.5) + [np.array(p, np.float32) for p in
                                 ((1.5, 0.8), (0.0, 0.0), (0.0, 1.0),
                                  (0.3, -0.2), (1.0, 1.0))]
    assert_losses_agree(jconvex.beck_teboulle_losses(),
                        tconvex.beck_teboulle_losses(), ws)


@pytest.mark.parametrize("power", [1, 2])
def test_regression_data_and_losses(power):
    jp = jconvex.make_overparam_regression(n=20, d=60, m=3, power=power,
                                           seed=4)
    tp = tconvex.make_overparam_regression(n=20, d=60, m=3, power=power,
                                           seed=4)
    assert tp.m == jp.m == 3
    for a, b in zip(jp.xs + jp.ys, tp.xs + tp.ys):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ws = points(60, seed=1, scale=0.3)
    assert_losses_agree(jp.local_losses(), tp.local_losses("cpu"), ws)
    assert_losses_agree([jp.global_loss()], [tp.global_loss("cpu")], ws)


def test_full_size_regression_is_bit_equal():
    """Fig 2b's (62, 2000) problem: the same float64 draws."""
    jp = jconvex.make_overparam_regression(n=62, d=2000, m=2, seed=0)
    tp = tconvex.make_overparam_regression(n=62, d=2000, m=2, seed=0)
    for a, b in zip(jp.xs + jp.ys, tp.xs + tp.ys):
        np.testing.assert_array_equal(a, b)


def test_quadratics_and_distance_to_intersection():
    """The reference's own draws fed into the port (``quadratics_from``):
    the same losses, and the same distance to the intersection (rtol
    1e-5: an SVD in each framework)."""
    jlosses, w_star, mats = jconvex.random_intersecting_quadratics(
        jax.random.PRNGKey(3), 3, 12, 3)
    tw = torch.tensor(np.asarray(w_star))
    tmats = [torch.tensor(np.asarray(a)) for a in mats]
    ws = points(12, seed=2, scale=3.0)
    assert_losses_agree(jlosses, tconvex.quadratics_from(tw, tmats), ws)
    for w in ws:
        np.testing.assert_allclose(
            float(tconvex.distance_to_intersection(torch.tensor(w), tmats,
                                                   tw)),
            float(jconvex.distance_to_intersection(jnp.asarray(w), mats,
                                                   w_star)), rtol=1e-5)
    # the port's own draw has the same structure: w* minimizes every f_i
    gen = torch.Generator().manual_seed(0)
    losses, ws_, ms = tconvex.random_intersecting_quadratics(
        gen, 3, 12, 3, device="cpu")
    assert [tuple(a.shape) for a in ms] == [(3, 12)] * 3
    assert all(float(f(ws_)) == 0.0 for f in losses)
    assert float(tconvex.distance_to_intersection(ws_, ms, ws_)) == 0.0


def test_fig3_data_and_losses():
    """Fig 3's classification set, its pooled variant and the affine
    softmax cross-entropy losses of ``benchmarks/fig3_intersection.py``,
    at a reduced n (the data bit-equal; losses at rtol 1e-6)."""
    jx, jl = jsyn.gaussian_classification(n=60, side=28, seed=0)
    tx, tl = tsyn.gaussian_classification(n=60, side=28, seed=0)
    np.testing.assert_array_equal(jx, tx)
    np.testing.assert_array_equal(jl, tl)
    assert tx.dtype == np.float32 and tl.dtype == np.int32
    np.testing.assert_array_equal(jsyn.maxpool2x2_twice(jx),
                                  tsyn.maxpool2x2_twice(tx))
    from benchmarks.fig3_intersection import make_losses
    x = tsyn.maxpool2x2_twice(tx / np.abs(tx).max())
    jlosses, jdim = make_losses(x, tl, m=3)
    tlosses, tdim = tconvex.affine_softmax_losses(x, tl, m=3, device="cpu")
    assert tdim == jdim == 49 * 10 + 10
    assert_losses_agree(jlosses, tlosses, points(tdim, n=2, seed=5,
                                                 scale=0.1))


def test_fixed_group_batches():
    np.testing.assert_array_equal(
        jsyn.fixed_group_batches(1024, 64, 4, 4, seed=0)["tokens"],
        tsyn.fixed_group_batches(1024, 64, 4, 4, seed=0)["tokens"])
