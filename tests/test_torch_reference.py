"""``run_alg1`` of the port against the reference's on the paper's convex
problems (Beck–Teboulle, over-parameterized regression at powers 1 and 2,
the reference's random quadratics), in fixed-T and threshold (T_i = inf)
mode, and the figures' quantities at reduced rounds.

Tolerances: the per-round global gradient norm ||grad f|| and f within
rtol 1e-4 and an atol of 1e-6 times their first-round values (float32
gradients are formed from residuals that cancel, so near the solution
each carries rounding of the order of 1e-7 of the problem's scale, which
the rounds carry forward), the final iterate within rtol 1e-4 / atol
1e-6. Threshold inner counts are equal per node and round (no run here
has a stopping norm so close to eps that the two frameworks' rounding
could move it across), and ``rounds_to`` results are equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reference as jref
from repro.core import theory as jth
from repro.data import convex as jconvex
from repro_torch.core import reference as tref
from repro_torch.core import theory as tth
from repro_torch.data import convex as tconvex

RTOL = 1e-4


def both(jlosses, tlosses, w0, **kw):
    j = jref.run_alg1(jlosses, jnp.asarray(w0), **kw)
    t = tref.run_alg1(tlosses, torch.tensor(w0), device="cpu", **kw)
    return j, t


def assert_runs_agree(j, t):
    assert len(t["gsq"]) == len(j["gsq"])
    for key, scale in (("gsq", np.sqrt), ("f", np.asarray)):
        jv, tv = scale(np.asarray(j[key])), scale(np.asarray(t[key]))
        np.testing.assert_allclose(tv, jv, rtol=RTOL, atol=1e-6 * jv[0],
                                   err_msg=key)
    np.testing.assert_allclose(t["w"].numpy(), np.asarray(j["w"]),
                               rtol=RTOL, atol=1e-6)
    assert t["inner"] == j["inner"]


def test_beck_teboulle_fixed_t():
    j, t = both(jconvex.beck_teboulle_losses(),
                tconvex.beck_teboulle_losses(), [1.5, 0.8], lr=0.4, T=10,
                rounds=200)
    assert_runs_agree(j, t)


@pytest.mark.parametrize("T", [1, 10])
def test_regression_fixed_t(T):
    jp = jconvex.make_overparam_regression(n=20, d=200, m=2, seed=0)
    tp = tconvex.make_overparam_regression(n=20, d=200, m=2, seed=0)
    j, t = both(jp.local_losses(), tp.local_losses("cpu"), np.zeros(200,
                np.float32), lr=2.0, T=T, rounds=40)
    assert_runs_agree(j, t)
    for tol in (1e-4, 1e-8):
        assert tref.rounds_to(t["gsq"], tol) == jref.rounds_to(j["gsq"], tol)


@pytest.mark.parametrize("power,lr,eps", [
    (1, 2.0, 1e-8), (1, 2.0, 1e-6), (2, 0.5, 1e-8), (2, 0.5, 1e-6)])
def test_regression_threshold(power, lr, eps):
    """T_i = inf: every node's count per round equal to the reference's."""
    jp = jconvex.make_overparam_regression(n=20, d=200, m=2, power=power,
                                           seed=0)
    tp = tconvex.make_overparam_regression(n=20, d=200, m=2, power=power,
                                           seed=0)
    w0 = np.full(200, 0.3, np.float32)
    j, t = both(jp.local_losses(), tp.local_losses("cpu"), w0, lr=lr,
                T=None, rounds=4, threshold=eps)
    assert_runs_agree(j, t)


def test_threshold_cap_and_stop_below():
    """max_inner caps a node's count; stop_below ends the run early at the
    same round in both."""
    jp = jconvex.make_overparam_regression(n=20, d=200, m=2, seed=0)
    tp = tconvex.make_overparam_regression(n=20, d=200, m=2, seed=0)
    w0 = np.zeros(200, np.float32)
    j, t = both(jp.local_losses(), tp.local_losses("cpu"), w0, lr=2.0,
                T=None, rounds=6, threshold=1e-20, max_inner=7)
    assert t["inner"] == j["inner"] == [[7, 7]] * 6
    j, t = both(jp.local_losses(), tp.local_losses("cpu"), w0, lr=2.0,
                T=10, rounds=40, stop_below=1e-6)
    assert len(t["gsq"]) == len(j["gsq"]) < 40
    assert_runs_agree(j, t)


def test_quadratics_and_lemma1():
    """The reference's random quadratics, fed into the port: the same
    iterates, and d(x_n, S) non-increasing (Lemma 1)."""
    import jax

    jlosses, w_star, mats = jconvex.random_intersecting_quadratics(
        jax.random.PRNGKey(1), 3, 12, 3)
    tw = torch.tensor(np.asarray(w_star))
    tmats = [torch.tensor(np.asarray(a)) for a in mats]
    L = max(float(torch.linalg.matrix_norm(a, 2)) ** 2 for a in tmats)
    w0 = (np.random.RandomState(2).randn(12) * 3).astype(np.float32)
    j, t = both(jlosses, tconvex.quadratics_from(tw, tmats), w0, lr=1.0 / L,
                T=5, rounds=10)
    assert_runs_agree(j, t)
    w, d_prev = torch.tensor(w0), None
    for _ in range(4):
        w = tref.run_alg1(tconvex.quadratics_from(tw, tmats), w, lr=1.0 / L,
                          T=5, rounds=1, device="cpu")["w"]
        d = float(tconvex.distance_to_intersection(w, tmats, tw))
        assert d_prev is None or d <= d_prev + 1e-6
        d_prev = d


def test_fig2a_quantities():
    """Fig 2a at 300 of its 2000 rounds: the tail's log-log slope (rtol
    1e-3) and the last residual."""
    n = np.arange(1, 301)
    slopes = []
    j, t = both(jconvex.beck_teboulle_losses(),
                tconvex.beck_teboulle_losses(), [1.5, 0.8], lr=0.4, T=10,
                rounds=300)
    for out in (j, t):
        gsq = np.asarray(out["gsq"])
        slopes.append(np.polyfit(np.log(n[30:]), np.log(gsq[30:]), 1)[0])
    np.testing.assert_allclose(slopes[1], slopes[0], rtol=1e-3)
    assert slopes[1] < -0.5


def test_fig2b_quantities():
    """Fig 2b at 30 of its 150 rounds: rounds to 1e-7 for T = 1, 10, 100
    and threshold 1e-8, equal."""
    jp = jconvex.make_overparam_regression(n=62, d=2000, m=2, seed=0)
    tp = tconvex.make_overparam_regression(n=62, d=2000, m=2, seed=0)
    w0 = np.zeros(2000, np.float32)
    for T, thr in ((1, None), (10, None), (100, None), (None, 1e-8)):
        j, t = both(jp.local_losses(), tp.local_losses("cpu"), w0, lr=2.0,
                    T=T, rounds=30 if T != 100 else 10, threshold=thr,
                    stop_below=1e-13)
        assert_runs_agree(j, t)
        assert (tref.rounds_to(t["gsq"], 1e-7)
                == jref.rounds_to(j["gsq"], 1e-7))


@pytest.mark.parametrize("name,power,lr", [("quadratic", 1, 1.0),
                                           ("quartic", 2, 0.5)])
def test_fig5_decay_fit(name, power, lr):
    """Fig 5's local decay detection at 2 of its 12 rounds: node 0's
    T=1000 trajectory, trimmed at the float32 floor as the figure does,
    fits the same decay kind (linear for the quadratic, sub-linear for
    the quartic) with parameters within rtol 1e-3."""
    jp = jconvex.make_overparam_regression(n=20, d=400, m=2, power=power,
                                           seed=0)
    tp = tconvex.make_overparam_regression(n=20, d=400, m=2, power=power,
                                           seed=0)
    w0 = np.full(400, 0.3, np.float32)
    j, t = both(jp.local_losses(), tp.local_losses("cpu"), w0, lr=lr,
                T=1000, rounds=2, record_local_traj=True)
    fits = []
    for out, th in ((j, jth), (t, tth)):
        traj = np.asarray(out["local_traj"][:1000])
        traj = traj[traj > traj[0] * 1e-10][:200]
        fits.append(th.fit_decay(traj))
    assert fits[1].kind == fits[0].kind == {"quadratic": "linear",
                                            "quartic": "sublinear"}[name]
    np.testing.assert_allclose([fits[1].beta, fits[1].a],
                               [fits[0].beta, fits[0].a], rtol=1e-3)


def test_fig67_rates():
    """Fig 6-7 at 8 of its 40 rounds: the per-round contraction factor for
    m = 2, 5, 10 (rtol 1e-3), increasing in m."""
    rates = []
    for m in (2, 5, 10):
        jp = jconvex.make_overparam_regression(n=60, d=1200, m=m, seed=0)
        tp = tconvex.make_overparam_regression(n=60, d=1200, m=m, seed=0)
        j, t = both(jp.local_losses(), tp.local_losses("cpu"),
                    np.zeros(1200, np.float32), lr=2.0, T=20, rounds=8)
        r = [(g[-1] / g[0]) ** (1.0 / (len(g) - 1))
             for g in (j["gsq"], t["gsq"])]
        np.testing.assert_allclose(r[1], r[0], rtol=1e-3)
        rates.append(r[1])
    assert rates[0] < rates[1] < rates[2]


@pytest.mark.parametrize("eps", [1e6, 1e-2, 1e-6])
def test_local_threshold_counts(eps):
    """One node's T_i = inf run on each Beck–Teboulle loss: the same count
    as the reference's ``while_loop`` (0 where the start is already at or
    below eps) and the same iterate."""
    w0 = np.array([1.5, 0.8], np.float32)
    for jf, tf in zip(jconvex.beck_teboulle_losses(),
                      tconvex.beck_teboulle_losses()):
        jw, jn = jref.make_local_threshold(jf, 0.4, eps, 1000)(
            jnp.asarray(w0))
        tw, tn = tref.make_local_threshold(tf, 0.4, eps, 1000)(
            torch.tensor(w0))
        print(f"eps {eps:g}: {tn} steps (reference {int(jn)})")
        assert tn == int(jn)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=RTOL,
                                   atol=1e-6)
    if eps == 1e6:
        assert tn == 0
