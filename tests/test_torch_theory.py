"""The port's copies of ``core/theory.py`` and ``core/controller.py``
against the reference's, on the inputs of ``tests/test_theory.py``.
Both sides are the same numpy and math-module code, so every result is
exactly equal."""
import math

import numpy as np
import pytest

from repro import comm as jcomm
from repro.core import controller as jctl
from repro.core import theory as jth
from repro_torch import comm
from repro_torch.core import controller as tctl
from repro_torch.core import theory as tth

LIN = [beta ** t for beta in (0.8,) for t in range(20)]
SUB = [(1 + 2.0 * t) ** (-1.5) for t in range(40)]
NOISY = list(np.abs(np.random.RandomState(0).randn(12)) + 0.5)


@pytest.mark.parametrize("x", [-1.0 / math.e, -0.3, -0.1, -1e-3, -1e-12])
def test_lambert_w_neg(x):
    assert tth.lambert_w_neg(x) == jth.lambert_w_neg(x)


def test_lambert_w_neg_domain():
    for mod in (jth, tth):
        with pytest.raises(ValueError):
            mod.lambert_w_neg(0.5)


@pytest.mark.parametrize("beta", [0.5, 0.8, 0.9, 0.95])
@pytest.mark.parametrize("r", [0.1, 0.01, 0.001, 1e-5])
def test_t_star_linear(beta, r):
    assert tth.t_star_linear(beta, r) == jth.t_star_linear(beta, r)
    assert (tth.t_star_linear_asymptotic(beta, r)
            == jth.t_star_linear_asymptotic(beta, r))
    h = lambda t: beta ** t
    assert tth.cost_bound(7, r, h) == jth.cost_bound(7, r, h)


@pytest.mark.parametrize("a,beta", [(2.0, 1.5), (1.0, 2.0), (4.0, 1.2)])
@pytest.mark.parametrize("r", [0.01, 0.001, 1e-4, 1e-6])
def test_t_star_sublinear(a, beta, r):
    assert tth.t_star_sublinear(a, beta, r) == jth.t_star_sublinear(a, beta, r)
    assert (tth.t_star_sublinear_asymptotic(a, beta, r)
            == jth.t_star_sublinear_asymptotic(a, beta, r))


@pytest.mark.parametrize("r,h", [
    (0.1, lambda t: 0.5 ** t), (0.001, lambda t: 0.95 ** t),
    (0.001, lambda t: (1.0 + 2.0 * t) ** -1.5)])
def test_t_star_numeric(r, h):
    assert tth.t_star_numeric(r, h, 100_000) == jth.t_star_numeric(r, h,
                                                                   100_000)


def test_rates_and_quartic_params():
    for l in (2, 3):
        assert tth.quartic_h_params(l) == jth.quartic_h_params(l)
    for eta, L in ((0.5, 2.0), (1.5, 2.0)):
        assert tth.alpha(eta, L) == jth.alpha(eta, L)
    for mus in ([0.5], [0.9], [0.3, 0.7]):
        args = ([0.1] * len(mus), [1.0] * len(mus), mus)
        assert (tth.theorem3_rho(*args, c=2.0)
                == jth.theorem3_rho(*args, c=2.0))


@pytest.mark.parametrize("traj", [LIN, SUB, NOISY, [1.0], [0.0, 0.0, 0.0]],
                         ids=["linear", "sublinear", "noisy", "short",
                              "zero"])
def test_fit_decay_and_t_star_from_fit(traj):
    jf, tf = jth.fit_decay(traj), tth.fit_decay(traj)
    if jf is None:
        assert tf is None
        return
    assert (tf.kind, tf.beta, tf.a, tf.r2_linear, tf.r2_sublinear) == \
        (jf.kind, jf.beta, jf.a, jf.r2_linear, jf.r2_sublinear)
    for r in (0.01, 1e-4):
        assert tth.t_star_from_fit(tf, r) == jth.t_star_from_fit(jf, r)


@pytest.mark.parametrize("kw", [dict(r=0.01, ema=0.0), dict(r=1e-12, t_max=50),
                                dict(r=0.3)])
def test_adaptive_t_matches_reference(kw):
    j, t = jctl.AdaptiveT(**kw), tctl.AdaptiveT(**kw)
    for traj in (LIN, SUB, NOISY, [1.0], LIN[::-1]):
        assert t.update(traj) == j.update(traj)
    assert len(t.history) == len(j.history)


def test_adaptive_t_from_exchange_matches_reference():
    """r priced from each package's exchange: the same wire bytes, so the
    same r, for the params-only and the moment-stream payloads."""
    for topo, codec, mcodec in (("server", "fp32", "fp32"),
                                ("ring", "int8", "bf16"),
                                ("gossip", "fp16", "fp32")):
        jx = jcomm.get_exchange(topo, codec, 4, moment_codec=mcodec)
        tx = comm.get_exchange(topo, codec, 4, moment_codec=mcodec)
        for sizes in (None, {"m": 1000, "v": 1000}):
            j = jctl.AdaptiveT.from_exchange(1e-3, jx, 1000, sizes)
            t = tctl.AdaptiveT.from_exchange(1e-3, tx, 1000, sizes)
            assert t.r == j.r
    with pytest.raises(ValueError, match="non-positive"):
        tctl.AdaptiveT.from_exchange(1e-3, comm.get_exchange("none", "fp32",
                                                             4), 1000)


def test_online_t_matches_reference():
    kw = dict(r=0.05)
    j, t = jctl.OnlineT(**kw), tctl.OnlineT(**kw)
    rng = np.random.RandomState(2)
    for n in range(8):
        tele = dict(t_used=5 + n, local_s=0.01 * (n + 1), exchange_s=0.02,
                    consensus_pre=float(rng.rand() + 0.1),
                    consensus_post=float(rng.rand() * 0.1),
                    codec_err=float(rng.rand() * 1e-3))
        traj = SUB if n % 2 else LIN
        assert t.update(traj, **tele) == j.update(traj, **tele)
    assert t.history == j.history
