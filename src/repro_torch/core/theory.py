"""Quantitative theory from the paper.

* Lemma 1 decrement bound, Theorem 3 linear rate rho.
* Sec 4 trade-off: cost-optimal number of local steps T* for
  - linearly convergent local GD  h(t) = beta^t     (Lambert-W closed form)
  - sub-linearly convergent       h(t) = (1+a t)^-beta (algebraic root)
* On-the-fly detection of the local decay order from a gradient-norm
  trajectory (used by core.controller.AdaptiveT).

Everything is plain numpy-compatible scalar math (host side). A copy of
``repro/core/theory.py``: the port imports nothing of the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Rates
# ---------------------------------------------------------------------------


def alpha(eta: float, L: float) -> float:
    """alpha_i = eta_i (2/L_i - eta_i) from Lemma 1; > 0 iff eta < 2/L."""
    return eta * (2.0 / L - eta)


def theorem3_rho(etas, Ls, mus, c: float) -> float:
    """Linear rate rho = sqrt(1 - c^{-1} min_i alpha_i mu_i^2)."""
    vals = [min(alpha(e, L) * mu ** 2, 1.0)
            for e, L, mu in zip(etas, Ls, mus)]
    return math.sqrt(max(1.0 - min(vals) / c, 0.0))


# ---------------------------------------------------------------------------
# Lambert W, negative real branch W_- on [-1/e, 0)
# ---------------------------------------------------------------------------


def lambert_w_neg(x: float, iters: int = 64) -> float:
    """W_-(x): the branch with W <= -1, solving W e^W = x for x in [-1/e, 0)."""
    if not (-1.0 / math.e <= x < 0.0):
        raise ValueError(f"W_- domain is [-1/e, 0), got {x}")
    if x == -1.0 / math.e:
        return -1.0
    # asymptotic init: W_- = log(-x) - log(-log(-x))
    lx = math.log(-x)
    w = lx - math.log(-lx) if lx < -1.0 else -1.5
    for _ in range(iters):  # Halley
        ew = math.exp(w)
        f = w * ew - x
        denom = ew * (w + 1.0) - (w + 2.0) * f / (2.0 * w + 2.0)
        if denom == 0.0:
            break
        w_new = w - f / denom
        if abs(w_new - w) < 1e-15:
            w = w_new
            break
        w = w_new
    return w


# ---------------------------------------------------------------------------
# Cost model (Sec 4):  C_total <= K * (1 + r T) / sum_{t<T} h(t)
# ---------------------------------------------------------------------------


def cost_bound(T: int, r: float, h) -> float:
    s = sum(h(t) for t in range(int(T)))
    return (1.0 + r * T) / max(s, 1e-300)


def t_star_linear(beta: float, r: float) -> float:
    """Exact T* for h(t)=beta^t via the paper's Lambert-W formula."""
    if not (0.0 < beta < 1.0):
        raise ValueError(beta)
    arg = -math.exp(-1.0) * beta ** (1.0 / r)
    if arg == 0.0:  # beta^(1/r) underflowed (r very small)
        return t_star_linear_asymptotic(beta, r)
    arg = max(arg, -1.0 / math.e)  # clamp fp error
    w = lambert_w_neg(arg)
    return (1.0 + w) / math.log(beta) - 1.0 / r


def t_star_linear_asymptotic(beta: float, r: float) -> float:
    """T* ~ log(1 + log(1/beta)/r) / log(1/beta) for r << 1.

    NOTE (reproduction erratum): the paper prints the asymptotic as
    ``log(1 + log(1/beta)/r) + o(1)``, but expanding its own exact
    Lambert-W expression,
        1 + W^-(-e^{-1} beta^{1/r}) = (1/r) log(beta)
                                      - log(1 + log(1/beta)/r) + o(1),
    so the 1/log(beta) prefactor does NOT cancel and
        T* = log(1 + log(1/beta)/r) / log(1/beta) + o(1).
    Brute-force minimization of the cost bound confirms the corrected
    form (see tests/test_theory.py and benchmarks/fig5_quartic.py)."""
    return math.log(1.0 + math.log(1.0 / beta) / r) / math.log(1.0 / beta)


def t_star_sublinear(a: float, beta: float, r: float,
                     t_max: float = 1e12) -> float:
    """T* for h(t)=(1+at)^-beta: unique positive root of
    r((1+aT)^beta - 1) - a(beta + beta r T - 1) = 0  (paper Eq. 6)."""
    if beta <= 1.0 or a <= 0.0:
        raise ValueError((a, beta))

    def g(T):
        return r * ((1.0 + a * T) ** beta - 1.0) - a * (beta + beta * r * T - 1.0)

    lo, hi = 0.0, 1.0
    while g(hi) < 0.0 and hi < t_max:
        hi *= 2.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if g(mid) < 0.0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def t_star_sublinear_asymptotic(a: float, beta: float, r: float) -> float:
    """T* ~ ((a(beta-1)/r)^{1/beta} - 1)/a for r << 1."""
    return ((a * (beta - 1.0) / r) ** (1.0 / beta) - 1.0) / a


def t_star_numeric(r: float, h, t_max: int = 1_000_000) -> int:
    """Brute-force argmin of the cost bound (for validating the formulas)."""
    best_t, best = 1, cost_bound(1, r, h)
    t, s = 1, h(0)
    cost_prev = best
    while t < t_max:
        s += h(t)
        t += 1
        c = (1.0 + r * t) / s
        if c < best:
            best, best_t = c, t
        if c > 4.0 * best and t > 4 * best_t:
            break
    return best_t


def quartic_h_params(l: int = 2) -> Tuple[float, float]:
    """For local loss ~ x^{2l}: h(t) ~ (1+at)^-beta with a = 2l-2,
    beta=(2l-1)/(2l-2) (paper Sec 4)."""
    a = 2.0 * l - 2.0
    beta = (2.0 * l - 1.0) / (2.0 * l - 2.0)
    return a, beta


# ---------------------------------------------------------------------------
# Decay-order detection (for the adaptive controller)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DecayFit:
    kind: str          # "linear" | "sublinear"
    beta: float        # decay base (linear) or exponent (sublinear)
    a: float           # sublinear scale (1 for linear)
    r2_linear: float
    r2_sublinear: float


def _lstsq_r2(x: np.ndarray, y: np.ndarray) -> Tuple[float, float, float]:
    A = np.stack([x, np.ones_like(x)], axis=1)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    pred = A @ coef
    ss_res = float(np.sum((y - pred) ** 2))
    ss_tot = float(np.sum((y - np.mean(y)) ** 2)) or 1e-30
    return float(coef[0]), float(coef[1]), 1.0 - ss_res / ss_tot


def fit_decay(grad_sq_traj: Sequence[float]) -> Optional[DecayFit]:
    """Fit h(t) = g²(t)/g²(0) to linear (beta^t) vs sublinear (1+at)^-beta.

    Returns None if the trajectory is too short or degenerate.
    """
    g = np.asarray(grad_sq_traj, dtype=np.float64)
    g = g[np.isfinite(g) & (g > 0)]
    if g.size < 4 or not np.isfinite(g).all():
        return None
    # a clearly diverging trajectory has no decay order (noisy real-model
    # trajectories may end slightly above where they started — keep those)
    if g[-1] > 10.0 * g[0]:
        return None
    h = g / g[0]
    t = np.arange(g.size, dtype=np.float64)
    # linear: log h = t log beta
    slope_l, _, r2_l = _lstsq_r2(t, np.log(h))
    beta_lin = float(np.exp(min(slope_l, -1e-12)))
    # sublinear: log h = -beta log(1+a t); fit with a from curvature search
    best = (-np.inf, 1.0, 1.0)
    for a in (0.1, 0.3, 1.0, 2.0, 4.0, 10.0):
        slope_s, _, r2_s = _lstsq_r2(np.log1p(a * t), np.log(h))
        if r2_s > best[0]:
            best = (r2_s, a, max(-slope_s, 1.0 + 1e-6))
    r2_s, a_s, beta_s = best
    if not (math.isfinite(r2_l) or math.isfinite(r2_s)):
        return None
    if r2_l >= r2_s or not math.isfinite(r2_s):
        return DecayFit("linear", beta_lin, 1.0, r2_l, r2_s)
    return DecayFit("sublinear", max(beta_s, 1.0 + 1e-6), a_s, r2_l, r2_s)


def t_star_from_fit(fit: DecayFit, r: float) -> float:
    if fit.kind == "linear":
        return max(t_star_linear(min(max(fit.beta, 1e-9), 1 - 1e-9), r), 1.0)
    return max(t_star_sublinear(fit.a, fit.beta, r), 1.0)
