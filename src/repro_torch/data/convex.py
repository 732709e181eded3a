"""The paper's convex experiment problems (counterpart of
``repro/data/convex.py``).

* Beck–Teboulle synthetic feasibility (Sec 2.3.1): two losses on R^2
  whose optimal sets touch only at the origin.
* Over-parameterized least squares (Sec 2.3.2): n samples, d >> n
  features split over m nodes; every node interpolates (linear rate).
* The quartic variant (Sec 4): residual^4, sub-linear local GD.
* Random intersecting quadratics (the property tests).
* The Fig-3 classification losses (``benchmarks/fig3_intersection.py``
  ``make_losses``): softmax cross-entropy of an affine model.

Every loss is a torch function of a 1-D float32 tensor on the device its
data was put on. The numpy draws are the reference's, so the data are
bit-equal; ``random_intersecting_quadratics`` draws from a
``torch.Generator`` instead of ``jax.random`` (whose bits the port cannot
reproduce), and ``quadratics_from`` builds the same losses from given
arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List

import numpy as np
import torch


def beck_teboulle_losses() -> List[Callable]:
    """f1 = max(sqrt(x^2+(y-1)^2) - 1, 0)^2  (disk of radius 1 around (0,1))
    f2 = max(y, 0)^2                         (lower half plane y <= 0)
    S1 ∩ S2 = {(0,0)}; the sets meet tangentially (no separation)."""

    def f1(w):
        x, y = w[0], w[1]
        return torch.maximum(torch.sqrt(x ** 2 + (y - 1.0) ** 2 + 1e-30)
                             - 1.0, torch.zeros_like(x)) ** 2

    def f2(w):
        return torch.maximum(w[1], torch.zeros_like(w[1])) ** 2

    return [f1, f2]


@dataclasses.dataclass
class RegressionProblem:
    xs: List[np.ndarray]   # per-node design matrices (float64)
    ys: List[np.ndarray]   # per-node targets
    power: int = 1         # loss = mean(residual^(2*power))

    @property
    def m(self) -> int:
        return len(self.xs)

    def local_losses(self, device="cuda") -> List[Callable]:
        """One loss per node, its data float32 on ``device``."""
        fns = []
        for X, y in zip(self.xs, self.ys):
            Xj = torch.as_tensor(X, dtype=torch.float32, device=device)
            yj = torch.as_tensor(y, dtype=torch.float32, device=device)

            def f(w, Xj=Xj, yj=yj, p=self.power):
                return torch.mean(torch.square(Xj @ w - yj) ** p)

            fns.append(f)
        return fns

    def global_loss(self, device="cuda") -> Callable:
        fns = self.local_losses(device)

        def f(w):
            return sum(fn(w) for fn in fns) / len(fns)

        return f


def make_overparam_regression(n: int = 62, d: int = 2000, m: int = 2,
                              power: int = 1, seed: int = 0,
                              scale: float = 1.0) -> RegressionProblem:
    """Colon-cancer-shaped synthetic regression: n << d, realizable (zero
    loss on every node at once), split over m nodes."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float64) * scale / np.sqrt(d)
    w_true = rng.randn(d)
    y = X @ w_true
    idx = np.array_split(np.arange(n), m)
    return RegressionProblem(
        xs=[X[i] for i in idx], ys=[y[i] for i in idx], power=power)


def quadratics_from(w_star: torch.Tensor, mats) -> List[Callable]:
    """f_i(w) = ||A_i (w - w*)||^2 / 2 for the given A_i (on w_star's
    device): each S_i is an affine subspace through w*."""
    losses = []
    for A in mats:
        def f(w, A=A):
            r = A @ (w - w_star)
            return 0.5 * torch.sum(r ** 2)

        losses.append(f)
    return losses


def random_intersecting_quadratics(gen: torch.Generator, m: int, d: int,
                                   rank: int, device="cuda"):
    """m quadratics sharing a minimizer set that contains w* (rank < d):
    w* ~ N(0, I), A_i ~ N(0, 1/d) of shape (rank, d), drawn from ``gen``
    (a generator on ``device``). Returns (losses, w_star, mats)."""
    w_star = torch.randn(d, generator=gen, device=device)
    mats = [torch.randn(rank, d, generator=gen, device=device) / np.sqrt(d)
            for _ in range(m)]
    return quadratics_from(w_star, mats), w_star, mats


def distance_to_intersection(w, mats, w_star) -> torch.Tensor:
    """d(w, S) where S = {w: A_i (w - w*) = 0 for all i}: the norm of the
    projection of w - w* onto the row space of the stacked A_i."""
    A = torch.cat(list(mats), dim=0)
    _, s, vt = torch.linalg.svd(A, full_matrices=False)
    V = vt[s > 1e-8 * s.max()]
    return torch.linalg.norm(V.T @ (V @ (w - w_star)))


def affine_softmax_losses(x: np.ndarray, labels: np.ndarray, m: int,
                          n_classes: int = 10, device="cuda"):
    """Fig 3's node losses: (x, labels) split over m nodes, the mean
    softmax cross-entropy of logits = x W + b with w = [W.ravel(), b].
    Returns (losses, n_params)."""
    n, d = x.shape
    k = n_classes

    def node_loss(xi, yi):
        xi = torch.as_tensor(xi, dtype=torch.float32, device=device)
        yi = torch.as_tensor(yi, dtype=torch.int64, device=device)

        def f(w):
            logits = xi @ w[:d * k].reshape(d, k) + w[d * k:]
            gold = torch.gather(logits, 1, yi[:, None])[:, 0]
            return torch.mean(torch.logsumexp(logits, dim=-1) - gold)

        return f

    idx = np.array_split(np.arange(n), m)
    return [node_loss(x[i], labels[i]) for i in idx], d * k + k
