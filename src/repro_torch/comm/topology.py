"""Mixing topologies (counterpart of ``repro/comm/topology.py``; DESIGN.md
§8), copied as they are: numpy only, built on the host, deterministic
per seed.

The paper's server step is the star topology: every node pushes its
model, pulls the mean. Decentralized variants replace it with rounds of
neighbour averaging ``x <- W x`` over the G groups, where ``W`` is
doubly stochastic: rows sum to 1 (iterates stay in the convex hull) and
columns sum to 1 (the G-mean is invariant). push_sum is matrix-free: its directed
circulant offsets come from ``push_sum_offsets``; the hierarchical
topology factors G into contiguous pods (``pod_size``) and mixes within
a pod over ``ring_circulant``.
"""
from __future__ import annotations

import numpy as np


def server_matrix(m: int) -> np.ndarray:
    """Star topology as a mixing matrix: one step reaches exact consensus.
    (The server exchange does not multiply by it: it takes the exact
    mean; the matrix form is what the consensus and spectral tests use.)"""
    return np.full((m, m), 1.0 / m)


def ring_matrix(m: int) -> np.ndarray:
    """Symmetric ring: each node averages itself with its two neighbours
    (equal 1/3 weights; m <= 2 falls back to the mean)."""
    if m <= 2:
        return server_matrix(m)
    w = np.zeros((m, m))
    for i in range(m):
        w[i, i] = 1.0 / 3.0
        w[i, (i - 1) % m] = 1.0 / 3.0
        w[i, (i + 1) % m] = 1.0 / 3.0
    return w


def gossip_matrix(m: int, seed: int = 0) -> np.ndarray:
    """Metropolis-Hastings weights on a random connected graph: a ring
    backbone plus ``m // 2`` random chords (deterministic per seed).
    W_ij = 1 / (1 + max(deg_i, deg_j)) on each edge, W_ii = 1 - sum_j;
    symmetric and doubly stochastic for any undirected graph."""
    if m <= 2:
        return server_matrix(m)
    rng = np.random.RandomState(seed)
    edges = {(i, (i + 1) % m) for i in range(m)}
    edges = {(min(a, b), max(a, b)) for a, b in edges}
    for _ in range(m // 2):
        a, b = rng.randint(0, m, size=2)
        if a != b:
            edges.add((min(a, b), max(a, b)))
    deg = np.zeros(m, dtype=np.int64)
    for a, b in edges:
        deg[a] += 1
        deg[b] += 1
    w = np.zeros((m, m))
    for a, b in edges:
        w[a, b] = w[b, a] = 1.0 / (1.0 + max(deg[a], deg[b]))
    np.fill_diagonal(w, 1.0 - w.sum(axis=1))
    return w


def mixing_matrix(name: str, m: int, seed: int = 0) -> np.ndarray:
    if name == "server":
        return server_matrix(m)
    if name == "ring":
        return ring_matrix(m)
    if name == "gossip":
        return gossip_matrix(m, seed=seed)
    raise ValueError(
        f"unknown topology {name!r}: valid mixing-matrix topologies are "
        "'server', 'ring', 'gossip' (push_sum is matrix-free ratio "
        "consensus — see push_sum_offsets; async_stale/none never mix "
        "through W)")


def push_sum_offsets(m: int) -> tuple:
    """Directed circulant offsets of the push-sum graph (DESIGN.md §12):
    node g pushes shares to ``(g + d) % m`` for each offset d, so every
    node splits its (value, weight) mass into ``len(offsets) + 1`` equal
    shares (one kept). m = 1 needs no wire; m = 2 has one edge each way
    (offset 1 covers both directions)."""
    if m <= 1:
        return ()
    if m == 2:
        return (1,)
    return (1, m - 1)


def pod_size(g: int, n_pods: int) -> int:
    """Validated pod size of the hierarchical topology (DESIGN.md §16):
    the G axis factors into ``n_pods`` contiguous pods of equal size,
    group g in pod ``g // pod_size``."""
    if n_pods < 1:
        raise ValueError(f"n_pods {n_pods} must be >= 1")
    if g % n_pods != 0:
        raise ValueError(
            f"hierarchical topology needs n_pods ({n_pods}) to divide "
            f"n_groups ({g}) into equal contiguous pods; valid pod counts "
            f"for G={g} are the divisors of G")
    return g // n_pods


def ring_circulant(m: int):
    """``(w_self, offsets, w_edge)`` of the symmetric ring over m nodes:
    x_i <- w_self*x_i + w_edge*sum_d x_{(i+d) % m}, equal to
    ``ring_matrix`` (m <= 2 is the mean)."""
    if m <= 1:
        return 1.0, (), 0.0
    if m == 2:
        return 0.5, (1,), 0.5
    return 1.0 / 3.0, (1, m - 1), 1.0 / 3.0


def is_doubly_stochastic(w: np.ndarray, tol: float = 1e-9) -> bool:
    return (np.all(w >= -tol)
            and np.allclose(w.sum(axis=0), 1.0, atol=tol)
            and np.allclose(w.sum(axis=1), 1.0, atol=tol))


def spectral_gap(w: np.ndarray) -> float:
    """1 - |lambda_2|. Positive iff repeated mixing reaches consensus."""
    lam = np.sort(np.abs(np.linalg.eigvals(w)))[::-1]
    return float(1.0 - (lam[1] if len(lam) > 1 else 0.0))


def n_edge_sends(w: np.ndarray) -> int:
    """Point-to-point payloads one mixing round costs: each node sends its
    buffer to every neighbour with a nonzero incoming weight (the
    off-diagonal nonzeros of W)."""
    off = w.copy()
    np.fill_diagonal(off, 0.0)
    return int(np.count_nonzero(off))


def neighbor_offsets(w: np.ndarray) -> tuple:
    """Distinct nonzero circulant offsets of W's off-diagonal support:
    ``d`` is in the result iff some node i receives from ``(i + d) % m``.
    The sharded hop (``sharding/shardexec.py``) ships one neighbour
    exchange per offset: exactly {1, m-1} for a ring, the union of
    offsets for a gossip graph (entries without an edge carry weight 0;
    the wire accounting counts only true edges, ``n_edge_sends``)."""
    m = w.shape[0]
    off = w.copy()
    np.fill_diagonal(off, 0.0)
    i, j = np.nonzero(off)
    return tuple(sorted({int(d) for d in (j - i) % m}))
