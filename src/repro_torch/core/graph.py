"""Similarity graphs over agents (paper §2.1, §5).

Counterpart of ``repro.core.graph``: the numpy ``Graph`` and the graph
constructors are copied (same validation, same draws from the same seed);
``as_torch`` replaces ``as_jnp``.

A graph is represented by its dense symmetric nonnegative weight matrix
``W`` (n x n, zero diagonal). Derived quantities: the degrees ``D_ii`` and
``P = D^{-1} W`` (stochastic similarity matrix).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Tuple

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class Graph:
    """Weighted undirected graph over ``n`` agents (paper §2.1).

    ``W`` is validated once here: non-finite or negative entries raise, an
    asymmetry beyond float tolerance raises, one within tolerance is
    symmetrized to ``(W + W.T) / 2`` with a ``UserWarning``, and the
    diagonal is zeroed.
    """

    W: np.ndarray  # (n, n) symmetric, nonnegative, zero diagonal

    def __post_init__(self):
        W = np.asarray(self.W, dtype=np.float64)
        if W.ndim != 2 or W.shape[0] != W.shape[1]:
            raise ValueError(f"W must be square, got {W.shape}")
        if not np.isfinite(W).all():
            raise ValueError("W must be finite (contains NaN or inf)")
        if (W < 0).any():
            raise ValueError("W must be nonnegative")
        if not np.array_equal(W, W.T):
            if not np.allclose(W, W.T):
                raise ValueError("W must be symmetric")
            warnings.warn(
                "W is asymmetric within float tolerance; symmetrizing to "
                "(W + W.T) / 2", UserWarning, stacklevel=3)
            W = 0.5 * (W + W.T)
        object.__setattr__(self, "W", W * (1.0 - np.eye(W.shape[0])))

    @property
    def n(self) -> int:
        """Number of agents."""
        return self.W.shape[0]

    @property
    def degrees(self) -> np.ndarray:
        """(n,) weighted degrees D_ii = sum_j W_ij (paper §2.1)."""
        return self.W.sum(axis=1)

    @property
    def D(self) -> np.ndarray:
        """Degree diagonal matrix D (paper Prop. 1)."""
        return np.diag(self.degrees)

    @property
    def laplacian(self) -> np.ndarray:
        """Graph Laplacian L = D - W (the smoothness operator of
        Eq. (1)'s quadratic term)."""
        return self.D - self.W

    def edges(self) -> List[Tuple[int, int]]:
        """Undirected edges (i < j) with positive weight."""
        iu, ju = np.nonzero(np.triu(self.W, k=1))
        return list(zip(iu.tolist(), ju.tolist()))

    def neighbors(self, i: int) -> np.ndarray:
        """Ids of N_i — agents sharing a positive-weight edge with i."""
        return np.nonzero(self.W[i])[0]

    def edge_coloring(self) -> List[List[Tuple[int, int]]]:
        """Greedy proper edge coloring -> list of matchings covering E.

        Each matching is a set of vertex-disjoint edges (agent pairs that
        can gossip at once).  Edges are placed heaviest first (Python's
        stable sort, so ties keep ``edges()`` order), each into the first
        matching where both ends are free: the JAX package's matchings in
        the same order.
        """
        matchings: List[List[Tuple[int, int]]] = []
        used: List[set] = []
        for (i, j) in sorted(self.edges(), key=lambda e: -self.W[e[0], e[1]]):
            for color, busy in enumerate(used):
                if i not in busy and j not in busy:
                    matchings[color].append((i, j))
                    busy.update((i, j))
                    break
            else:
                matchings.append([(i, j)])
                used.append({i, j})
        return matchings

    @property
    def P(self) -> np.ndarray:
        """Stochastic similarity matrix P = D^{-1} W (paper Prop. 1)."""
        d = self.degrees
        if (d <= 0).any():
            raise ValueError("graph has an isolated agent (zero degree)")
        return self.W / d[:, None]


def gaussian_kernel_graph(points: np.ndarray, sigma: float = 0.1,
                          threshold: float = 0.0) -> Graph:
    """Complete graph with W_ij = exp(-||v_i - v_j||^2 / (2 sigma^2)).

    Used in the mean-estimation task (paper §5.1); ``threshold`` zeroes
    negligible weights; ``sigma`` must be positive.
    """
    if sigma <= 0:
        raise ValueError(f"sigma must be > 0, got {sigma}")
    v = np.asarray(points, dtype=np.float64)
    sq = ((v[:, None, :] - v[None, :, :]) ** 2).sum(-1)
    W = np.exp(-sq / (2.0 * sigma ** 2))
    np.fill_diagonal(W, 0.0)
    if threshold > 0:
        W = np.where(W >= threshold, W, 0.0)
    return Graph(W)


def angular_kernel_graph(models: np.ndarray, sigma: float = 0.1,
                         threshold: float = 1e-3) -> Graph:
    """W_ij = exp((cos(phi_ij) - 1)/sigma) over target-model angles (§5.2).

    ``sigma`` must be positive; zero-norm model rows are treated as
    unit-norm so the cosine is defined.
    """
    if sigma <= 0:
        raise ValueError(f"sigma must be > 0, got {sigma}")
    m = np.asarray(models, dtype=np.float64)
    norms = np.linalg.norm(m, axis=1, keepdims=True)
    norms = np.where(norms == 0, 1.0, norms)
    u = m / norms
    cos = np.clip(u @ u.T, -1.0, 1.0)
    W = np.exp((cos - 1.0) / sigma)
    np.fill_diagonal(W, 0.0)
    W = np.where(W >= threshold, W, 0.0)
    return Graph(np.maximum(W, W.T))       # exactly symmetric


def knn_graph_from_similarity(sim: np.ndarray, k: int) -> Graph:
    """k-nearest-neighbor graph with 0/1 weights (paper App. E), symmetrized
    (an edge exists if either endpoint selects the other)."""
    s = np.asarray(sim, dtype=np.float64).copy()
    np.fill_diagonal(s, -np.inf)
    n = s.shape[0]
    W = np.zeros((n, n))
    idx = np.argsort(-s, axis=1)[:, :k]
    rows = np.repeat(np.arange(n), k)
    W[rows, idx.ravel()] = 1.0  # scatter: idempotent (every value is 1.0)
    W = np.maximum(W, W.T)
    return Graph(W)


def two_moons(n: int, noise: float = 0.05,
              seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Two intertwining moons in R^2 (paper §5.1 / Zhou et al. 2004).

    Returns (points (n,2), labels (n,) in {0,1}) — label 0 = upper moon
    (mean +1), label 1 = lower moon (mean -1).
    """
    rng = np.random.default_rng(seed)
    n0 = n // 2
    n1 = n - n0
    t0 = rng.uniform(0.0, np.pi, n0)
    t1 = rng.uniform(0.0, np.pi, n1)
    upper = np.stack([np.cos(t0), np.sin(t0)], axis=1)
    lower = np.stack([1.0 - np.cos(t1), 0.5 - np.sin(t1)], axis=1)
    pts = np.concatenate([upper, lower], axis=0)
    pts += noise * rng.standard_normal(pts.shape)
    labels = np.concatenate([np.zeros(n0, dtype=int), np.ones(n1, dtype=int)])
    perm = rng.permutation(n)
    return pts[perm], labels[perm]


def ring_graph(n: int, weight: float = 1.0) -> Graph:
    """Ring over n agents."""
    W = np.zeros((n, n))
    for i in range(n):
        W[i, (i + 1) % n] = weight  # scatter: unique target per iteration
        W[(i + 1) % n, i] = weight  # scatter: unique target per iteration
    return Graph(W)


def random_geometric_graph(n: int, k: int = 3, seed: int = 0) -> Graph:
    """kNN graph over random 2-D positions — agent topology generator."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(n, 2))
    sq = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    return knn_graph_from_similarity(-sq, k)


def as_torch(graph: Graph, device=None, dtype=torch.float32):
    """(W, P, degrees) as tensors on ``device`` (CUDA when None)."""
    device = resolve_device(device)
    return (torch.as_tensor(graph.W, dtype=dtype, device=device),
            torch.as_tensor(graph.P, dtype=dtype, device=device),
            torch.as_tensor(graph.degrees, dtype=dtype, device=device))
