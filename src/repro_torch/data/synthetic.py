"""Synthetic problems of the paper's experiments (counterpart of
``repro.data.synthetic``).

The numpy draws are exactly those of the JAX package from the same seed:
``mean_estimation_problem`` (§5.1: two-moons auxiliary information,
N(+-1, 40) sample streams, c_i ~ U(1/2 +- eps/2), m_i = round(100 c_i)),
``two_cluster_mean_problem`` (two planted clusters of agents with
opposite mean targets), ``linear_classification_problem`` (§5.2:
target models in a 2-D subspace of R^p, angular-kernel graph,
m_i ~ U{1..20}, 5% label flips) and ``federated_moons_problem``
(per-cluster nonlinear two-moons boundaries for the nonlinear agents),
and the personalized LM token streams (per-agent bigram processes that
neighbors share structure in); MusicGen's codebook delay pattern
(``delay_pattern`` / ``undelay_pattern``), numpy as there.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.core.graph import (Graph, angular_kernel_graph,
                                    gaussian_kernel_graph,
                                    knn_graph_from_similarity, two_moons)
from repro_torch.core.losses import AgentData, pad_datasets
from repro_torch.simulate.topology import planted_partition_topology


def mean_estimation_problem(n: int = 300, eps: float = 1.0,
                            sigma: float = 0.1, var: float = 40.0,
                            max_samples: int = 100, seed: int = 0,
                            device=None):
    """Returns (graph, data, targets, confidences); ``data`` is an
    AgentData on ``device`` (CUDA when None), the rest numpy."""
    rng = np.random.default_rng(seed)
    pts, labels = two_moons(n, seed=seed)
    graph = gaussian_kernel_graph(pts, sigma=sigma)
    targets = np.where(labels == 0, 1.0, -1.0)
    c = rng.uniform(0.5 - eps / 2.0, 0.5 + eps / 2.0, n)
    m = np.maximum(np.rint(c * max_samples).astype(int), 0)
    xs = [targets[i] + np.sqrt(var) * rng.standard_normal((m[i], 1))
          for i in range(n)]
    data = pad_datasets(xs, device=device)
    return graph, data, targets, c


def two_cluster_mean_problem(n: int, p: int = 4, sep: float = 2.0,
                             noise: float = 0.5, seed: int = 0):
    """Two planted clusters of agents estimating opposite means.

    Agents in cluster 0 target ``+sep/2 * 1``, cluster 1 ``-sep/2 * 1`` (in
    R^p); solitary models are the targets plus N(0, noise^2) noise.
    Returns numpy ``(labels, targets, theta_sol, c)``, labels the
    contiguous-block cluster ids matching
    ``simulate.topology.planted_partition_topology(n, 2, ...)``.
    """
    rng = np.random.default_rng(seed)
    labels = (np.arange(n) >= n // 2).astype(np.int32)
    targets = np.where(labels[:, None] == 0, sep / 2.0, -sep / 2.0) \
        * np.ones((n, p))
    theta_sol = (targets + noise * rng.standard_normal((n, p))) \
        .astype(np.float32)
    c = rng.uniform(0.3, 1.0, n).astype(np.float32)
    return labels, targets.astype(np.float32), theta_sol, c


def linear_classification_problem(n: int = 100, p: int = 50,
                                  sigma: float = 0.1,
                                  label_noise: float = 0.05,
                                  max_train: int = 20, n_test: int = 100,
                                  seed: int = 0, knn: Optional[int] = None,
                                  device=None):
    """Returns (graph, train AgentData, test AgentData, target models);
    the datasets on ``device`` (CUDA when None), the rest numpy."""
    rng = np.random.default_rng(seed)
    targets = np.zeros((n, p))
    targets[:, :2] = rng.standard_normal((n, 2))
    if knn is None:
        graph = angular_kernel_graph(targets, sigma=sigma, threshold=1e-2)
    else:
        u = targets / np.linalg.norm(targets, axis=1, keepdims=True)
        graph = knn_graph_from_similarity(u @ u.T, knn)

    def gen(m_per_agent):
        xs, ys = [], []
        for i in range(n):
            m = m_per_agent[i]
            x = rng.uniform(-1, 1, (m, p))
            y = np.sign(x @ targets[i])
            y[y == 0] = 1.0  # scatter: unique targets (boolean mask)
            flip = rng.uniform(size=m) < label_noise
            xs.append(x)
            ys.append(np.where(flip, -y, y))
        return pad_datasets(xs, ys, device=device)

    m_train = rng.integers(1, max_train + 1, n)
    train = gen(m_train)
    test = gen(np.full(n, n_test))
    return graph, train, test, targets


def accuracy(theta_all, data: AgentData) -> np.ndarray:
    """(n,) per-agent accuracy of linear models (n, p) on padded
    datasets, as numpy."""
    x, y, mask = (a.cpu().numpy() for a in (data.x, data.y, data.mask))
    theta = torch.as_tensor(theta_all).cpu().float().numpy()
    pred = np.sign(np.einsum("nmp,np->nm", x, theta))
    correct = (pred == y) * mask
    return correct.sum(1) / np.maximum(mask.sum(1), 1)


# ---------------------------------------------------------------------------
# Nonlinear personalized boundaries — federated two moons (DESIGN.md §18)
# ---------------------------------------------------------------------------


def federated_moons_problem(n: int = 24, n_clusters: int = 2,
                            m_lo: int = 3, m_hi: int = 8,
                            noise: float = 0.15, n_test: int = 256,
                            seed: int = 0, k_intra: int = 4,
                            k_inter: int = 1, device=None):
    """Per-cluster nonlinear decision boundaries for the inexact-primal
    experiment: tiny local samples of a two-moons boundary that only
    collaboration can resolve.

    Cluster ``c``'s points are the two-moons problem rotated by
    ``pi c / n_clusters`` about the moons' centroid, with the labels of
    odd clusters flipped; each agent draws ``m_i ~ U{m_lo..m_hi}``
    training points from its cluster's distribution.  The candidate graph
    is ``planted_partition_topology`` (intra-cluster ring and links,
    ``k_inter`` cross-cluster links per agent).  The numpy draws are the
    JAX package's, in its order, so the arrays equal its arrays.

    Returns ``(topo, train, test_x, test_y)``: a SparseTopology, the
    padded train AgentData on ``device`` (CUDA when None; labels in
    {-1, +1}), and numpy per-agent test sets ``test_x (n, n_test, 2)``,
    ``test_y (n, n_test)`` from each agent's own cluster.  The loop over
    agents runs on the host.
    """
    rng = np.random.default_rng(seed)
    topo = planted_partition_topology(n, n_clusters=n_clusters,
                                      k_intra=k_intra, k_inter=k_inter,
                                      seed=seed)
    center = np.array([0.5, 0.25])

    def sample(ci, m, sub_seed):
        pts, labels = two_moons(m, noise=noise, seed=sub_seed)
        ang = np.pi * ci / n_clusters
        rot = np.array([[np.cos(ang), -np.sin(ang)],
                        [np.sin(ang), np.cos(ang)]])
        pts = (pts - center) @ rot.T
        y = np.where(labels == 0, 1.0, -1.0)
        return pts, (-y if ci % 2 else y)

    m_i = rng.integers(m_lo, m_hi + 1, n)
    xs, ys, tx, ty = [], [], [], []
    for i in range(n):
        ci = int(topo.groups[i])
        pts, y = sample(ci, int(m_i[i]), int(rng.integers(2 ** 31)))
        xs.append(pts)
        ys.append(y)
        pts_t, y_t = sample(ci, n_test, int(rng.integers(2 ** 31)))
        tx.append(pts_t)
        ty.append(y_t)
    return (topo, pad_datasets(xs, ys, device=device),
            np.stack(tx).astype(np.float32), np.stack(ty).astype(np.float32))


def model_accuracy(theta_all, predict_fn, x, y) -> np.ndarray:
    """(n,) per-agent accuracy of flat-row models under a score function,
    as numpy: ``predict_fn(theta (p,), x (m, q)) -> (m,)`` scores whose
    sign is the predicted ±1 label (e.g. ``core.primal.flat_predictor``),
    vmapped over theta_all (n, p) and x (n, m, q) on theta_all's device;
    y (n, m)."""
    theta = torch.as_tensor(theta_all, dtype=torch.float32)
    x = torch.as_tensor(np.asarray(x), dtype=torch.float32,
                        device=theta.device)
    scores = torch.func.vmap(predict_fn)(theta, x).cpu().numpy()
    return (np.sign(scores) == np.sign(np.asarray(y))).mean(axis=1)


# ---------------------------------------------------------------------------
# Personalized LM streams
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PersonalizedLMConfig:
    vocab_size: int
    n_agents: int
    seq_len: int
    batch_per_agent: int
    share: float = 0.9          # transition mass shared by every agent
    concentration: float = 0.3  # Dirichlet concentration of private structure
    seed: int = 0


def _agent_bigrams(cfg: PersonalizedLMConfig, graph: Graph) -> np.ndarray:
    """Per-agent bigram transition matrices (n_agents, V, V) float64.

    A shared base, blended with a cluster tilt chosen by the sign of the
    agent's entry in the Laplacian's Fiedler vector and a small private
    tilt, so neighbors end up statistically similar.  It holds
    ``n_agents * V**2`` float64s (8 GB at V = 8192 and 16 agents): the
    stream is drawn at a small ``vocab_size``.
    """
    rng = np.random.default_rng(cfg.seed)
    V = cfg.vocab_size
    base = rng.dirichlet(np.full(V, 1.0), size=V)
    lap = graph.laplacian
    _, vecs = np.linalg.eigh(lap)
    fiedler = vecs[:, 1] if lap.shape[0] > 1 else np.zeros(1)
    tilts = {s: rng.dirichlet(np.full(V, cfg.concentration), size=V)
             for s in (-1, 1)}
    out = np.empty((cfg.n_agents, V, V))
    for a in range(cfg.n_agents):
        s = 1 if fiedler[a] >= 0 else -1
        private = rng.dirichlet(np.full(V, cfg.concentration), size=V)
        out[a] = (cfg.share * base + (1 - cfg.share) *
                  (0.8 * tilts[s] + 0.2 * private))
    return out / out.sum(-1, keepdims=True)


def personalized_token_stream(cfg: PersonalizedLMConfig, graph: Graph
                              ) -> Iterator[np.ndarray]:
    """Yields batches (n_agents, batch_per_agent, seq_len + 1) of int32
    token ids, the JAX package's draws from the same seed;
    tokens = batch[..., :-1], labels = batch[..., 1:]."""
    trans = _agent_bigrams(cfg, graph)
    cum = np.cumsum(trans, axis=-1)
    rng = np.random.default_rng(cfg.seed + 1)
    A, b, S = cfg.n_agents, cfg.batch_per_agent, cfg.seq_len + 1
    agent_idx = np.arange(A)[:, None]                      # (A, 1)
    while True:
        out = np.empty((A, b, S), np.int32)
        state = rng.integers(0, cfg.vocab_size, (A, b))
        out[..., 0] = state
        u = rng.uniform(size=(A, b, S - 1))
        for t in range(1, S):
            rows = cum[agent_idx, state]                   # (A, b, V)
            state = (rows >= u[..., t - 1:t]).argmax(-1)
            state = np.minimum(state, cfg.vocab_size - 1)
            out[..., t] = state
        yield out


def make_lm_batches(cfg: PersonalizedLMConfig, graph: Graph,
                    n_batches: int):
    """The first ``n_batches`` batches of the stream, as a list."""
    it = personalized_token_stream(cfg, graph)
    return [next(it) for _ in range(n_batches)]


# ---------------------------------------------------------------------------
# MusicGen delay pattern (audio arch)
# ---------------------------------------------------------------------------


def delay_pattern(tokens: np.ndarray, pad_id: int) -> np.ndarray:
    """Apply the MusicGen codebook delay: codebook k is shifted right by k.

    tokens: (B, K, S) -> (B, K, S + K - 1) padded with pad_id.
    """
    B, K, S = tokens.shape
    out = np.full((B, K, S + K - 1), pad_id, tokens.dtype)
    for k in range(K):
        out[:, k, k:k + S] = tokens[:, k]
    return out


def undelay_pattern(tokens: np.ndarray) -> np.ndarray:
    """Inverse of delay_pattern. tokens: (B, K, S + K - 1) -> (B, K, S)."""
    B, K, Sp = tokens.shape
    S = Sp - K + 1
    out = np.empty((B, K, S), tokens.dtype)
    for k in range(K):
        out[:, k] = tokens[:, k, k:k + S]
    return out
