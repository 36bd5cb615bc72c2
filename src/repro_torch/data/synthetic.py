"""Synthetic problems of the paper's model-propagation experiments
(counterpart of ``repro.data.synthetic``, MP subset).

The numpy draws are exactly those of the JAX package from the same seed:
``mean_estimation_problem`` (§5.1: two-moons auxiliary information,
N(+-1, 40) sample streams, c_i ~ U(1/2 +- eps/2), m_i = round(100 c_i))
and ``two_cluster_mean_problem`` (two planted clusters of agents with
opposite mean targets).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.graph import gaussian_kernel_graph, two_moons
from repro_torch.core.losses import pad_datasets


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
