"""Model Propagation (paper §3): the Prop. 1 closed form, the Eq. 5
synchronous iteration and the asynchronous gossip algorithm (counterpart
of ``repro.core.model_propagation``).

All three solve  Q_MP(Theta) =
    1/2 ( sum_{i<j} W_ij ||theta_i - theta_j||^2
          + mu sum_i D_ii c_i ||theta_i - theta_i^sol||^2 ):

* ``closed_form``   — Prop. 1:  Theta* = abar (I - abar(I-C) - a P)^{-1} C Theta_sol
* ``synchronous``   — fixed-point iteration Eq. (5), one ``mix`` op a step
                      (the ``graph_mix`` CUDA kernel on the card)
* ``async_gossip``  — the paper's asynchronous gossip algorithm (§3.2),
                      one wake-up a tick on the full Theta_tilde (n, n, p)
                      state; ``simulate.engines.sparse_async_gossip``
                      equals it bit for bit over O(n k p) slot state
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.dispatch import ReproBackend, resolve

from .graph import Graph
from .sparse import (agent_model_update, padded_neighbor_tables,
                     record_chunks, wakeups)


def mp_mix_operator(P_rows, c, alpha):
    """Eq. (5) as a "mix" op:  theta' = A_mix @ theta + b * theta_sol.

    A_mix = diag(alpha / (alpha + abar c)) P,  b = abar c / (alpha + abar c).
    ``P_rows`` may be the dense (n, n) stochastic matrix or the (n, k)
    padded-neighbor slot weights (row scaling is identical).  Leading axes
    are a batch of problems: P_rows (..., n, n|k), c (..., n), alpha a
    number or (..., 1).
    """
    abar = 1.0 - alpha
    denom = alpha + abar * c
    A_mix = (alpha / denom)[..., None] * P_rows
    b = abar * c / denom
    return A_mix, b


def mp_objective(theta, theta_sol, W, c, mu):
    """Q_MP — used by tests to verify optimality of the closed form, and
    by the sweeps.  Leading axes are a batch of problems: theta, theta_sol
    (..., n, p), W (..., n, n), c (..., n), mu a number or (...) ->
    (...)."""
    W = torch.as_tensor(W, dtype=theta.dtype, device=theta.device)
    diff = theta[..., :, None, :] - theta[..., None, :, :]
    # sum_{i<j} W_ij ||.||^2 == 1/2 sum_{i,j} W_ij ||.||^2 for symmetric W,
    # and Q_MP carries an outer 1/2 -> 0.25 overall.
    smooth = 0.25 * torch.sum(W * torch.sum(diff * diff, dim=-1),
                              dim=(-2, -1))
    D = torch.sum(W, dim=-1)
    anchor = 0.5 * mu * torch.sum(
        D * c * torch.sum((theta - theta_sol) ** 2, dim=-1), dim=-1)
    return smooth + anchor


def _tensor(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def closed_form(graph: Graph, theta_sol, c, alpha: float,
                device=None) -> torch.Tensor:
    """Prop. 1:  Theta* = abar (I - abar(I - C) - alpha P)^{-1} C Theta_sol,
    solved in float32 on ``device`` (CUDA when None)."""
    device = resolve_device(device)
    n = graph.n
    P = _tensor(graph.P, device)
    theta_sol = _tensor(theta_sol, device).reshape(n, -1)
    c = _tensor(c, device)
    abar = 1.0 - alpha
    eye = torch.eye(n, device=device)
    A = eye - abar * (eye - torch.diag(c)) - alpha * P
    return abar * torch.linalg.solve(A, c[:, None] * theta_sol)


def synchronous(graph: Graph, theta_sol, c, alpha: float, steps: int,
                theta0=None, backend: Optional[ReproBackend] = None,
                device=None) -> torch.Tensor:
    """Fixed-point iteration Eq. (5); converges to Theta* for any init.

    Each iterate is one ``mix`` op — A_mix @ theta + b * theta_sol —
    resolved through ``kernels.dispatch`` for ``device`` (CUDA when None:
    the ``graph_mix`` kernel).
    """
    device = resolve_device(device)
    n = graph.n
    P = _tensor(graph.P, device)
    theta_sol = _tensor(theta_sol, device).reshape(n, -1).contiguous()
    c = _tensor(c, device)
    A_mix, b = mp_mix_operator(P, c, alpha)
    A_mix, b = A_mix.contiguous(), b.contiguous()
    theta = theta_sol if theta0 is None else \
        _tensor(theta0, device).reshape(n, -1).contiguous()
    mix = resolve("mix", backend, device)
    for _ in range(steps):
        theta = mix(theta, theta_sol, A_mix, b)
    return theta


def label_propagation(graph: Graph, labels, alpha: float,
                      device=None) -> torch.Tensor:
    """Zhou et al. (2004) — the C = I special case (paper §3.1 remark)."""
    return closed_form(graph, labels, np.ones(graph.n), alpha, device=device)


@dataclasses.dataclass
class AsyncTrace:
    """Result of the async gossip simulation.

    theta_hist: (n_records, n, p) — each agent's own model over time
    comms_hist: (n_records,)      — cumulative pairwise communications
    final_knowledge: (n, n, p)    — the full Theta_tilde at the end
    """

    theta_hist: torch.Tensor
    comms_hist: np.ndarray
    final_knowledge: torch.Tensor


def async_gossip(graph: Graph, theta_sol, c, alpha: float, steps: int,
                 seed: int = 0, record_every: int = 100, theta0=None,
                 draws=None, backend: Optional[ReproBackend] = None,
                 device=None) -> AsyncTrace:
    """The asynchronous gossip MP algorithm (paper §3.2) on ``device``
    (CUDA when None).

    The state is Theta_tilde (n, n, p): T[i, j] is agent i's knowledge of
    agent j's model, warm-started with the solitary models wherever i
    knows j (itself and its neighbors), or ``theta0``.  One tick = one
    wake-up (agent i, neighbor slot s, neighbor j ~ pi_i uniform over
    N_i): i and j exchange their current models, then both recompute
    theta by Eq. (6) — 2 pairwise communications.  ``draws = (i_seq,
    s_seq)`` gives the wake-ups (e.g. the JAX package's); otherwise a
    ``torch.Generator`` seeded with ``seed`` draws them.  A degree-0 waker
    is a no-op.  The horizon is floored to whole ``record_every`` chunks
    (``core.sparse.record_chunks``).
    """
    device = resolve_device(device)
    n = graph.n
    sol = _tensor(theta_sol, device).reshape(n, -1)
    p = sol.shape[1]
    host = padded_neighbor_tables(graph)
    nbr_p = torch.as_tensor(host.nbr_p, device=device)
    idx = torch.as_tensor(host.nbr_idx, device=device).long()
    c = _tensor(c, device)
    if theta0 is None:
        knows = torch.as_tensor((np.asarray(graph.W) > 0)
                                | np.eye(n, dtype=bool), device=device)
        T = torch.where(knows[:, :, None], sol[None].expand(n, n, p), 0.0)
    else:
        T = _tensor(theta0, device).reshape(n, n, p).clone()
    own = T.diagonal(dim1=0, dim2=1)                   # (p, n) view

    def update(l):
        return agent_model_update(l, nbr_p, T[l][idx[l]], c, sol, alpha,
                                  backend)

    record_every, n_rec = record_chunks(steps, record_every)
    hist = []
    for t, (i, s) in enumerate(wakeups(n, host, n_rec * record_every,
                                       seed, draws)):
        if host.deg_count[i] > 0:          # a degree-0 waker is a no-op
            j = int(host.nbr_idx[i, s])
            # communication step: exchange current self-models
            T[i, j] = T[j, j]  # scatter: unique target — one (i, j) cell
            T[j, i] = T[i, i]  # scatter: unique target — one (j, i) cell
            # update step for both endpoints, i first
            T[i, i] = update(i)  # scatter: unique target — one cell
            T[j, j] = update(j)  # scatter: unique target — one cell
        if (t + 1) % record_every == 0:
            hist.append(own.T.clone())
    comms = 2 * record_every * (np.arange(n_rec) + 1)
    return AsyncTrace(torch.stack(hist), comms, T)
