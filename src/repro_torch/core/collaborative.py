"""Collaborative Learning via decentralized ADMM (paper §4 + App. D): the
dense reference algorithms (counterpart of ``repro.core.collaborative``).

Objective:
    Q_CL(Theta) = sum_{i<j} W_ij ||theta_i - theta_j||^2
                  + mu * sum_i D_ii L_i(theta_i)

Partial-consensus reformulation (paper Eq. 8): each agent i keeps local
copies of its own and its neighbors' models; per edge e = (i, j) there are
4 secondary variables and 4 duals.  Dense layout (mask = W > 0):

    T[i, j]     = agent i's copy of model j           (n, n, p)
    Z_own[i, j] = Z_{ei}^i,  Z_nbr[i, j] = Z_{ei}^j
    L_own[i, j] = Lambda_{ei}^i,  L_nbr[i, j] = Lambda_{ei}^j

The state is updated in place.  The primal step is exact for the
quadratic loss (block elimination over the agent's padded slot row, the
"admm_primal" op — the same call, on the same slot-row shapes, as the
sparse engine's, so ``simulate.engines.sparse_async_admm`` equals
:func:`async_admm` bit for bit) and ``k_steps`` (sub)gradient steps
through ``torch.func.grad`` for hinge and logistic.  The edge step is two
``admm_edge_halfstep`` calls, one per endpoint, from the same cells.
:func:`sync_admm` primal-updates all n agents in one batched step: agent
l's update reads and writes only its own row ``T[l]`` and reads only its
own Z and dual rows, which change after every agent has updated, so the
batch computes the reference's agent loop.

torch cannot replay ``jax.random``: :func:`async_admm` takes an explicit
``(i, s)`` wake-up sequence (``draws``) or draws one from a
``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.dispatch import ReproBackend

from .graph import Graph
from .losses import LOSSES, AgentData, local_stats
from .sparse import (admm_edge_halfstep, padded_neighbor_tables,
                     quadratic_primal_core, record_chunks, to_device,
                     wakeups)


def cl_objective(theta, W, mu, loss_fn, data: AgentData):
    """Q_CL for per-agent models theta (n, p).  Leading axes are a batch of
    problems (the sweeps' trials): theta (..., n, p), W (..., n, n), data
    fields (..., n, m[, q]), mu a number or (...) -> (...)."""
    W = torch.as_tensor(W, dtype=theta.dtype, device=theta.device)
    diff = theta[..., :, None, :] - theta[..., None, :, :]
    smooth = 0.5 * torch.sum(W * torch.sum(diff * diff, dim=-1),
                             dim=(-2, -1))
    D = torch.sum(W, dim=-1)
    rows = theta.shape[:-1]                   # (..., n) agents, flattened
    per_agent = torch.func.vmap(loss_fn)(
        theta.reshape(-1, theta.shape[-1]),
        data.x.reshape(-1, *data.x.shape[len(rows):]),
        data.y.reshape(-1, *data.y.shape[len(rows):]),
        data.mask.reshape(-1, *data.mask.shape[len(rows):])).reshape(rows)
    return smooth + mu * torch.sum(D * per_agent, dim=-1)


def direct_minimize(graph: Graph, data: AgentData, mu: float, loss: str,
                    steps: int = 2000, lr: float = None) -> torch.Tensor:
    """Centralized gradient descent on Q_CL from theta = 0 — the oracle of
    the tests and benchmarks (on ``data``'s device)."""
    loss_fn = LOSSES[loss]
    W = torch.as_tensor(graph.W, dtype=torch.float32, device=data.x.device)
    n, _, p = data.x.shape
    if lr is None:
        # conservative: the smoothness term has Lipschitz ~ 4 max_i D_ii
        lr = 0.5 / float(4.0 * graph.degrees.max() * max(mu, 1.0) + 1.0)
    grad = torch.func.grad(lambda th: cl_objective(th, W, mu, loss_fn,
                                                   data))
    theta = torch.zeros((n, p), dtype=torch.float32, device=data.x.device)
    for _ in range(steps):
        theta = theta - lr * grad(theta)
    return theta


# ---------------------------------------------------------------------------
# ADMM state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ADMMState:
    """Dense partial-consensus ADMM state (paper §4.2), one (n, n, p)
    tensor each: T[l] is agent l's primal block (its own model at T[l, l]),
    Z_own/Z_nbr the per-edge secondary variables, L_own/L_nbr the scaled
    duals."""

    T: torch.Tensor
    Z_own: torch.Tensor
    Z_nbr: torch.Tensor
    L_own: torch.Tensor
    L_nbr: torch.Tensor

    def models(self) -> torch.Tensor:
        """(n, p) personal models — the diagonal blocks Theta_l^l (a view;
        leading axes of T, the sweeps' trials, are kept)."""
        return _diag_blocks(self.T)


def _diag_blocks(T):
    """(..., n, p) view of the diagonal blocks T[..., l, l, :] of a
    (..., n, n, p) block array."""
    return torch.diagonal(T, dim1=-3, dim2=-2).movedim(-1, -2)


def init_state(graph: Graph, theta_sol, device=None) -> ADMMState:
    """Warm start (paper §4.2): share solitary models with neighbors; on
    ``device`` (CUDA when None)."""
    device = resolve_device(device)
    n = graph.n
    f = dict(dtype=torch.float32, device=device)
    if not isinstance(theta_sol, torch.Tensor):
        theta_sol = np.array(theta_sol, dtype=np.float32)      # writable
    theta_sol = torch.as_tensor(theta_sol, **f).reshape(n, -1)
    p = theta_sol.shape[1]
    edge = torch.as_tensor(graph.W > 0, device=device)
    adj = edge | torch.eye(n, dtype=torch.bool, device=device)
    T = torch.where(adj[:, :, None], theta_sol[None].expand(n, n, p), 0.0)
    Z_own = torch.where(edge[:, :, None], theta_sol[:, None].expand(n, n, p),
                        0.0)
    Z_nbr = torch.where(edge[:, :, None], theta_sol[None].expand(n, n, p),
                        0.0)
    return ADMMState(T, Z_own, Z_nbr, torch.zeros((n, n, p), **f),
                     torch.zeros((n, n, p), **f))


# ---------------------------------------------------------------------------
# Primal updates
# ---------------------------------------------------------------------------


def _primal_quadratic(st: ADMMState, l: int, tabs, D, m, sx, mu, rho,
                      backend=None):
    """Exact argmin of L_rho^l for the quadratic loss (block elimination),
    gathered over agent l's padded slot row; writes T[l]."""
    k = tabs.nbr_idx.shape[1]
    idx = tabs.nbr_idx[l].long()
    live = torch.arange(k, device=idx.device) < tabs.deg_count[l]
    theta_l, theta_js = quadratic_primal_core(
        tabs.nbr_w[l], live, st.Z_own[l, idx], st.Z_nbr[l, idx],
        st.L_own[l, idx], st.L_nbr[l, idx], D[l], m[l], sx[l], mu, rho,
        backend)
    row = st.T[l]
    # scatter: last-write-wins — pad slots collide on row l and are
    # overwritten by the assignment of row l just below
    row[torch.where(live, idx, l)] = torch.where(live[:, None], theta_js,
                                                 theta_l[None])
    row[l] = theta_l


def _primal_subgrad(st: ADMMState, l: int, W, D, mask, mu, rho,
                    data: AgentData, loss: str, k_steps: int, lr: float):
    """``k_steps`` (sub)gradient steps on L_rho^l over the row T[l]
    (hinge, logistic); writes T[l]."""
    loss_fn = LOSSES[loss]
    w = W[l] * mask[l]
    mrow = mask[l][:, None]
    Z_own, Z_nbr, L_own, L_nbr = st.Z_own[l], st.Z_nbr[l], st.L_own[l], \
        st.L_nbr[l]

    def lagrangian(row):
        theta_l = row[l]
        smooth = 0.5 * torch.sum(w * torch.sum((theta_l[None] - row) ** 2,
                                               dim=-1))
        local = mu * D[l] * loss_fn(theta_l, data.x[l], data.y[l],
                                    data.mask[l])
        lin = torch.sum(mrow * (L_own * (theta_l[None] - Z_own)
                                + L_nbr * (row - Z_nbr)))
        quad = 0.5 * rho * torch.sum(
            mrow * ((theta_l[None] - Z_own) ** 2 + (row - Z_nbr) ** 2))
        return smooth + local + lin + quad

    grad = torch.func.grad(lagrangian)
    row = st.T[l]
    for _ in range(k_steps):
        row = row - lr * grad(row)
    live = mask[l][:, None] | (torch.arange(row.shape[0],
                                            device=row.device) == l)[:, None]
    st.T[l] = torch.where(live, row, st.T[l])


def _primal_quadratic_all(st: ADMMState, tabs, D, m, sx, mu, rho,
                          backend=None):
    """:func:`_primal_quadratic` of every agent at once: one
    ``admm_primal`` call over the n padded slot rows; writes T."""
    n, k = tabs.nbr_idx.shape
    idx = tabs.nbr_idx.long()
    rows = torch.arange(n, device=idx.device)
    r = rows[:, None]
    live = torch.arange(k, device=idx.device) < tabs.deg_count[:, None]
    theta_l, theta_js = quadratic_primal_core(
        tabs.nbr_w, live, st.Z_own[r, idx], st.Z_nbr[r, idx],
        st.L_own[r, idx], st.L_nbr[r, idx], D, m, sx, mu, rho, backend)
    # scatter: last-write-wins — a row's pad slots collide on its diagonal
    # cell (all with theta_l) and are overwritten just below
    st.T[r, torch.where(live, idx, r)] = torch.where(live[..., None],
                                                     theta_js,
                                                     theta_l[:, None])
    st.T[rows, rows] = theta_l  # scatter: unique targets (the diagonal)


def _primal_subgrad_all(st: ADMMState, W, D, mask, mu, rho,
                        data: AgentData, loss: str, k_steps: int,
                        lr: float):
    """:func:`_primal_subgrad` of every agent at once: ``k_steps``
    (sub)gradient steps on the sum of the n Lagrangians over the whole
    (n, n, p) block T, whose gradient in row T[l] is agent l's own (row
    l's Lagrangian reads no other row); writes T."""
    loss_fn = LOSSES[loss]
    w = W * mask
    m3 = mask[..., None]

    def lagrangians(T):
        theta = _diag_blocks(T)
        th = theta[:, None]
        smooth = 0.5 * torch.sum(w * torch.sum((th - T) ** 2, dim=-1))
        local = mu * torch.sum(D * torch.func.vmap(loss_fn)(
            theta, data.x, data.y, data.mask))
        lin = torch.sum(m3 * (st.L_own * (th - st.Z_own)
                              + st.L_nbr * (T - st.Z_nbr)))
        quad = 0.5 * rho * torch.sum(
            m3 * ((th - st.Z_own) ** 2 + (T - st.Z_nbr) ** 2))
        return smooth + local + lin + quad

    grad = torch.func.grad(lagrangians)
    T = st.T
    for _ in range(k_steps):
        T = T - lr * grad(T)
    n = T.shape[0]
    live = mask | torch.eye(n, dtype=torch.bool, device=T.device)
    st.T = torch.where(live[..., None], T, st.T)


def _edge_zl_update(st: ADMMState, i: int, j: int, rho: float):
    """Z and dual update of edge (i, j), both endpoints (paper steps 2-3):
    every cell is read before any is written."""
    cells_i = (st.T[i, i], st.T[i, j], st.L_own[i, j], st.L_nbr[i, j])
    cells_j = (st.T[j, j], st.T[j, i], st.L_own[j, i], st.L_nbr[j, i])
    new_i = admm_edge_halfstep(*cells_i, *cells_j, rho)
    new_j = admm_edge_halfstep(*cells_j, *cells_i, rho)
    for arr, vi, vj in zip((st.Z_own, st.Z_nbr, st.L_own, st.L_nbr), new_i,
                           new_j):
        # scatter: unique targets — (i, j) and (j, i) are distinct cells of
        # one edge, i != j
        arr[i, j] = vi
        arr[j, i] = vj  # scatter: unique targets


def _all_zl_update(st: ADMMState, mask, rho: float):
    """Synchronous Z + dual update of every edge at once (App. D steps
    2-3).  Leading axes of the state and ``mask`` (..., n, n) are a batch
    of problems; ``rho`` is then a number or broadcasts as (..., 1, 1, 1).
    """
    T = st.T
    diag = _diag_blocks(T)[..., :, None, :]
    z_own_new = 0.5 * ((st.L_own + st.L_nbr.transpose(-3, -2)) / rho
                       + diag + T.transpose(-3, -2))
    m3 = mask[..., None]
    Z_own = torch.where(m3, z_own_new, st.Z_own)
    Z_nbr = torch.where(m3, z_own_new.transpose(-3, -2), st.Z_nbr)
    st.L_own = torch.where(m3, st.L_own + rho * (diag - Z_own),
                           st.L_own)
    st.L_nbr = torch.where(m3, st.L_nbr + rho * (T - Z_nbr), st.L_nbr)
    st.Z_own, st.Z_nbr = Z_own, Z_nbr


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CLTrace:
    """CL-ADMM run record: model snapshots + cumulative communications."""

    theta_hist: torch.Tensor   # (n_records, n, p)
    comms_hist: np.ndarray     # cumulative pairwise communications
    final: ADMMState


def _setup(graph: Graph, data: AgentData, theta_sol, state, device):
    device = resolve_device(device)
    if state is None:
        if theta_sol is None:
            raise ValueError("need theta_sol (warm start) or explicit state")
        state = init_state(graph, theta_sol, device)
    tabs = padded_neighbor_tables(graph)
    return (device, state, tabs, to_device(tabs, device),
            torch.as_tensor(graph.W, dtype=torch.float32, device=device),
            torch.as_tensor(graph.degrees, dtype=torch.float32,
                            device=device),
            torch.as_tensor(graph.W > 0, device=device))


def _make_primal(tabs, W, D, mask, mu, rho, data, loss, k_steps, lr,
                 backend):
    if loss == "quadratic":
        m, sx = local_stats(data)
        return lambda st, l: _primal_quadratic(st, l, tabs, D, m, sx, mu,
                                               rho, backend)
    return lambda st, l: _primal_subgrad(st, l, W, D, mask, mu, rho, data,
                                         loss, k_steps, lr)


def _make_primal_all(tabs, W, D, mask, mu, rho, data, loss, k_steps, lr,
                     backend):
    """:func:`_make_primal`'s update of every agent at once."""
    if loss == "quadratic":
        m, sx = local_stats(data)
        return lambda st: _primal_quadratic_all(st, tabs, D, m, sx, mu, rho,
                                                backend)
    return lambda st: _primal_subgrad_all(st, W, D, mask, mu, rho, data,
                                          loss, k_steps, lr)


def async_admm(graph: Graph, data: AgentData, mu: float, rho: float,
               loss: str = "quadratic", steps: int = 1000, seed: int = 0,
               record_every: int = 50, k_steps: int = 10, lr: float = 0.05,
               theta_sol=None, state: Optional[ADMMState] = None,
               draws=None, backend: Optional[ReproBackend] = None,
               device=None) -> CLTrace:
    """Asynchronous decentralized ADMM (paper §4.2) on ``device`` (CUDA
    when None); ``state`` is updated in place.

    One tick = one wake-up: agent i picks neighbor slot s (neighbor
    j ~ pi_i), both primal-update, then edge (i, j)'s Z and duals update —
    2 pairwise communications.  ``draws = (i_seq, s_seq)`` gives the
    wake-ups (e.g. the JAX package's); otherwise they come from a
    ``torch.Generator`` seeded with ``seed``.  A degree-0 waker is a no-op.
    """
    n = graph.n
    device, st, host, tabs, W, D, mask = _setup(graph, data, theta_sol,
                                                state, device)
    primal = _make_primal(tabs, W, D, mask, mu, rho, data, loss, k_steps,
                          lr, backend)
    record_every, n_rec = record_chunks(steps, record_every)
    hist = []
    for t, (i, s) in enumerate(wakeups(n, host, n_rec * record_every, seed,
                                       draws)):
        if host.deg_count[i] > 0:
            j = int(host.nbr_idx[i, s])
            primal(st, i)
            primal(st, j)
            _edge_zl_update(st, i, j, rho)
        if (t + 1) % record_every == 0:
            hist.append(st.models().clone())
    comms = 2 * record_every * (np.arange(n_rec) + 1)
    return CLTrace(torch.stack(hist), comms, st)


def sync_admm(graph: Graph, data: AgentData, mu: float, rho: float,
              loss: str = "quadratic", steps: int = 100, k_steps: int = 10,
              lr: float = 0.05, theta_sol=None,
              state: Optional[ADMMState] = None,
              backend: Optional[ReproBackend] = None,
              device=None) -> CLTrace:
    """Synchronous decentralized ADMM (paper App. D) on ``device`` (CUDA
    when None); ``state`` is updated in place.  One iteration = every
    agent primal-updates, then every edge's Z/dual update; 2|E| pairwise
    communications.  Each iteration's primal step is one batched update
    of all n agents (see the module's docstring)."""
    _, st, _, tabs, W, D, mask = _setup(graph, data, theta_sol, state,
                                        device)
    primal = _make_primal_all(tabs, W, D, mask, mu, rho, data, loss,
                              k_steps, lr, backend)
    hist = []
    for _ in range(steps):
        primal(st)
        _all_zl_update(st, mask, rho)
        hist.append(st.models().clone())
    comms = 2 * len(graph.edges()) * (np.arange(steps) + 1)
    return CLTrace(torch.stack(hist), comms, st)
