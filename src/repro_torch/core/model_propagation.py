"""Model Propagation (paper §3): the Prop. 1 closed form and the Eq. 5
synchronous iteration (counterpart of ``repro.core.model_propagation``).

Both solve  Q_MP(Theta) =
    1/2 ( sum_{i<j} W_ij ||theta_i - theta_j||^2
          + mu sum_i D_ii c_i ||theta_i - theta_i^sol||^2 ):

* ``closed_form``  — Prop. 1:  Theta* = abar (I - abar(I-C) - a P)^{-1} C Theta_sol
* ``synchronous``  — fixed-point iteration Eq. (5), one ``mix`` op a step
                     (the ``graph_mix`` CUDA kernel on the card)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.dispatch import ReproBackend, resolve

from .graph import Graph


def mp_mix_operator(P_rows, c, alpha):
    """Eq. (5) as a "mix" op:  theta' = A_mix @ theta + b * theta_sol.

    A_mix = diag(alpha / (alpha + abar c)) P,  b = abar c / (alpha + abar c).
    ``P_rows`` may be the dense (n, n) stochastic matrix or the (n, k)
    padded-neighbor slot weights (row scaling is identical).
    """
    abar = 1.0 - alpha
    denom = alpha + abar * c
    A_mix = (alpha / denom)[:, None] * P_rows
    b = abar * c / denom
    return A_mix, b


def mp_objective(theta, theta_sol, W, c, mu):
    """Q_MP — used by tests to verify optimality of the closed form."""
    W = torch.as_tensor(W, dtype=theta.dtype, device=theta.device)
    diff = theta[:, None, :] - theta[None, :, :]
    # sum_{i<j} W_ij ||.||^2 == 1/2 sum_{i,j} W_ij ||.||^2 for symmetric W,
    # and Q_MP carries an outer 1/2 -> 0.25 overall.
    smooth = 0.25 * torch.sum(W * torch.sum(diff * diff, dim=-1))
    D = torch.sum(W, dim=1)
    anchor = 0.5 * mu * torch.sum(
        D * c * torch.sum((theta - theta_sol) ** 2, dim=-1))
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
