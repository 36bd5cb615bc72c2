"""Global consensus baseline (paper Eq. 2): one model for everyone
(counterpart of ``repro.core.consensus``).

The objective of classic decentralized optimization and of data-parallel
training.  The paper's §5.2 shows it does poorly when agents have
heterogeneous objectives; this baseline reproduces that.
"""

from __future__ import annotations

import torch

from .losses import LOSSES, AgentData


def consensus_model(data: AgentData, loss: str = "hinge", steps: int = 500,
                    lr: float = 0.05, l2: float = 1e-4) -> torch.Tensor:
    """Minimize the pooled mean loss over one shared theta (plus
    ``l2 / 2 ||theta||^2``) by gradient descent from theta = 0, on
    ``data``'s device."""
    loss_fn = LOSSES[loss]
    n, _, p = data.x.shape
    total = torch.clamp(torch.sum(data.mask), min=1.0)

    def obj(theta):
        per_agent = torch.func.vmap(
            lambda x, y, m: loss_fn(theta, x, y, m))(data.x, data.y,
                                                     data.mask)
        return torch.sum(per_agent) / total \
            + 0.5 * l2 * torch.sum(theta * theta)

    grad = torch.func.grad(obj)
    theta = torch.zeros(p, dtype=torch.float32, device=data.x.device)
    for _ in range(steps):
        theta = theta - lr * grad(theta)
    return theta


def consensus_mean(data: AgentData) -> torch.Tensor:
    """Closed form for the quadratic loss: the global mean of all samples."""
    s = torch.sum(data.x * data.mask[..., None], dim=(0, 1))
    return s / torch.clamp(torch.sum(data.mask), min=1.0)
