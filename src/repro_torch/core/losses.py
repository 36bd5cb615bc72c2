"""Padded per-agent datasets, local losses, solitary models and
confidences (paper Eq. 1, §3.1; counterpart of ``repro.core.losses``).

Datasets are padded to a common max size with a mask, so the whole agent
population is processed as one batch (agents have widely varying m_i by
design — that unbalancedness is central to the paper).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class AgentData:
    """Padded per-agent datasets (float32 tensors on one device).

    x: (n, m_max, p)   features (for mean estimation: the samples)
    y: (n, m_max)      labels (+-1 for classification; unused for means)
    mask: (n, m_max)   1.0 for real examples, 0.0 for padding
    """

    x: torch.Tensor
    y: torch.Tensor
    mask: torch.Tensor

    @property
    def n(self) -> int:
        """Number of agents."""
        return self.x.shape[0]

    @property
    def counts(self) -> torch.Tensor:
        """(n,) live-sample counts m_i (drives confidences, §2.2)."""
        return self.mask.sum(dim=1)


def pad_datasets(xs, ys=None, device=None) -> AgentData:
    """Stack variable-length per-agent datasets into an AgentData on
    ``device`` (CUDA when None)."""
    device = resolve_device(device)
    n = len(xs)
    m_max = max(1, max(len(x) for x in xs))
    p = 1
    for xi in xs:
        a = np.asarray(xi)
        if a.size:
            p = a.shape[1] if a.ndim > 1 else 1
            break
    x = np.zeros((n, m_max, p))
    y = np.zeros((n, m_max))
    mask = np.zeros((n, m_max))
    for i, xi in enumerate(xs):
        m = len(xi)
        if m:
            x[i, :m] = np.asarray(xi, dtype=np.float64).reshape(m, -1)
            mask[i, :m] = 1.0
            if ys is not None:
                y[i, :m] = np.asarray(ys[i], dtype=np.float64)
    f = dict(dtype=torch.float32, device=device)
    return AgentData(torch.as_tensor(x, **f), torch.as_tensor(y, **f),
                     torch.as_tensor(mask, **f))


# ---------------------------------------------------------------------------
# Losses  l(theta; x, y).  All return the SUM over the local dataset
# (paper Eq. 1: L_i(theta) = sum_j l(theta; x_j, y_j)).
# ---------------------------------------------------------------------------


def quadratic_loss(theta, x, y, mask):
    """Mean estimation: l(theta; x) = ||theta - x||^2 (paper §5.1)."""
    r = theta[None, :] - x
    return torch.sum(mask * torch.sum(r * r, dim=-1))


def hinge_loss(theta, x, y, mask):
    """l(theta; (x, y)) = max(0, 1 - y theta^T x) (paper §5.2)."""
    margins = 1.0 - y * (x @ theta)
    # maximum, not clamp: at a tie its subgradient is 1/2, as in JAX
    return torch.sum(mask * torch.maximum(torch.zeros_like(margins),
                                          margins))


def logistic_loss(theta, x, y, mask):
    """log(1 + exp(-y theta^T x)) — an extra loss beyond the paper's two."""
    z = y * (x @ theta)
    return torch.sum(mask * torch.logaddexp(torch.zeros_like(z), -z))


LOSSES = {"quadratic": quadratic_loss, "hinge": hinge_loss,
          "logistic": logistic_loss}


def masked_sum(vals, mask):
    """Sum ``vals`` over live rows with an exact-zero pad contribution (the
    ``where`` also zeroes the pads' gradient)."""
    return torch.sum(torch.where(mask > 0, vals, 0.0))


def guarded_loss(loss: str, predict_fn=None):
    """The guarded local loss ``l(theta; x, y, mask)`` the inexact primal
    differentiates (DESIGN.md §18).

    The double-where pattern: pad rows of ``x``/``y`` are replaced with
    zeros *before* the model runs and the per-sample losses are masked
    *after*, so padding contributes an exactly-zero value and gradient
    under ``torch.autograd`` even when the pads hold NaN or Inf.

    ``predict_fn(theta, x) -> (m,)`` scores a batch with a flat parameter
    row (e.g. ``core.primal.flat_predictor(model)``); ``None`` means the
    linear model ``x @ theta`` for hinge/logistic and mean estimation
    (theta is the model) for quadratic.
    """
    if loss == "quadratic":
        if predict_fn is not None:
            raise ValueError("quadratic loss is mean estimation — theta is "
                             "the model; it takes no predict_fn")

        def quadratic(theta, x, y, mask):
            """Guarded ``sum_j mask_j ||theta - x_j||^2``."""
            xs = torch.where(mask[:, None] > 0, x, 0.0)
            r = theta[None, :] - xs
            return masked_sum(torch.sum(r * r, dim=-1), mask)
        return quadratic
    if loss not in ("hinge", "logistic"):
        raise ValueError(f"unknown loss {loss!r}; one of {tuple(LOSSES)}")
    hinge = loss == "hinge"

    def margin_loss(theta, x, y, mask):
        """Guarded hinge / logistic loss of the model's scores."""
        xs = torch.where(mask[:, None] > 0, x, 0.0)
        ys = torch.where(mask > 0, y, 0.0)
        f = xs @ theta if predict_fn is None else predict_fn(theta, xs)
        z = ys * f
        zero = torch.zeros_like(z)
        # maximum, not clamp: at a tie its subgradient is 1/2, as in JAX
        vals = torch.maximum(zero, 1.0 - z) if hinge \
            else torch.logaddexp(zero, -z)
        return masked_sum(vals, mask)
    return margin_loss


def total_loss(loss_fn, theta_all, data: AgentData):
    """Sum_i L_i(theta_i) for per-agent parameters theta_all (n, p)."""
    per_agent = torch.func.vmap(loss_fn)(theta_all, data.x, data.y,
                                         data.mask)
    return torch.sum(per_agent)


def solitary_gd(data: AgentData, loss: str = "hinge", steps: int = 200,
                lr: float = 0.05, l2: float = 1e-3) -> torch.Tensor:
    """Solitary models by (sub)gradient descent on each agent's mean local
    loss plus ``l2 / 2 ||theta||^2`` (well-posed for tiny m_i), all agents
    at once, from theta = 0."""
    loss_fn = LOSSES[loss]
    n, _, p = data.x.shape

    def agent_obj(theta, x, y, mask):
        m = torch.clamp(torch.sum(mask), min=1.0)
        return loss_fn(theta, x, y, mask) / m \
            + 0.5 * l2 * torch.sum(theta * theta)

    grad = torch.func.vmap(torch.func.grad(agent_obj))
    thetas = torch.zeros((n, p), dtype=data.x.dtype, device=data.x.device)
    for _ in range(steps):
        thetas = thetas - lr * grad(thetas, data.x, data.y, data.mask)
    return thetas


def local_stats(data: AgentData):
    """``(m (n,), sx (n, p))``: each agent's live-sample count and sample
    sum — the quadratic CL-ADMM primal's sufficient statistics (one shared
    computation for the dense and sparse engines)."""
    return data.mask.sum(dim=1), torch.sum(data.x * data.mask[..., None],
                                           dim=1)


def solitary_mean(data: AgentData) -> torch.Tensor:
    """Closed-form solitary model for the quadratic loss: the local mean.

    Agents with m_i = 0 get theta = 0 (their confidence is ~0, so the
    value is overridden by propagation).
    """
    cnt = data.counts[:, None]
    s = torch.sum(data.x * data.mask[..., None], dim=1)
    return torch.where(cnt > 0, s / cnt.clamp(min=1.0), 0.0)


def confidences_from_counts(counts, floor: float = 1e-3,
                            device=None) -> torch.Tensor:
    """c_i = m_i / max_j m_j, clipped to [floor, 1] — paper §3.1.

    A tensor ``counts`` keeps its device; anything else goes to ``device``
    (CUDA when None).
    """
    if not isinstance(counts, torch.Tensor):
        counts = torch.as_tensor(np.asarray(counts),
                                 device=resolve_device(device))
    counts = counts.to(torch.float32)
    c = counts / torch.clamp(counts.max(), min=1.0)
    return torch.clamp(c, floor, 1.0)
