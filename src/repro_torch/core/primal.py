"""Pluggable CL-ADMM primal solvers (counterpart of ``repro.core.primal``;
DESIGN.md §18).

The paper's ADMM derivation (§4.2) needs the primal phase solved only
approximately, so the CL engines take the primal step as a strategy:

* :class:`ExactQuadraticPrimal` — the closed-form block elimination for
  the quadratic loss (``core.sparse.batched_admm_primal``; the default);
* :class:`InexactPrimal` — B AdamW steps on the reduced local Lagrangian
  (the ``admm_primal_inexact`` op), for any differentiable loss and for
  nonlinear agent models whose parameters ride the flat slot rows through
  ``models.flatten.ParamFlattener``.

A solver is a frozen dataclass with ``needs_data`` and

    solve_batch(w_rows (R, k), live_rows (R, k), z_own, z_nbr, l_own,
                l_nbr (R, k, p), D_rows (R,), m_rows (R,), sx_rows (R, q),
                xym, theta_rows (R, p), mu, rho, backend)
        -> (new_theta (R, p), theta_js (R, k, p))

computed row-locally, where ``xym`` is the rows' local data ``(x (R, m,
q), y (R, m), mask (R, m))`` when ``needs_data`` is True and ``()``
otherwise, and ``theta_rows`` is their round-start models (the inexact
solver's warm start).
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Optional

import torch

from repro_torch.kernels.dispatch import resolve
from repro_torch.optim.adamw import AdamWConfig, adamw_rows

from .losses import AgentData, guarded_loss
from .sparse import batched_admm_primal

_LOSS_NAMES = ("quadratic", "hinge", "logistic")


def flat_predictor(model):
    """``predict(theta_row (p,), x (m, q)) -> (m,)`` for a flattened agent
    model: the glue between the engines' slot rows and the model's
    ``apply`` (the inexact primal and accuracy evaluation use it)."""
    flat = model.flattener()

    def predict(theta, xs):
        return model.apply(flat.unflatten(theta), xs)
    return predict


@dataclasses.dataclass(frozen=True)
class ExactQuadraticPrimal:
    """The paper's closed-form quadratic primal as a solver: delegates to
    ``core.sparse.batched_admm_primal`` with the rows' sufficient
    statistics, so passing it is the same computation as ``primal=None``.
    """

    needs_data: ClassVar[bool] = False

    def solve_batch(self, w_rows, live_rows, z_own, z_nbr, l_own, l_nbr,
                    D_rows, m_rows, sx_rows, xym, theta_rows, mu, rho,
                    backend=None):
        """Closed-form solve of the rows (xym/theta_rows unused)."""
        return batched_admm_primal(w_rows, live_rows, z_own, z_nbr, l_own,
                                   l_nbr, D_rows, m_rows, sx_rows, mu, rho,
                                   backend)


@dataclasses.dataclass(frozen=True)
class InexactPrimal:
    """DiNNO-style inexact primal: ``b_steps`` AdamW steps per wake-up on
    ``mu D_l loss(theta) + lambda-coupling + rho-consensus`` (the reduced
    local Lagrangian; ``kernels.ref.inexact_primal``).

    ``model`` is a frozen agent model (``models.flatten.MLPAgent`` /
    ``LoRAAgent``) whose flat parameter rows the engines couple, or
    ``None`` for the flat linear/mean model.  ``b_steps=None`` selects the
    B -> inf fixed point and is restricted to the quadratic loss with
    ``model=None``, where it reproduces the exact primal.
    """

    loss: str = "logistic"
    model: Any = None
    b_steps: Optional[int] = 8
    lr: float = 0.05
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    needs_data: ClassVar[bool] = True

    def __post_init__(self):
        if self.loss not in _LOSS_NAMES:
            raise ValueError(
                f"unknown loss {self.loss!r}; one of {_LOSS_NAMES}")
        if self.b_steps is None and (self.loss != "quadratic"
                                     or self.model is not None):
            raise ValueError(
                "b_steps=None is the closed-form B->inf limit, provable "
                "only for the quadratic loss with model=None")
        if self.model is not None and self.loss == "quadratic":
            raise ValueError("quadratic loss is mean estimation — it takes "
                             "no model")

    def opt_config(self) -> AdamWConfig:
        """Per-row AdamW: no decay or clip (the Lagrangian already
        couples), float32 moments."""
        return AdamWConfig(lr=self.lr, b1=self.b1, b2=self.b2, eps=self.eps,
                           weight_decay=0.0, grad_clip=0.0,
                           moment_dtype=torch.float32)

    def loss_fn(self):
        """The guarded local loss ``l(theta; x, y, mask)`` (flat params)."""
        if self.model is None:
            return guarded_loss(self.loss)
        return guarded_loss(self.loss, flat_predictor(self.model))

    def batch_local_loss(self, theta_all, x, y, mask):
        """(n,) guarded local losses of the agents' rows — telemetry's
        Eq. 7 loss term."""
        return torch.func.vmap(self.loss_fn())(theta_all, x, y, mask)

    def solve_batch(self, w_rows, live_rows, z_own, z_nbr, l_own, l_nbr,
                    D_rows, m_rows, sx_rows, xym, theta_rows, mu, rho,
                    backend=None):
        """The ``admm_primal_inexact`` op over the rows (m_rows/sx_rows
        unused: the b_steps=None closed form recomputes them from xym)."""
        fn = resolve("admm_primal_inexact", backend, z_own.device)
        x, y, mask = xym
        return fn(w_rows, live_rows, z_own, z_nbr, l_own, l_nbr, D_rows, x,
                  y, mask, theta_rows, mu, rho, loss_fn=self.loss_fn(),
                  b_steps=self.b_steps, opt=self.opt_config())


def solitary_adamw(data: AgentData, *, loss: str = "logistic", model=None,
                   steps: int = 200, opt: Optional[AdamWConfig] = None,
                   seed: int = 0, theta0=None,
                   init_scale: float = 1.0) -> torch.Tensor:
    """Purely-local training: per-agent AdamW on the guarded local loss,
    all agents at once on ``data``'s device.

    The "no collaboration" baseline of the ``federated_moons`` experiment
    and the ``theta_sol`` warm start a nonlinear ``run_cl_scenario`` needs.
    ``theta0`` (n, p) starts it; without it the linear model starts at 0
    and an agent model's rows come from ``model.init`` on a
    ``torch.Generator`` seeded with ``seed``, one agent after another.
    Returns the (n, p) flat parameter rows after ``steps`` updates.
    """
    if opt is None:
        opt = AdamWConfig(lr=0.05, weight_decay=0.0, grad_clip=0.0,
                          moment_dtype=torch.float32)
    loss_fn = guarded_loss(loss) if model is None \
        else guarded_loss(loss, flat_predictor(model))
    n, device = data.n, data.x.device
    if theta0 is None:
        if model is None:
            theta0 = torch.zeros((n, data.x.shape[-1]), device=device)
        else:
            flat = model.flattener()
            gen = torch.Generator().manual_seed(seed)
            theta0 = torch.stack([flat.flatten(model.init(gen, init_scale))
                                  for _ in range(n)]).to(device)
    theta0 = torch.as_tensor(theta0, dtype=torch.float32, device=device)
    row_loss = torch.func.vmap(loss_fn)
    return adamw_rows(lambda th: row_loss(th, data.x, data.y, data.mask),
                      theta0, steps, opt)
