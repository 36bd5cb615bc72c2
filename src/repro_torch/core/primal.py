"""Pluggable CL-ADMM primal solvers (counterpart of ``repro.core.primal``;
the exact quadratic solver only).

A solver is a frozen dataclass with ``needs_data`` and

    solve_batch(w_rows (R, k), live_rows (R, k), z_own, z_nbr, l_own,
                l_nbr (R, k, p), D_rows (R,), m_rows (R,), sx_rows (R, p),
                xym, theta_rows (R, p), mu, rho, backend)
        -> (new_theta (R, p), theta_js (R, k, p))

computed row-locally.  ``InexactPrimal`` (AdamW steps on the reduced
Lagrangian, for nonlinear losses and agents) is not ported yet: ROADMAP
queue 1 item 5.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

from .sparse import batched_admm_primal


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
