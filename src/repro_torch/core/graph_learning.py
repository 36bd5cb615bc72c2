"""Joint learning of the collaboration graph alongside the models
(counterpart of ``repro.core.graph_learning``; DESIGN.md §13).

The paper takes the similarity graph as given (§2.1).  Zantedeschi, Bellet
& Tommasi (arXiv:1901.08460) alternate two block updates instead: the
model step (here the paper's MP gossip, Eq. 6, unchanged) and a graph step
in which each agent i re-estimates its outgoing edge weights over a fixed
candidate neighbor set from the dissimilarity of its model to its
neighbor copies,

    w_i  <-  (1 - eta) w_i + eta argmin_{w in simplex} <w, d_i> + lam ||w||^2,

whose argmin is the sparse simplex projection of ``-d_i / (2 lam)`` (the
``edge_reweight`` op).  Everything here works on batches of agent slot
rows; the joint engine (``simulate.engines.run_joint_scenario``) applies
it to all n rows.  ``GraphRecovery``, ``cluster_edge_recovery`` and
``learned_weight_tables`` are host-side numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.dispatch import ReproBackend, resolve

#: Distance placed at dead (padded / pruned) slots so they never enter the
#: projection support.  Finite (not inf) so sorts and cumsums stay NaN-free.
DEAD_DISTANCE = 1e30


def slot_sq_distances(theta_rows, K_rows, live_rows):
    """Per-slot squared model distances d[i, s] = ||theta_i - K[i, s]||^2.

    theta_rows (B, p) own models; K_rows (B, k, p) neighbor copies;
    live_rows (B, k) bool.  Dead slots get :data:`DEAD_DISTANCE`.  Computed
    from purely local state, so the graph step needs no extra
    communication.
    """
    d = torch.sum((theta_rows[:, None, :] - K_rows) ** 2, dim=-1)
    return torch.where(live_rows, d, DEAD_DISTANCE)


def reweight_rows(theta_rows, K_rows, w_rows, live_rows, *, eta: float,
                  lam: float, backend: Optional[ReproBackend] = None):
    """One graph step for a batch of agents' slot rows: the local
    dissimilarities, then the ``edge_reweight`` op (simplex projection and
    convex blend; ``kernels.ref.edge_reweight``)."""
    d = slot_sq_distances(theta_rows, K_rows, live_rows)
    return resolve("edge_reweight", backend, d.device)(
        d, w_rows, live_rows, eta=eta, lam=lam)


def prune_rows(w_rows, live_rows, prune_eps: float):
    """Permanently drop slots whose learned weight fell to ``<= prune_eps``.

    Returns (w', live'): pruned slots leave the live mask for good (their
    distance is pinned at :data:`DEAD_DISTANCE`, so the projection never
    revives them) and their weight is an exact 0.
    """
    live = live_rows & (w_rows > prune_eps)
    return torch.where(live, w_rows, 0.0), live


# ---------------------------------------------------------------------------
# Host-side: handing a learned graph back / measuring cluster recovery
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GraphRecovery:
    """Cluster-recovery metrics of a learned weight table (host-side).

    intra_recovered: fraction of planted intra-cluster candidate (directed)
        edges carrying weight > eps after learning;
    inter_suppressed: fraction of inter-cluster candidate edges driven to
        weight <= eps;
    inter_mass: share of total learned weight sitting on inter edges.
    """

    intra_recovered: float
    inter_suppressed: float
    inter_mass: float
    n_intra: int
    n_inter: int


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def cluster_edge_recovery(nbr_idx, deg_count, w, labels,
                          eps: float = 1e-4) -> GraphRecovery:
    """Score a learned weight table against planted cluster labels.

    nbr_idx/deg_count: the candidate slot tables; w: (n, k) learned
    weights (tensor or array); labels: (n,) planted cluster ids.  The
    two-cluster acceptance bar is ``intra_recovered >= 0.9``.
    """
    nbr_idx = _host(nbr_idx)
    deg_count = _host(deg_count)
    w = _host(w)
    labels = _host(labels)
    k = nbr_idx.shape[1]
    cand = np.arange(k)[None, :] < deg_count[:, None]          # (n, k)
    intra = cand & (labels[:, None] == labels[nbr_idx])
    inter = cand & ~intra
    on = w > eps
    n_intra = int(intra.sum())
    n_inter = int(inter.sum())
    total = float(w[cand].sum())
    return GraphRecovery(
        intra_recovered=float((on & intra).sum()) / max(n_intra, 1),
        inter_suppressed=float((~on & inter).sum()) / max(n_inter, 1),
        inter_mass=float(w[inter].sum()) / max(total, 1e-30),
        n_intra=n_intra, n_inter=n_inter)


def learned_weight_tables(tables, w, live):
    """Fold learned weights back into host-side ``NeighborTables``.

    tables: the candidate ``core.sparse.NeighborTables``; w/live: (n, k)
    learned weights and surviving-slot mask (tensors or arrays).  Returns
    new tables via :meth:`NeighborTables.with_weights`, usable by every
    fixed-graph engine.
    """
    w = np.where(_host(live), _host(w).astype(np.float64), 0.0)
    return tables.with_weights(w)
