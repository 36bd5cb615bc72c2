"""Padded-neighbor (CSR-style) tables and the shared slot helpers of the
model-propagation and CL-ADMM engines (counterpart of
``repro.core.sparse``).

The host-side tables are numpy and build exactly the arrays the JAX
package builds from the same adjacency:

    nbr_idx  (n, k_max) int32  — sorted neighbor ids; pad slots repeat the
                                 row's last real neighbor (weight exactly 0)
    rev_slot (n, k_max) int32  — rev_slot[i, s] = position of i in the
                                 neighbor list of j = nbr_idx[i, s]
    nbr_w    (n, k_max) f32    — raw edge weights W_ij (0 at pads)
    nbr_p    (n, k_max) f32    — stochastic weights P_ij = W_ij / D_ii
    slot_cdf (n, k_max) f32    — cumsum of the uniform neighbor-selection
                                 distribution pi_i over slots (flat at pads)
    deg_count (n,)      int32  — number of live slots per row

``tables_from_adjacency`` is vectorised over rows (the JAX package loops
over them in Python), so a million-agent topology builds in seconds; the
arrays are identical (tests/test_torch_tables.py).  ``DeviceTables`` holds
the same arrays as tensors on the run's device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.dispatch import ReproBackend, resolve
# the edge half-step is the plain math of the cl_edge_step op; one copy
from repro_torch.kernels.ref import admm_edge_halfstep  # noqa: F401


class NeighborTables(NamedTuple):
    """Host-side (numpy) padded-neighbor tables; see module docstring."""

    nbr_idx: np.ndarray    # (n, k_max) int32
    rev_slot: np.ndarray   # (n, k_max) int32
    deg_count: np.ndarray  # (n,) int32
    nbr_w: np.ndarray      # (n, k_max) float32, raw W
    nbr_p: np.ndarray      # (n, k_max) float32, W / D
    slot_cdf: np.ndarray   # (n, k_max) float32
    deg_w: np.ndarray      # (n,) float64 weighted degree D_ii

    @property
    def n(self) -> int:
        """Number of agents (rows)."""
        return self.nbr_idx.shape[0]

    @property
    def k_max(self) -> int:
        """Padded slot count (max degree over agents)."""
        return self.nbr_idx.shape[1]

    def with_weights(self, nbr_w_new: np.ndarray) -> "NeighborTables":
        """New tables carrying updated per-slot weights (time-varying
        graphs, DESIGN.md §13).

        The candidate structure (``nbr_idx``, ``rev_slot``, ``deg_count``
        and the uniform wake-up cdf ``slot_cdf``) stays frozen, which keeps
        the event process replayable; ``nbr_w``, ``nbr_p`` and ``deg_w``
        are recomputed from ``nbr_w_new`` (dead slots zeroed; zero-degree
        rows get an all-zero stochastic row).
        """
        live = np.arange(self.k_max)[None, :] < self.deg_count[:, None]
        w = np.where(live, np.asarray(nbr_w_new, np.float64), 0.0)
        deg_w = w.sum(axis=1)
        nbr_p = np.where(live, w / np.where(deg_w > 0, deg_w, 1.0)[:, None],
                         0.0)
        return self._replace(nbr_w=w.astype(np.float32),
                             nbr_p=nbr_p.astype(np.float32), deg_w=deg_w)


def constant_row_sums(deg_count: np.ndarray, weight: float) -> np.ndarray:
    """Per-row float64 sums of ``deg_count[i]`` copies of ``weight``, each
    taken exactly as ``np.sum`` of the row's list (numpy's pairwise order),
    one numpy call per distinct degree instead of one per row."""
    out = np.zeros(len(deg_count))
    for d in np.unique(deg_count):
        # scatter: unique targets (the rows of one degree class)
        out[deg_count == d] = np.full(int(d), weight, np.float64).sum()
    return out


def tables_from_adjacency(nbr_lists: Sequence[np.ndarray],
                          weight_lists: Sequence[np.ndarray],
                          deg_w: Optional[np.ndarray] = None,
                          allow_isolated: bool = False) -> NeighborTables:
    """Build NeighborTables from per-agent sorted neighbor/weight lists.

    O(n * k_max) memory throughout.  ``deg_w`` overrides the weighted
    degrees (Graph-derived tables pass the dense ``W.sum(axis=1)``).
    ``allow_isolated=True`` admits degree-0 agents: all-zero rows with a
    flat slot cdf, which every event engine treats as a no-op waker.
    """
    deg_count = np.array([len(a) for a in nbr_lists], np.int32)
    if deg_count.sum():
        dst = np.concatenate([np.asarray(a, np.int64) for a in nbr_lists])
        wts = np.concatenate([np.asarray(w, np.float64).reshape(-1)
                              for w in weight_lists])
    else:
        dst, wts = np.zeros(0, np.int64), np.zeros(0)
    if deg_w is None:
        deg_w = np.array([np.asarray(w, np.float64).sum()
                          for w in weight_lists])
    return tables_from_csr(deg_count, dst, wts, deg_w, allow_isolated)


def tables_from_csr(deg_count: np.ndarray, dst: np.ndarray,
                    wts: np.ndarray, deg_w: np.ndarray,
                    allow_isolated: bool = False) -> NeighborTables:
    """:func:`tables_from_adjacency` over the flat (CSR) edge list: row i's
    sorted neighbors are ``dst[start_i : start_i + deg_count[i]]`` with
    weights ``wts`` (float64) and weighted degree ``deg_w[i]``.
    Vectorised over rows."""
    n = len(deg_count)
    deg_count = np.asarray(deg_count, np.int32)
    if (deg_count == 0).any() and not allow_isolated:
        raise ValueError("every agent needs at least one neighbor")
    k_max = max(1, int(deg_count.max()))
    E = int(deg_count.sum())

    src = np.repeat(np.arange(n, dtype=np.int64), deg_count)
    start = np.concatenate([[0], np.cumsum(deg_count)[:-1]]).astype(np.int64)
    slot = np.arange(E, dtype=np.int64) - start[src]
    live = np.arange(k_max)[None, :] < deg_count[:, None]
    has = deg_count > 0

    nbr_idx = np.zeros((n, k_max), np.int32)
    nbr_idx[src, slot] = dst  # scatter: unique targets (one (row, slot) each)
    if E:
        # pads duplicate the last neighbor; isolated rows stay all-zero
        last = np.minimum(np.where(has, start + deg_count - 1, 0), E - 1)
        pad_val = np.where(has, dst[last], 0)
        nbr_idx = np.where(live | ~has[:, None], nbr_idx,
                           pad_val[:, None]).astype(np.int32)
    nbr_w = np.zeros((n, k_max), np.float32)
    nbr_w[src, slot] = wts  # scatter: unique targets (one (row, slot) each)

    deg_w = np.asarray(deg_w, np.float64)
    nbr_p = np.where(live, nbr_w.astype(np.float64)
                     / np.where(deg_w > 0, deg_w, 1.0)[:, None],
                     0.0).astype(np.float32)

    # uniform neighbor-selection cdf over slots (pi_i, paper §3.2); float32
    # cumsum so both engines compare u against bit-identical thresholds
    probs = np.where(live,
                     (1.0 / np.maximum(deg_count, 1)[:, None])
                     .astype(np.float32),
                     np.float32(0.0)).astype(np.float32)
    slot_cdf = np.cumsum(probs, axis=1, dtype=np.float32)

    # rev_slot via one lexsort over the directed edge list: within each
    # destination block, the rank of (dst, src) is src's slot in dst's row
    order = np.lexsort((src, dst))
    rank = np.empty(E, np.int64)
    # scatter: unique targets (order is a permutation)
    rank[order] = np.arange(E) - start[dst[order]]
    rev = np.zeros((n, k_max), np.int32)
    rev[src, slot] = rank  # scatter: unique targets
    # pads copy the last real slot's rev (an isolated row copies its pad 0)
    last_slot = np.maximum(deg_count.astype(np.int64) - 1, 0)
    rev_last = rev[np.arange(n), last_slot]
    rev = np.where(live, rev, rev_last[:, None]).astype(np.int32)

    return NeighborTables(nbr_idx, rev, deg_count, nbr_w, nbr_p,
                          slot_cdf, deg_w)


def padded_neighbor_tables(graph, allow_isolated: bool = False
                           ) -> NeighborTables:
    """NeighborTables of a ``core.graph.Graph`` (small/medium n only)."""
    W = np.asarray(graph.W)
    nbrs = [np.nonzero(W[i])[0] for i in range(W.shape[0])]
    wts = [W[i, nb] for i, nb in enumerate(nbrs)]
    return tables_from_adjacency(nbrs, wts, deg_w=W.sum(axis=1),
                                 allow_isolated=allow_isolated)


class DeviceTables(NamedTuple):
    """The NeighborTables as tensors on one device (what the engines take).

    Index tables are int32 (as in the JAX package); weights are f32.
    """

    nbr_idx: torch.Tensor
    rev_slot: torch.Tensor
    deg_count: torch.Tensor
    nbr_w: torch.Tensor
    nbr_p: torch.Tensor
    slot_cdf: torch.Tensor
    deg_w: torch.Tensor


def to_device(tables, device=None, dtype=torch.float32) -> DeviceTables:
    """Mirror host-side tables onto ``device`` (CUDA when None); weights
    cast to ``dtype``.  Accepts any object with NeighborTables' fields."""
    device = resolve_device(device)

    def idx(a):
        return torch.as_tensor(np.asarray(a), device=device).int()

    def flt(a):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    return DeviceTables(idx(tables.nbr_idx), idx(tables.rev_slot),
                        idx(tables.deg_count), flt(tables.nbr_w),
                        flt(tables.nbr_p), flt(tables.slot_cdf),
                        flt(tables.deg_w))


# ---------------------------------------------------------------------------
# Shared tensor building blocks
# ---------------------------------------------------------------------------


def live_slots(deg_count: torch.Tensor, k_max: int) -> torch.Tensor:
    """(n, k_max) bool mask of live (non-pad) slots — ``slot < deg_count``."""
    return (torch.arange(k_max, device=deg_count.device)[None, :]
            < deg_count[:, None])


def sample_event(n: int, slot_cdf, deg_count, *, draw=None,
                 generator: Optional[torch.Generator] = None):
    """One wake-up: (agent i, neighbor slot s) — paper §3.2 / §4.2.

    ``draw=(i, s)`` takes an explicit draw (e.g. the JAX package's, which
    torch cannot replay); otherwise i is uniform over agents and s is drawn
    from pi_i by inverting the float32 slot cdf, both from ``generator``.
    Either way s is clamped to ``[0, max(deg_count[i] - 1, 0)]``, so pads
    are never selected; a degree-0 agent's event is a no-op for every
    engine.  Returns python ints.
    """
    if draw is not None:
        i, s = (int(v) for v in draw)
    else:
        i = int(torch.randint(n, (), generator=generator))
        u = torch.rand((), generator=generator)
        cdf = torch.as_tensor(slot_cdf[i]).cpu()
        s = int(torch.searchsorted(cdf, u.reshape(1), right=True))
    deg = int(deg_count[i])
    return i, max(min(s, deg - 1), 0)


def wakeups(n: int, tables, steps: int, seed: int = 0, draws=None):
    """The wake-ups ``(i, s)`` of the exact engines, one a tick, as python
    ints (``sample_event`` over the host tables' ``slot_cdf`` and
    ``deg_count``): ``draws = (i_seq, s_seq)`` gives them (e.g. the JAX
    package's, replayed with its key schedule); otherwise a
    ``torch.Generator`` seeded with ``seed`` draws them."""
    gen = torch.Generator().manual_seed(seed) if draws is None else None
    for t in range(steps):
        yield sample_event(n, tables.slot_cdf, tables.deg_count,
                           generator=gen, draw=None if draws is None
                           else (draws[0][t], draws[1][t]))


def record_chunks(steps: int, record_every: int) -> tuple:
    """The recording policy for chunked engines (``repro.core.sparse``).

    ``record_every`` is clamped to ``[1, steps]`` and the horizon floored
    to a whole number of chunks; ``steps < 1`` raises.
    """
    if steps < 1:
        raise ValueError(f"steps must be >= 1, got {steps}")
    record_every = max(1, min(int(record_every), int(steps)))
    return record_every, steps // record_every


def neighbor_aggregate(w_slots, theta_slots,
                       backend: Optional[ReproBackend] = None):
    """sum_s w[..., s] * theta[..., s, :] over the slot axis:
    (..., k), (..., k, p) -> (..., p) — the "neighbor_aggregate" op."""
    return resolve("neighbor_aggregate", backend,
                   theta_slots.device)(w_slots, theta_slots)


def batched_model_update(nbr_p_rows, K_rows, c_rows, sol_rows, alpha,
                         backend: Optional[ReproBackend] = None):
    """Eq. (6) model update for a batch of agents' slot rows.

    nbr_p_rows (B, k), K_rows (B, k, p), c_rows (B,), sol_rows (B, p) ->

        theta_i = (alpha * sum_s P[i,s] K[i,s] + (1-alpha) c_i sol_i)
                  / (alpha + (1-alpha) c_i)
    """
    agg = neighbor_aggregate(nbr_p_rows, K_rows, backend)
    abar = 1.0 - alpha
    return (alpha * agg + abar * c_rows[:, None] * sol_rows) \
        / (alpha + abar * c_rows)[:, None]


def agent_model_update(l: int, nbr_p, slots, c, sol, alpha,
                       backend: Optional[ReproBackend] = None):
    """Eq. (6) for one agent ``l`` from its (k, p) knowledge ``slots`` of
    its neighbors: :func:`batched_model_update` on a batch of one row, the
    one update the dense and the sparse exact gossip engines share (so
    they agree bit for bit)."""
    return batched_model_update(nbr_p[l:l + 1], slots[None], c[l:l + 1],
                                sol[l:l + 1], alpha, backend)[0]


def personalized_predict(theta_rows, x_rows):
    """(B,) predictions ``<theta_u, x_u>`` of B users' personalized linear
    models (B, p) on their feature rows (B, p) — the serving decode step
    (``repro.core.sparse.personalized_predict``)."""
    return torch.sum(theta_rows * x_rows, dim=-1)


def quadratic_primal_core(w, live, z_own_s, z_nbr_s, l_own_s, l_nbr_s,
                          D_l, m_l, sx, mu, rho,
                          backend: Optional[ReproBackend] = None):
    """Exact argmin of the CL-ADMM local Lagrangian for the quadratic loss
    over one agent's slot row, or a batch of them along leading axes
    (block elimination; paper §4.2 step 1) — the "admm_primal" op.

    w (..., k) raw edge weights (0 at pads); live (..., k) bool; z/l slot
    rows (..., k, p); D_l, m_l (...); sx (..., p) sum of the agent's
    samples.  Returns ``(theta_l (..., p), theta_js (..., k, p))``.
    """
    return resolve("admm_primal", backend, z_own_s.device)(
        w, live, z_own_s, z_nbr_s, l_own_s, l_nbr_s, D_l, m_l, sx, mu, rho)


#: The JAX package's name for the primal over a batch of rows (there a
#: vmap of the row solve; here the same function, batched along its
#: leading axes).
batched_admm_primal = quadratic_primal_core
