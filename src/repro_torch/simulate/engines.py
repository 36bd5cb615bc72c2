"""Sparse event-driven engines: model propagation, CL-ADMM and joint
collaboration-graph learning (counterpart of ``repro.simulate.engines``).

State is O(n * k * p) padded-neighbor storage:

  theta (n, p)        — each agent's own model
  K     (n, k_max, p) — K[i, s] = agent i's copy of neighbor nbr_idx[i, s]
  Z_own, Z_nbr, L_own, L_nbr (n, k_max, p) — CL-ADMM's per-slot secondary
                        and dual variables of the edge (i, nbr_idx[i, s])

* ``sparse_sync_mp`` — the synchronous Eq. 5 sweep, one ``sparse_mix`` op
  (the ``sparse_gather_mix`` CUDA kernel on the card, rows taken in the
  topology's locality order) per sweep.
* ``run_mp_scenario`` — MP gossip under a fault scenario, B wake-ups per
  round, replaying an ``EventStream``.  Two round bodies: the per-op
  gather/mix/scatter sequence (``backend=None``) and the fused
  ``round_step`` op (``backend`` given; the ``round_step`` CUDA kernel on
  the card).  Both consume the same events, so their counters match
  exactly and their trajectories agree to fp rounding.
* ``sparse_async_gossip`` — the paper's asynchronous MP gossip one
  wake-up at a time over the slot rows; bit for bit
  ``core.model_propagation.async_gossip``.
* ``sparse_async_admm`` — asynchronous CL-ADMM one wake-up at a time over
  the slot rows; bit for bit ``core.collaborative.async_admm``.
* ``run_cl_scenario`` — asynchronous CL-ADMM under a fault scenario, B
  wake-ups per round: a batched primal phase (torch ops: the exact
  quadratic solve, or AdamW steps on the local Lagrangian for nonlinear
  losses and agents), then one ``cl_edge_step`` op (the CUDA kernel on
  the card).  The state is updated in place; no (n, k, p) array is copied
  in any round.
* ``run_joint_scenario`` — MP gossip under a fault scenario with the
  collaboration graph learned alongside (DESIGN.md §13): the per-op MP
  round under learned weights, with a graph step (the ``edge_reweight``
  op) every ``graph_every`` rounds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.graph_learning import prune_rows, reweight_rows
from repro_torch.core.losses import AgentData, local_stats
from repro_torch.core.model_propagation import mp_mix_operator
from repro_torch.core.primal import ExactQuadraticPrimal
from repro_torch.core.sparse import (admm_edge_halfstep, agent_model_update,
                                     batched_model_update, live_slots,
                                     quadratic_primal_core, record_chunks,
                                     wakeups)
from repro_torch.kernels.dispatch import (ReproBackend, cl_stale_prefetch,
                                          encode_slots, resolve,
                                          round_prefetch, round_scales,
                                          round_stale_src)
from repro_torch.kernels.ref import landed
from repro_torch.telemetry import metrics as tmetrics
from repro_torch.telemetry.config import TelemetryConfig, telemetry_on
from repro_torch.telemetry.frames import TelemetryFrames
from .scheduler import (EventStream, NetworkConditions,
                        precompute_event_stream, stream_totals)
from .topology import SparseTopology


def _payload(topo: SparseTopology, theta_sol, c, device):
    """(tables, theta_sol (n, p), c (n,)) as f32 tensors on ``device``."""
    n = topo.n
    tabs = topo.device_tables(device)
    theta_sol = torch.as_tensor(theta_sol, dtype=torch.float32,
                                device=device).reshape(n, -1).contiguous()
    c = torch.as_tensor(c, dtype=torch.float32, device=device)
    return tabs, theta_sol, c


def _mp_warm_start(tabs, theta_sol):
    """Solitary models everywhere the agent has knowledge (paper §3.2)."""
    return theta_sol, theta_sol[tabs.nbr_idx]          # (n, p), (n, k, p)


# ---------------------------------------------------------------------------
# Exact sparse MP gossip (mirrors core.model_propagation.async_gossip)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SparseTrace:
    """theta_hist: (n_records, n, p); comms_hist: cumulative pairwise
    communications; the final models (n, p) and neighbor slots (n, k, p)."""

    theta_hist: torch.Tensor
    comms_hist: np.ndarray
    final_theta: torch.Tensor
    final_knowledge: torch.Tensor


def sparse_async_gossip(topo: SparseTopology, theta_sol, c, alpha: float,
                        steps: int, seed: int = 0, record_every: int = 100,
                        draws=None, backend: Optional[ReproBackend] = None,
                        device=None) -> SparseTrace:
    """The paper's async gossip MP algorithm (§3.2) over O(n k p) slot
    state, one wake-up a tick, on ``device`` (CUDA when None).

    ``draws = (i_seq, s_seq)`` gives the wake-ups; otherwise a
    ``torch.Generator`` seeded with ``seed`` draws them.  On the same
    graph and draws it equals ``core.model_propagation.async_gossip`` bit
    for bit: the same slot arithmetic (``core.sparse.agent_model_update``)
    on slot ``s`` of row i holding what the dense T[i, nbr_idx[i, s]]
    holds.  A degree-0 waker is a no-op.
    """
    device = resolve_device(device)
    tabs, sol, c = _payload(topo, theta_sol, c, device)
    theta, K = _mp_warm_start(tabs, sol)
    theta = theta.clone()
    host = topo.tables

    def update(l):
        return agent_model_update(l, tabs.nbr_p, K[l], c, sol, alpha,
                                  backend)

    record_every, n_rec = record_chunks(steps, record_every)
    hist = []
    for t, (i, s) in enumerate(wakeups(topo.n, host, n_rec * record_every,
                                       seed, draws)):
        if host.deg_count[i] > 0:          # a degree-0 waker is a no-op
            j, r = int(host.nbr_idx[i, s]), int(host.rev_slot[i, s])
            # communication step: exchange current self-models
            K[i, s] = theta[j]
            K[j, r] = theta[i]
            # update step for both endpoints, i first
            theta[i] = update(i)
            theta[j] = update(j)
        if (t + 1) % record_every == 0:
            hist.append(theta.clone())
    comms = 2 * record_every * (np.arange(n_rec) + 1)
    return SparseTrace(torch.stack(hist), comms, theta, K)


# ---------------------------------------------------------------------------
# Synchronous sparse sweep (Eq. 5 over CSR) — the gather-mix hot loop
# ---------------------------------------------------------------------------


def sparse_sync_mp(topo: SparseTopology, theta_sol, c, alpha: float,
                   sweeps: int, backend: Optional[ReproBackend] = None,
                   device=None) -> torch.Tensor:
    """Fixed-point iteration Eq. (5) over the sparse neighbor layout.

    theta_{t+1}[i] = (alpha * sum_s P[i,s] theta_t[nbr[i,s]]
                      + (1-alpha) c_i theta_sol[i]) / (alpha + (1-alpha) c_i)

    One sweep = one "sparse_mix" op over all agents, resolved through
    ``kernels.dispatch`` for ``device`` (CUDA when None), given the
    topology's ``locality_order`` as its row schedule (built on the host
    on the topology's first sweep; needs scipy).
    """
    device = resolve_device(device)
    tabs, theta_sol, c = _payload(topo, theta_sol, c, device)
    w, b = mp_mix_operator(tabs.nbr_p, c, alpha)
    w, b = w.contiguous(), b.contiguous()
    order = torch.as_tensor(topo.locality_order, device=device)
    mix = resolve("sparse_mix", backend, device)
    theta = theta_sol
    for _ in range(sweeps):
        theta = mix(theta, tabs.nbr_idx, w, b, theta_sol, order=order)
    return theta


# ---------------------------------------------------------------------------
# Scenario engine: batched wake-ups + network conditions (MP gossip)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SimTrace:
    """Result of a scenario run.

    theta_hist:   (n_records, n, p) tensor on the run's device
    active_hist:  (n_records,) fraction of live agents (tensor)
    delivered:    total messages delivered;  dropped: total lost
    rounds, events: totals (events = wake-ups = 2 attempted messages each)
    invalid:      never-valid wake-ups — excluded from delivered AND
                  dropped, so  delivered + dropped == 2 * (events - invalid)
    telemetry:    TelemetryFrames when the run was launched with
                  ``TelemetryConfig(enabled=True)``, else None
    serve:        ``repro_torch.serve.ServeReport`` when the run carried
                  an inference-request stream (``ScenarioSpec.serve``),
                  else None; serving reads committed snapshots only, so
                  it never changes theta_hist
    """

    theta_hist: torch.Tensor
    active_hist: torch.Tensor
    delivered: int
    dropped: int
    rounds: int
    events: int
    invalid: int = 0
    telemetry: Optional[TelemetryFrames] = None
    serve: Optional[object] = None


class _Telemetry:
    """A run's telemetry state on the device (DESIGN.md §14): per-agent
    staleness counters and the applied-update count, advanced every round
    from the round's ``got`` sides (no host synchronisation), and the
    per-chunk snapshots, copied to the host once by :meth:`frames`."""

    def __init__(self, n: int, device):
        self.n = n
        self.stale = torch.zeros(n, dtype=torch.int32, device=device)
        self.updates = torch.zeros((), dtype=torch.int64, device=device)
        self.snaps = []

    def round(self, upd, got):
        """Advance the counters by one round: ``upd`` (2B,) agents, ``got``
        (2B,) whether each applied a neighbor update."""
        self.stale = tmetrics.staleness_step(self.stale, got, upd, self.n)
        self.updates += got.sum()

    def chunk(self, objective, suppressed=None):
        """Snapshot the end of a record chunk with its (n,) objective."""
        self.snaps.append((objective, self.stale.clone(),
                           self.updates.clone(),
                           None if suppressed is None
                           else suppressed.clone()))

    def frames(self, stream, n_rec: int, record_every: int):
        """The run's TelemetryFrames; the counters come from the stream
        (``metrics.stream_chunk_totals``)."""
        obj, stale, upd, sup = zip(*self.snaps)
        return TelemetryFrames(
            rounds=(np.arange(n_rec) + 1) * record_every,
            objective=torch.stack(obj).cpu().numpy(),
            staleness=torch.stack(stale).cpu().numpy(),
            updates=torch.stack(upd).cpu().numpy(),
            suppressed=None if sup[0] is None
            else torch.stack(sup).cpu().numpy(),
            **tmetrics.stream_chunk_totals(stream, n_rec, record_every))


def run_mp_scenario(topo: SparseTopology, theta_sol, c, alpha: float,
                    conditions: NetworkConditions, rounds: int,
                    batch: int, seed: int = 0, record_every: int = 10,
                    backend: Optional[ReproBackend] = None,
                    stream: Optional[EventStream] = None,
                    telemetry: Optional[TelemetryConfig] = None,
                    device=None) -> SimTrace:
    """MP gossip under a fault scenario, B wake-ups per round.

    Per round: land every delivered message (stale deliveries carry the
    sender's model from the previous round), then every endpoint that
    received something recomputes its model from its post-communication
    slots (Eq. 6).  The horizon is floored to a multiple of
    ``record_every`` (``core.sparse.record_chunks``).

    ``stream`` replays a precomputed EventStream (e.g. the JAX package's,
    carried across by ``repro_torch.convert.stream_from_arrays``); when
    absent the torch scheduler draws one from ``seed`` on ``device``.

    ``backend=None`` runs the per-op round (gathers, slot scatters, one
    batched Eq. 6 update).  A ``backend`` runs the fused ``round_step`` op
    over the flat id-column slot table, telescoping Eq. 6 from slot
    deltas; its state is updated in place.

    ``telemetry=TelemetryConfig(enabled=True)`` attaches
    ``SimTrace.telemetry``: per round the staleness and update counters of
    the receiving sides, per record chunk the Eq. 3 local objective
    (``telemetry.metrics.mp_local_objective``), and the stream's drop
    attribution.  It only observes: ``theta_hist`` is bit-identical to the
    run without it.
    """
    device = resolve_device(device)
    tabs, theta_sol, c = _payload(topo, theta_sol, c, device)
    record_every, n_rec = record_chunks(rounds, record_every)
    total_rounds = n_rec * record_every
    if stream is None:
        stream = precompute_event_stream(
            tabs, torch.as_tensor(topo.partition_halves()), conditions,
            batch, seed, total_rounds, device=device)
    if stream.rounds < total_rounds or stream.i.shape[1] != batch:
        raise ValueError(f"stream is ({stream.rounds}, "
                         f"{stream.i.shape[1]}); the run needs "
                         f"({total_rounds}, {batch})")

    tel = _Telemetry(topo.n, device) if telemetry_on(telemetry) else None
    body = _fused_rounds if backend is not None else _per_op_rounds
    hist = body(tabs, theta_sol, c, alpha, conditions, stream, n_rec,
                record_every, backend, tel=tel)
    ends = torch.arange(1, n_rec + 1, device=device) * record_every - 1
    run = EventStream(*(f[:total_rounds] for f in stream))
    delivered, dropped, invalid = stream_totals(run)
    frames = None if tel is None else tel.frames(run, n_rec, record_every)
    return SimTrace(torch.stack(hist), stream.active_frac[ends],
                    delivered, dropped, total_rounds, total_rounds * batch,
                    invalid, telemetry=frames)


def _per_op_rounds(tabs, theta_sol, c, alpha, conditions, stream, n_rec,
                   record_every, backend, graph=None, tel=None):
    """The per-op round body; returns the recorded theta snapshots.

    Undelivered messages and non-receivers are redirected to a trash row
    past the end of the slot table / model table (the OOB-drop of the JAX
    scatters), so no round synchronises with the host.

    ``graph`` (a :class:`_LearnedGraph`, joint runs only) supplies the
    mixing weights in place of ``tabs.nbr_p``, voids deliveries into a
    pruned receiver slot and runs the graph step; without it the body is
    the MP round.  ``tel`` (a :class:`_Telemetry`) observes each round's
    receiving sides and each chunk's Eq. 3 objective (under the learned
    weights, pruned slots at 0, in joint runs).
    """
    n, p = theta_sol.shape
    k = tabs.nbr_idx.shape[1]
    nk = n * k
    theta0, K0 = _mp_warm_start(tabs, theta_sol)
    K = torch.cat([K0.reshape(nk, p), K0.new_zeros(1, p)])   # + trash row
    theta = torch.cat([theta0, theta0.new_zeros(1, p)])
    theta_prev = theta
    w = tabs.nbr_p if graph is None else graph.w
    hist = []
    for t in range(n_rec * record_every):
        ev = stream.batch_at(t)
        msg_i = torch.where(ev.stale_ij[:, None], theta_prev[ev.i],
                            theta[ev.i])
        msg_j = torch.where(ev.stale_ji[:, None], theta_prev[ev.j],
                            theta[ev.j])
        cell_j, cell_i = ev.j * k + ev.r, ev.i * k + ev.s
        ok_ij, ok_ji = ev.deliver_ij, ev.deliver_ji
        if graph is not None and graph.prune:
            ok_ij, ok_ji = graph.admit(cell_j, cell_i, ok_ij, ok_ji)
        # scatter: idempotent — every write to one slot in one round comes
        # from the same sender with the same staleness flag, so duplicate
        # targets carry identical payloads (undelivered ones go to trash)
        K[torch.where(ok_ij, cell_j, nk)] = msg_i
        # scatter: idempotent (same argument for the j -> i direction)
        K[torch.where(ok_ji, cell_i, nk)] = msg_j
        # update: endpoints that received a message recompute Eq. (6);
        # delivery implies both endpoints are active (scheduler contract)
        upd = torch.cat([ev.i, ev.j])
        got = torch.cat([ok_ji, ok_ij])
        K_rows = K[:nk].view(n, k, p)[upd]
        new = batched_model_update(w[upd], K_rows, c[upd], theta_sol[upd],
                                   alpha, backend)
        theta_prev, theta = theta, theta.clone()
        # scatter: idempotent — duplicate agents in upd recompute the same
        # row from the same post-communication slots
        theta[torch.where(got, upd, n)] = new
        if graph is not None and graph.due(t):
            w = graph.step(theta[:n], K[:nk].view(n, k, p), backend)
        if tel is not None:
            tel.round(upd, got)
        if (t + 1) % record_every == 0:
            hist.append(theta[:n].clone())
            if graph is not None:
                graph.record()
            if tel is not None:
                w_obj = w if graph is None \
                    else torch.where(graph.live, graph.w, 0.0)
                tel.chunk(tmetrics.mp_local_objective(
                    theta[:n], K[:nk].view(n, k, p), w_obj, c, theta_sol,
                    alpha), None if graph is None else graph.suppressed)
    return hist


def _fused_rounds(tabs, theta_sol, c, alpha, conditions, stream, n_rec,
                  record_every, backend, tel=None):
    """The fused round body over the flat id-column slot table.

    Round t's stale-message source (theta at the start of round t-1) is
    gathered before round t-1's in-place step overwrites it; the fresh
    messages and the pre-scatter slot values are gathered at the start of
    round t, after round t-1's scatters.  ``tel`` observes as in
    :func:`_per_op_rounds`; the chunk objective reads the slot table's
    first p columns through a strided view.
    """
    n, p = theta_sol.shape
    device = theta_sol.device
    step = resolve("round_step", backend, device)
    no_stale = conditions.stale_prob == 0.0
    a_w = round_scales(tabs.nbr_p, c, alpha=alpha).contiguous()
    theta, K0 = _mp_warm_start(tabs, theta_sol)
    theta_base = batched_model_update(tabs.nbr_p, K0, c, theta_sol,
                                      alpha).contiguous()
    Ke = encode_slots(K0)
    del K0
    theta = theta.clone()
    got_ever = torch.zeros(n, dtype=torch.bool, device=device)

    def stale_src_of(t, theta_now):
        if no_stale or t >= n_rec * record_every:
            return None
        ev = stream.batch_at(t)
        return round_stale_src(theta_now, ev.i, ev.j)

    stale_src = stale_src_of(0, theta)
    hist = []
    for t in range(n_rec * record_every):
        ev = stream.batch_at(t)
        msg, tgt_row, enc, k_old = round_prefetch(
            theta, None, Ke, ev.i, ev.j, ev.s, ev.r, ev.deliver_ij,
            ev.deliver_ji, ev.stale_ij, ev.stale_ji, stale_src=stale_src,
            no_stale=no_stale)
        stale_src = stale_src_of(t + 1, theta)
        theta, Ke, got_ever, _ = step(theta, Ke, got_ever, msg, tgt_row,
                                      enc, k_old, theta_base, a_w)
        if tel is not None:
            tel.round(torch.cat([ev.i, ev.j]),
                      torch.cat([ev.deliver_ji, ev.deliver_ij]))
        if (t + 1) % record_every == 0:
            hist.append(theta.clone())
            if tel is not None:
                # the slot values: Ke's first p columns, a strided view
                tel.chunk(tmetrics.mp_local_objective(
                    theta, Ke.view(n, -1, p + 1)[:, :, :p], tabs.nbr_p, c,
                    theta_sol, alpha))
    return hist


# ---------------------------------------------------------------------------
# Exact sparse CL-ADMM (mirrors core.collaborative.async_admm, quadratic)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SparseADMMState:
    """Sparse partial-consensus state: per-agent self model (n, p) and
    per-slot copies / secondary / dual variables (n, k_max, p)."""

    theta: torch.Tensor
    K: torch.Tensor
    Z_own: torch.Tensor
    Z_nbr: torch.Tensor
    L_own: torch.Tensor
    L_nbr: torch.Tensor


def init_sparse_admm(topo: SparseTopology, theta_sol,
                     device=None) -> SparseADMMState:
    """Warm start (paper §4.2): share solitary models with neighbors; every
    array its own allocation on ``device`` (CUDA when None), since the
    engines update them in place."""
    device = resolve_device(device)
    n, k = topo.n, topo.k_max
    if isinstance(theta_sol, torch.Tensor):
        theta = theta_sol.to(device, torch.float32).reshape(n, -1).clone()
    else:
        theta = torch.as_tensor(np.array(theta_sol, dtype=np.float32),
                                device=device).reshape(n, -1)
    p = theta.shape[1]
    K = theta[torch.as_tensor(topo.tables.nbr_idx, device=device).long()]
    Z_own = theta[:, None, :].expand(n, k, p).contiguous()
    return SparseADMMState(theta, K, Z_own, K.clone(),
                           torch.zeros_like(K), torch.zeros_like(K))


def _admm_payload(topo: SparseTopology, data: AgentData, theta_sol, state,
                  device):
    """(tables, D (n,), m (n,), sx (n, p), state) on ``device``."""
    tabs = topo.device_tables(device)
    if state is None:
        if theta_sol is None:
            raise ValueError("need theta_sol (warm start) or explicit state")
        state = init_sparse_admm(topo, theta_sol, device)
    m, sx = local_stats(data)
    return tabs, tabs.deg_w, m.to(device), sx.to(device), state


@dataclasses.dataclass
class SparseCLTrace:
    """Recorded sparse CL-ADMM trajectory (models, comms, final state)."""

    theta_hist: torch.Tensor
    comms_hist: np.ndarray
    final: SparseADMMState


def _sparse_primal_quadratic(st: SparseADMMState, l: int, tabs, D, m, sx,
                             mu, rho, backend=None):
    """Slot-row mirror of ``core.collaborative._primal_quadratic``: the
    same "admm_primal" call on the same slot-row shapes; writes row l."""
    k = tabs.nbr_w.shape[1]
    live = torch.arange(k, device=D.device) < tabs.deg_count[l]
    theta_l, theta_js = quadratic_primal_core(
        tabs.nbr_w[l], live, st.Z_own[l], st.Z_nbr[l], st.L_own[l],
        st.L_nbr[l], D[l], m[l], sx[l], mu, rho, backend)
    st.K[l] = torch.where(live[:, None], theta_js, st.K[l])
    st.theta[l] = theta_l


def _sparse_edge_zl(st: SparseADMMState, i, s, j, r, rho):
    """Slot mirror of ``core.collaborative._edge_zl_update`` for edge
    (i, j): slot s is j's position in i's row, slot r is i's in j's."""
    cells_i = (st.theta[i], st.K[i, s], st.L_own[i, s], st.L_nbr[i, s])
    cells_j = (st.theta[j], st.K[j, r], st.L_own[j, r], st.L_nbr[j, r])
    new_i = admm_edge_halfstep(*cells_i, *cells_j, rho)
    new_j = admm_edge_halfstep(*cells_j, *cells_i, rho)
    for arr, vi, vj in zip((st.Z_own, st.Z_nbr, st.L_own, st.L_nbr), new_i,
                           new_j):
        # scatter: unique targets — (i, s) and (j, r) are the edge's two
        # directed slots, distinct cells
        arr[i, s] = vi
        arr[j, r] = vj  # scatter: unique targets


def sparse_async_admm(topo: SparseTopology, data: AgentData, mu: float,
                      rho: float, steps: int = 1000, seed: int = 0,
                      record_every: int = 50, theta_sol=None,
                      state: Optional[SparseADMMState] = None, draws=None,
                      backend: Optional[ReproBackend] = None,
                      device=None) -> SparseCLTrace:
    """Asynchronous decentralized CL-ADMM (paper §4.2) over sparse slot
    state, one wake-up per tick, on ``device`` (CUDA when None); ``state``
    is updated in place.

    Quadratic loss (exact primal).  ``draws = (i_seq, s_seq)`` gives the
    wake-ups; otherwise a ``torch.Generator`` seeded with ``seed`` draws
    them.  Bit for bit ``core.collaborative.async_admm(...,
    loss="quadratic")`` on the same graph and draws, storing O(n k p)
    instead of 5 O(n^2 p).
    """
    device = resolve_device(device)
    tabs, D, m, sx, st = _admm_payload(topo, data, theta_sol, state, device)
    host = topo.tables
    record_every, n_rec = record_chunks(steps, record_every)
    hist = []
    for t, (i, s) in enumerate(wakeups(topo.n, host, n_rec * record_every,
                                       seed, draws)):
        if host.deg_count[i] > 0:        # a degree-0 waker is a no-op
            j, r = int(host.nbr_idx[i, s]), int(host.rev_slot[i, s])
            _sparse_primal_quadratic(st, i, tabs, D, m, sx, mu, rho, backend)
            _sparse_primal_quadratic(st, j, tabs, D, m, sx, mu, rho, backend)
            _sparse_edge_zl(st, i, s, j, r, rho)
        if (t + 1) % record_every == 0:
            hist.append(st.theta.clone())
    comms = 2 * record_every * (np.arange(n_rec) + 1)
    return SparseCLTrace(torch.stack(hist), comms, st)


# ---------------------------------------------------------------------------
# Scenario engine: batched wake-ups + network conditions (CL-ADMM)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CLSimTrace(SimTrace):
    """SimTrace plus the final sparse ADMM state."""

    final: Optional[SparseADMMState] = None


def _event_sides(ev):
    """The 2B event sides of one round: side e updates agent ``upd[e]``'s
    slot ``own_s[e]`` from partner ``oth_a[e]`` (slot ``oth_s[e]``), whose
    payload is ``stale[e]`` and was delivered where ``got[e]`` (the
    i-sides first: i receives j's payload, then j receives i's)."""
    cat = torch.cat
    return (cat([ev.i, ev.j]), cat([ev.s, ev.r]), cat([ev.j, ev.i]),
            cat([ev.r, ev.s]), cat([ev.stale_ji, ev.stale_ij]),
            cat([ev.deliver_ji, ev.deliver_ij]))


def run_cl_scenario(topo: SparseTopology, data: AgentData, mu: float,
                    rho: float, conditions: NetworkConditions, rounds: int,
                    batch: int, seed: int = 0, record_every: int = 10,
                    theta_sol=None, state: Optional[SparseADMMState] = None,
                    stream: Optional[EventStream] = None,
                    backend: Optional[ReproBackend] = None, primal=None,
                    telemetry: Optional[TelemetryConfig] = None,
                    device=None) -> CLSimTrace:
    """Asynchronous CL-ADMM (paper §4.2) under a fault scenario, B
    wake-ups per round, on ``device`` (CUDA when None).

    ``stream`` replays a precomputed EventStream (e.g. the JAX package's,
    carried across by ``repro_torch.convert.stream_from_arrays``); when
    absent the torch scheduler draws one from ``seed``.  ``state`` (or the
    warm start from ``theta_sol``) is updated in place and returned as
    ``final``.

    ``primal`` selects the primal-phase solver (``core.primal``): None or
    ``ExactQuadraticPrimal()`` is the closed-form quadratic solve;
    ``InexactPrimal(...)`` runs B AdamW steps on the local Lagrangian, for
    nonlinear losses and flattened agent models — then ``theta_sol`` holds
    the (n, p) flat parameter rows (e.g. from ``core.primal.
    solitary_adamw``), whose width p need not be the feature width of
    ``data.x``.  A solver needing data (``needs_data``) gets the rows'
    ``(x, y, mask)``; one without ``solve_batch`` raises TypeError.

    One round:

    1. **primal** — every endpoint whose partner's payload was delivered
       recomputes its primal from its round-start rows (and, for the
       inexact solver, its round-start model as the warm start) and
       rewrites its theta and live K slots.  Duplicate agents read the
       same rows and write identical values.
    2. **prefetch** — the next round's stale payload rows, gathered from
       this round's post-primal theta/K and round-start L_own/L_nbr
       (``cl_stale_prefetch``); round 0's come from the initial state.
    3. **edge** — one ``cl_edge_step`` op over the 2B sides: each
       delivered side updates its own (Z_own, Z_nbr, L_own, L_nbr) slot
       from its post-primal cells and the partner's payload (fresh, or
       the prefetched stale rows).

    ``telemetry=TelemetryConfig(enabled=True)`` attaches
    ``CLSimTrace.telemetry``: per round the staleness and update counters
    of the sides that got their partner's payload, per record chunk the
    Eq. 7 local objective (the quadratic form through the sufficient
    statistics, or the solver's ``batch_local_loss`` for a solver that
    needs data), and the stream's drop attribution.  It only observes.
    """
    device = resolve_device(device)
    if primal is None:
        primal = ExactQuadraticPrimal()
    elif not callable(getattr(primal, "solve_batch", None)):
        raise TypeError(f"primal solver {type(primal).__name__} has no "
                        f"solve_batch method")
    tabs, D, m, sx, st = _admm_payload(topo, data, theta_sol, state, device)
    xym = tuple(a.to(device) for a in (data.x, data.y, data.mask)) \
        if primal.needs_data else ()
    record_every, n_rec = record_chunks(rounds, record_every)
    total_rounds = n_rec * record_every
    if stream is None:
        stream = precompute_event_stream(
            tabs, torch.as_tensor(topo.partition_halves()), conditions,
            batch, seed, total_rounds, device=device)
    if stream.rounds < total_rounds or stream.i.shape[1] != batch:
        raise ValueError(f"stream is ({stream.rounds}, "
                         f"{stream.i.shape[1]}); the run needs "
                         f"({total_rounds}, {batch})")

    n, k = tabs.nbr_w.shape
    edge_step = resolve("cl_edge_step", backend, device)
    live = live_slots(tabs.deg_count, k)
    tel = None
    if telemetry_on(telemetry):
        tel = _Telemetry(n, device)
        if not primal.needs_data:
            # the quadratic objective's one statistic the engine lacks
            x, mask = data.x.to(device), data.mask.to(device)
            sxx = torch.sum(mask * torch.sum(x * x, dim=-1), dim=1)

    sides = _event_sides(stream.batch_at(0))
    pay = cl_stale_prefetch(st.theta, st.K, st.L_own, st.L_nbr, sides[2],
                            sides[3])
    hist = []
    for t in range(total_rounds):
        upd, got = sides[0], sides[5]
        u = upd.long()
        rows = live[u]
        new_theta, theta_js = primal.solve_batch(
            tabs.nbr_w[u], rows, st.Z_own[u], st.Z_nbr[u], st.L_own[u],
            st.L_nbr[u], D[u], m[u], sx[u], tuple(a[u] for a in xym),
            st.theta[u], mu, rho, backend)
        K_rows = st.K[u]
        hit = landed(u, got, n)[:, None]
        # scatter: idempotent — duplicate agents in upd derive identical
        # rows from the same round-start state; a row that no side got
        # writes its own value back
        st.theta[u] = torch.where(hit, new_theta, st.theta[u])
        # scatter: idempotent (the same argument, for the K rows)
        st.K[u] = torch.where(hit[..., None] & rows[..., None], theta_js,
                              K_rows)
        nxt, pay_next = None, None
        if t + 1 < total_rounds:
            nxt = _event_sides(stream.batch_at(t + 1))
            pay_next = cl_stale_prefetch(st.theta, st.K, st.L_own, st.L_nbr,
                                         nxt[2], nxt[3])
        edge_step(st.theta, st.K, st.Z_own, st.Z_nbr, st.L_own, st.L_nbr,
                  *pay, *sides, rho=rho)
        if tel is not None:
            tel.round(upd, got)
        sides, pay = nxt, pay_next
        if (t + 1) % record_every == 0:
            hist.append(st.theta.clone())
            if tel is not None:
                if primal.needs_data:
                    obj = tmetrics.cl_local_objective_from_loss(
                        st.theta, st.K, tabs.nbr_w, live, D,
                        primal.batch_local_loss(st.theta, *xym), mu)
                else:
                    obj = tmetrics.cl_local_objective(
                        st.theta, st.K, tabs.nbr_w, live, D, m, sx, sxx, mu)
                tel.chunk(obj)
    ends = torch.arange(1, n_rec + 1, device=device) * record_every - 1
    run = EventStream(*(f[:total_rounds] for f in stream))
    delivered, dropped, invalid = stream_totals(run)
    frames = None if tel is None else tel.frames(run, n_rec, record_every)
    return CLSimTrace(torch.stack(hist), stream.active_frac[ends],
                      delivered, dropped, total_rounds, total_rounds * batch,
                      invalid, telemetry=frames, final=st)


# ---------------------------------------------------------------------------
# Joint model + collaboration-graph learning (DESIGN.md §13)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class JointSimTrace(SimTrace):
    """SimTrace plus the graph-learning outputs.

    final_w / final_live: (n, k) learned row-stochastic weights and the
        surviving-candidate mask (the candidate mask when pruning is off);
    live_edges_hist: (n_records,) live directed slots with weight > 0 at
        each record;
    suppressed: deliveries voided because the receiver had pruned the
        edge — a subset of ``delivered`` (the stream's accounting
        invariant is unchanged).
    """

    final_w: Optional[torch.Tensor] = None
    final_live: Optional[torch.Tensor] = None
    live_edges_hist: Optional[torch.Tensor] = None
    suppressed: int = 0


class _LearnedGraph:
    """The joint engine's graph state inside the per-op round body: the
    learned weights ``w`` and live mask over the frozen candidate slots,
    the graph step every ``graph_every`` rounds (rate ``eta``, sparsity
    temperature ``lam``; then a monotone prune at ``prune_eps``), and the
    count of deliveries voided by a pruned receiver, kept on the device
    (no round syncs with the host)."""

    def __init__(self, tabs, eta, lam, graph_every, prune_eps):
        k = tabs.nbr_idx.shape[1]
        self.w = tabs.nbr_p
        self.live = live_slots(tabs.deg_count, k)
        self.eta, self.lam, self.every = eta, lam, graph_every
        self.prune_eps = prune_eps
        self.prune = eta > 0.0 and prune_eps is not None
        self.suppressed = torch.zeros((), dtype=torch.int64,
                                      device=tabs.nbr_p.device)
        self.edges = []

    def admit(self, cell_j, cell_i, ok_ij, ok_ji):
        """Void deliveries into a pruned receiver slot, counting them."""
        live = self.live.view(-1)
        keep_ij = ok_ij & live[cell_j]
        keep_ji = ok_ji & live[cell_i]
        self.suppressed += (ok_ij & ~keep_ij).sum() \
            + (ok_ji & ~keep_ji).sum()
        return keep_ij, keep_ji

    def due(self, t):
        """Whether round ``t`` (global index) ends with a graph step."""
        return self.eta > 0.0 and (t + 1) % self.every == 0

    def step(self, theta, K, backend):
        """The graph step on the post-update models and slots; returns the
        new mixing weights."""
        self.w = reweight_rows(theta, K, self.w, self.live, eta=self.eta,
                               lam=self.lam, backend=backend)
        if self.prune:
            self.w, self.live = prune_rows(self.w, self.live,
                                           self.prune_eps)
        return self.w

    def record(self):
        self.edges.append((self.live & (self.w > 0)).sum())


def run_joint_scenario(topo: SparseTopology, theta_sol, c, alpha: float,
                       conditions: NetworkConditions, rounds: int,
                       batch: int, seed: int = 0, record_every: int = 10, *,
                       eta_graph: float = 0.0, lam: float = 1.0,
                       graph_every: int = 1,
                       prune_eps: Optional[float] = None,
                       stream: Optional[EventStream] = None,
                       backend: Optional[ReproBackend] = None,
                       telemetry: Optional[TelemetryConfig] = None,
                       device=None) -> JointSimTrace:
    """Joint MP gossip and collaboration-graph learning under a fault
    scenario (Zantedeschi et al. 2019 alternation; DESIGN.md §13), on
    ``device`` (CUDA when None).

    The MP per-op round of ``run_mp_scenario`` with the topology as state:
    the candidate slot tables stay frozen (wake-ups stay uniform over the
    candidates, so the event stream is replayable), while the mixing
    weights start at ``tabs.nbr_p`` and are re-estimated every
    ``graph_every`` rounds from local model distances
    (``core.graph_learning.reweight_rows``, rate ``eta_graph``, sparsity
    temperature ``lam``).  ``prune_eps`` (with ``eta_graph > 0``)
    permanently drops slots whose weight falls to it or below, and
    deliveries into a pruned receiver slot are voided (``suppressed``).

    A round: land the messages, then the Eq. 6 update under the current
    weights, then — when ``(t + 1) % graph_every == 0`` — the graph step
    on the post-update models and slots, then the prune.
    ``eta_graph=0`` runs no graph step and is bit for bit
    ``run_mp_scenario(backend=None)`` on the same events: both are the
    one per-op round body.  ``backend`` selects per-op implementations
    (there is no fused joint body).

    ``telemetry=TelemetryConfig(enabled=True)`` attaches
    ``JointSimTrace.telemetry`` as in :func:`run_mp_scenario`, with the
    staleness and update counters of the *admitted* deliveries (a delivery
    voided by a pruned receiver slot does not count, so joint staleness is
    not a replay of the stream), the Eq. 3 objective under the learned
    weights with pruned slots at 0, and ``suppressed`` per chunk.
    """
    device = resolve_device(device)
    tabs, theta_sol, c = _payload(topo, theta_sol, c, device)
    record_every, n_rec = record_chunks(rounds, record_every)
    total_rounds = n_rec * record_every
    if stream is None:
        stream = precompute_event_stream(
            tabs, torch.as_tensor(topo.partition_halves()), conditions,
            batch, seed, total_rounds, device=device)
    if stream.rounds < total_rounds or stream.i.shape[1] != batch:
        raise ValueError(f"stream is ({stream.rounds}, "
                         f"{stream.i.shape[1]}); the run needs "
                         f"({total_rounds}, {batch})")
    graph = _LearnedGraph(tabs, eta_graph, lam, graph_every, prune_eps)
    tel = _Telemetry(topo.n, device) if telemetry_on(telemetry) else None
    hist = _per_op_rounds(tabs, theta_sol, c, alpha, conditions, stream,
                          n_rec, record_every, backend, graph, tel)
    ends = torch.arange(1, n_rec + 1, device=device) * record_every - 1
    run = EventStream(*(f[:total_rounds] for f in stream))
    delivered, dropped, invalid = stream_totals(run)
    frames = None if tel is None else tel.frames(run, n_rec, record_every)
    return JointSimTrace(torch.stack(hist), stream.active_frac[ends],
                         delivered, dropped, total_rounds,
                         total_rounds * batch, invalid, telemetry=frames,
                         final_w=graph.w,
                         final_live=graph.live,
                         live_edges_hist=torch.stack(graph.edges),
                         suppressed=int(graph.suppressed))
