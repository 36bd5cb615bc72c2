"""Sparse event-driven engines, model-propagation half (counterpart of
``repro.simulate.engines``).

State is O(n * k * p) padded-neighbor storage:

  theta (n, p)        — each agent's own model
  K     (n, k_max, p) — K[i, s] = agent i's copy of neighbor nbr_idx[i, s]

* ``sparse_sync_mp`` — the synchronous Eq. 5 sweep, one ``sparse_mix`` op
  (the ``sparse_gather_mix`` CUDA kernel on the card) per sweep.
* ``run_mp_scenario`` — MP gossip under a fault scenario, B wake-ups per
  round, replaying an ``EventStream``.  Two round bodies: the per-op
  gather/mix/scatter sequence (``backend=None``) and the fused
  ``round_step`` op (``backend`` given; the ``round_step`` CUDA kernel on
  the card).  Both consume the same events, so their counters match
  exactly and their trajectories agree to fp rounding.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.model_propagation import mp_mix_operator
from repro_torch.core.sparse import batched_model_update, record_chunks
from repro_torch.kernels.dispatch import (ReproBackend, encode_slots,
                                          resolve, round_prefetch,
                                          round_scales, round_stale_src)
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
# Synchronous sparse sweep (Eq. 5 over CSR) — the gather-mix hot loop
# ---------------------------------------------------------------------------


def sparse_sync_mp(topo: SparseTopology, theta_sol, c, alpha: float,
                   sweeps: int, backend: Optional[ReproBackend] = None,
                   device=None) -> torch.Tensor:
    """Fixed-point iteration Eq. (5) over the sparse neighbor layout.

    theta_{t+1}[i] = (alpha * sum_s P[i,s] theta_t[nbr[i,s]]
                      + (1-alpha) c_i theta_sol[i]) / (alpha + (1-alpha) c_i)

    One sweep = one "sparse_mix" op over all agents, resolved through
    ``kernels.dispatch`` for ``device`` (CUDA when None).
    """
    device = resolve_device(device)
    tabs, theta_sol, c = _payload(topo, theta_sol, c, device)
    w, b = mp_mix_operator(tabs.nbr_p, c, alpha)
    w, b = w.contiguous(), b.contiguous()
    mix = resolve("sparse_mix", backend, device)
    theta = theta_sol
    for _ in range(sweeps):
        theta = mix(theta, tabs.nbr_idx, w, b, theta_sol)
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
    """

    theta_hist: torch.Tensor
    active_hist: torch.Tensor
    delivered: int
    dropped: int
    rounds: int
    events: int
    invalid: int = 0


def run_mp_scenario(topo: SparseTopology, theta_sol, c, alpha: float,
                    conditions: NetworkConditions, rounds: int,
                    batch: int, seed: int = 0, record_every: int = 10,
                    backend: Optional[ReproBackend] = None,
                    stream: Optional[EventStream] = None,
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

    body = _fused_rounds if backend is not None else _per_op_rounds
    hist = body(tabs, theta_sol, c, alpha, conditions, stream, n_rec,
                record_every, backend)
    ends = torch.arange(1, n_rec + 1, device=device) * record_every - 1
    delivered, dropped, invalid = stream_totals(
        EventStream(*(f[:total_rounds] for f in stream)))
    return SimTrace(torch.stack(hist), stream.active_frac[ends],
                    delivered, dropped, total_rounds, total_rounds * batch,
                    invalid)


def _per_op_rounds(tabs, theta_sol, c, alpha, conditions, stream, n_rec,
                   record_every, backend):
    """The per-op round body; returns the recorded theta snapshots.

    Undelivered messages and non-receivers are redirected to a trash row
    past the end of the slot table / model table (the OOB-drop of the JAX
    scatters), so no round synchronises with the host.
    """
    n, p = theta_sol.shape
    k = tabs.nbr_idx.shape[1]
    nk = n * k
    theta0, K0 = _mp_warm_start(tabs, theta_sol)
    K = torch.cat([K0.reshape(nk, p), K0.new_zeros(1, p)])   # + trash row
    theta = torch.cat([theta0, theta0.new_zeros(1, p)])
    theta_prev = theta
    hist = []
    for t in range(n_rec * record_every):
        ev = stream.batch_at(t)
        msg_i = torch.where(ev.stale_ij[:, None], theta_prev[ev.i],
                            theta[ev.i])
        msg_j = torch.where(ev.stale_ji[:, None], theta_prev[ev.j],
                            theta[ev.j])
        # scatter: idempotent — every write to one slot in one round comes
        # from the same sender with the same staleness flag, so duplicate
        # targets carry identical payloads (undelivered ones go to trash)
        K[torch.where(ev.deliver_ij, ev.j * k + ev.r, nk)] = msg_i
        # scatter: idempotent (same argument for the j -> i direction)
        K[torch.where(ev.deliver_ji, ev.i * k + ev.s, nk)] = msg_j
        # update: endpoints that received a message recompute Eq. (6);
        # delivery implies both endpoints are active (scheduler contract)
        upd = torch.cat([ev.i, ev.j])
        got = torch.cat([ev.deliver_ji, ev.deliver_ij])
        K_rows = K[:nk].view(n, k, p)[upd]
        new = batched_model_update(tabs.nbr_p[upd], K_rows, c[upd],
                                   theta_sol[upd], alpha)
        theta_prev, theta = theta, theta.clone()
        # scatter: idempotent — duplicate agents in upd recompute the same
        # row from the same post-communication slots
        theta[torch.where(got, upd, n)] = new
        if (t + 1) % record_every == 0:
            hist.append(theta[:n].clone())
    return hist


def _fused_rounds(tabs, theta_sol, c, alpha, conditions, stream, n_rec,
                  record_every, backend):
    """The fused round body over the flat id-column slot table.

    Round t's stale-message source (theta at the start of round t-1) is
    gathered before round t-1's in-place step overwrites it; the fresh
    messages and the pre-scatter slot values are gathered at the start of
    round t, after round t-1's scatters.
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
        if (t + 1) % record_every == 0:
            hist.append(theta.clone())
    return hist
