"""Row-local metric expressions and stream reductions (counterpart of
``repro.telemetry.metrics``).

The row-local expressions (:func:`mp_local_objective`,
:func:`cl_local_objective`, :func:`cl_local_objective_from_loss`,
:func:`staleness_step`, :func:`batch_drop_causes`) are torch functions
of the engines' slot rows, with the JAX package's float32 arithmetic in
the same order: each agent's value reads only that agent's own row.  The
engines evaluate them on the device and keep the results there; global
reductions (objective sums, staleness percentiles) happen on the host in
canonical agent order (:mod:`repro_torch.telemetry.frames`).

The stream reductions (:func:`stream_drop_causes`,
:func:`stream_dirty_chunks`, :func:`stream_staleness_chunks`,
:func:`stream_chunk_totals`) take an ``EventStream`` on any device,
compute on that device and return numpy, as the JAX package's do.  They
attribute every counted drop to its ``NetworkConditions`` cause with the
stream's ``cut``/``dead`` flags (recorded by the scheduler from the same
draws that decided delivery):

    partition — the pair straddled an active partition window
    churn     — otherwise, an endpoint was churned out
    link      — otherwise, the iid per-direction message loss

Causes are disjoint and exhaustive over counted drops, so
``link + churn + partition == dropped`` for every run.
"""

from __future__ import annotations

import numpy as np
import torch

# ---------------------------------------------------------------------------
# row-local metric expressions
# ---------------------------------------------------------------------------


def mp_local_objective(theta, K, w, c, theta_sol, alpha: float):
    """Per-agent local view of the MP objective (paper Eq. 3) from slot rows.

    obj_i = alpha * sum_s w[i, s] ||theta_i - K[i, s]||^2
            + (1 - alpha) * c_i ||theta_i - theta_sol_i||^2

    ``w`` is the row-stochastic mixing weight table (``nbr_p``, or the
    joint engine's learned weights with pruned and pad slots at 0).  The
    smoothness term reads the agent's copies ``K`` of its neighbors, the
    quantity a decentralized agent observes.  Shapes: theta (rows, p), K
    (rows, k, p) (any strides), w (rows, k), c (rows,), theta_sol (rows,
    p) -> (rows,) float32.
    """
    d = theta[:, None, :] - K
    smooth = torch.sum(w * torch.sum(d * d, dim=-1), dim=-1)
    r = theta - theta_sol
    anchor = c * torch.sum(r * r, dim=-1)
    return alpha * smooth + (1.0 - alpha) * anchor


def cl_local_objective(theta, K, nbr_w, live, D, m_counts, sx, sxx,
                       mu: float):
    """Per-agent local view of the CL objective (paper Eq. 7, quadratic).

    obj_i = 0.5 * sum_s W[i, s] ||theta_i - K[i, s]||^2
            + mu * D_i * L_i(theta_i)

    with the quadratic loss expanded through the engines' sufficient
    statistics: L_i(theta) = m_i ||theta||^2 - 2 theta . sx_i + sxx_i
    (``sxx_i = sum_k mask ||x_k||^2``).  Shapes: theta (rows, p), K (rows,
    k, p), nbr_w (rows, k), live (rows, k) bool, D/m_counts/sxx (rows,),
    sx (rows, p) -> (rows,) float32.
    """
    d = theta[:, None, :] - K
    wl = torch.where(live, nbr_w, 0.0)
    smooth = 0.5 * torch.sum(wl * torch.sum(d * d, dim=-1), dim=-1)
    loss = (m_counts * torch.sum(theta * theta, dim=-1)
            - 2.0 * torch.sum(theta * sx, dim=-1) + sxx)
    return smooth + mu * D * loss


def cl_local_objective_from_loss(theta, K, nbr_w, live, D, loss_vec,
                                 mu: float):
    """:func:`cl_local_objective` for any loss (DESIGN.md §18): the
    engines evaluate ``loss_vec[i] = L_i(theta_i)`` directly (the inexact
    primal's guarded loss over agents) and only the consensus term is
    computed here.  Shapes as in :func:`cl_local_objective`, loss_vec
    (rows,) -> (rows,) float32.
    """
    d = theta[:, None, :] - K
    wl = torch.where(live, nbr_w, 0.0)
    smooth = 0.5 * torch.sum(wl * torch.sum(d * d, dim=-1), dim=-1)
    return smooth + mu * D * loss_vec


def staleness_step(stale, got, rows, n_rows: int):
    """One round of per-agent staleness counters.

    ``stale`` (n_rows,) int32 counts rounds since each agent last absorbed
    a neighbor update; an agent listed in ``rows`` (in range) with ``got``
    True resets to 0, everyone else ages by one.  ``rows`` may repeat:
    the same condition as the engines' own model-update scatter.  The
    scatter lands in a buffer with a trash cell at ``n_rows``, so nothing
    is synchronised with the host.
    """
    recv = torch.zeros(n_rows + 1, dtype=torch.bool, device=stale.device)
    # scatter: idempotent — every delivered row writes True
    recv[torch.where(got, rows, n_rows)] = True
    return torch.where(recv[:n_rows], 0, stale + 1).to(torch.int32)


def batch_drop_causes(deliver_ij, deliver_ji, valid, cut, dead):
    """(link, churn, partition) drop counts (0-d int64 tensors) of one
    event batch: both directions of every valid event whose message was
    lost, attributed by the disjoint priority partition > churn > link
    (see the module docstring) — the expression :func:`stream_drop_causes`
    applies to a whole stream."""
    link = churn = part = 0
    for deliver in (deliver_ij, deliver_ji):
        drop = valid & ~deliver
        part = part + torch.sum(drop & cut)
        churn = churn + torch.sum(drop & ~cut & dead)
        link = link + torch.sum(drop & ~cut & ~dead)
    return link, churn, part


# ---------------------------------------------------------------------------
# reductions over materialized event streams
# ---------------------------------------------------------------------------


def _chunked(x, n_rec: int, record_every: int):
    """The first n_rec * record_every rounds of a (rounds, B) stream field
    as (n_rec, record_every, B)."""
    return x[:n_rec * record_every].reshape(n_rec, record_every, -1)


def stream_drop_causes(stream) -> tuple:
    """Total (link, churn, partition) drop attribution of an EventStream,
    as Python ints."""
    link, churn, part = batch_drop_causes(stream.deliver_ij,
                                          stream.deliver_ji, stream.valid,
                                          stream.cut, stream.dead)
    return int(link), int(churn), int(part)


def stream_dirty_chunks(stream, n: int, n_rec: int,
                        record_every: int) -> np.ndarray:
    """(n_rec, n) bool: which agents' models changed in each record chunk.

    An agent is dirty in a chunk when any event of the chunk delivered a
    message to it — ``deliver_ji`` marks waker ``i`` a receiver,
    ``deliver_ij`` marks neighbor ``j`` — the condition under which the
    engines write a new theta row.  For joint runs with pruning the set is
    conservative (a delivery voided by a pruned receiver slot still marks
    its target dirty).
    """
    dev = stream.i.device
    chunk = torch.arange(n_rec, device=dev)[:, None, None] * (n + 1)
    dirty = torch.zeros(n_rec * (n + 1), dtype=torch.bool, device=dev)
    for recv, d in ((stream.i, stream.deliver_ji),
                    (stream.j, stream.deliver_ij)):
        cell = chunk + torch.where(_chunked(d, n_rec, record_every),
                                   _chunked(recv, n_rec, record_every)
                                   .long(), n)
        # scatter: idempotent — duplicate (chunk, agent) targets all
        # write True; undelivered events land in each chunk's trash cell
        dirty[cell.reshape(-1)] = True
    return dirty.view(n_rec, n + 1)[:, :n].cpu().numpy()


def stream_staleness_chunks(stream, n: int, n_rec: int,
                            record_every: int) -> np.ndarray:
    """(n_rec, n) int32 per-agent staleness at the end of each record chunk.

    The replay of :func:`staleness_step` over a materialized stream: after
    round t (0-based), an agent that last absorbed an update in round
    ``t0`` counts ``t - t0`` rounds of staleness, one that never received
    counts ``t + 1``.  Equal to the counters the engines keep with
    telemetry on.  Replayed round by round on the stream's device, with
    no synchronisation until the result is copied back.
    """
    dev = stream.i.device
    last = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    out = []
    for ci in range(n_rec):
        for t in range(record_every):
            g = ci * record_every + t
            for recv, d in ((stream.i[g], stream.deliver_ji[g]),
                            (stream.j[g], stream.deliver_ij[g])):
                # scatter: idempotent — every receiver of round g writes g
                last[torch.where(d, recv.long(), n)] = g
        end = (ci + 1) * record_every - 1
        lst = last[:n]
        out.append(torch.where(lst >= 0, end - lst, end + 1))
    return torch.stack(out).to(torch.int32).cpu().numpy()


def stream_chunk_totals(stream, n_rec: int, record_every: int) -> dict:
    """Cumulative per-record-chunk accounting of an EventStream.

    Returns (n_rec,) int64 numpy arrays — delivered, drop_link,
    drop_churn, drop_partition, invalid — each cumulative up to the end of
    its chunk, so the last entries equal ``stream_totals`` and
    :func:`stream_drop_causes` of the whole stream.  Computed on the
    stream's device and copied back once.
    """
    def ch(x):
        return _chunked(x, n_rec, record_every)

    d_ij, d_ji = ch(stream.deliver_ij), ch(stream.deliver_ji)
    valid, cut, dead = ch(stream.valid), ch(stream.cut), ch(stream.dead)
    link = churn = part = 0
    for deliver in (d_ij, d_ji):
        drop = valid & ~deliver
        part = part + (drop & cut).sum(dim=(1, 2))
        churn = churn + (drop & ~cut & dead).sum(dim=(1, 2))
        link = link + (drop & ~cut & ~dead).sum(dim=(1, 2))
    cols = torch.stack([d_ij.sum(dim=(1, 2)) + d_ji.sum(dim=(1, 2)), link,
                        churn, part, (~valid).sum(dim=(1, 2))])
    cols = torch.cumsum(cols, dim=1).cpu().numpy().astype(np.int64)
    return dict(zip(("delivered", "drop_link", "drop_churn",
                     "drop_partition", "invalid"), cols))
