"""Graph-partitioned network simulation over a mesh of shards (counterpart
of ``repro.simulate.partition``; DESIGN.md §11–§13).

Shards the agent graph into P blocks, gives each shard padded local agent
state plus a *halo* buffer of remote-neighbor models, and runs the
event-driven engines over a 1-D mesh (``repro_torch.launch.sim_mesh``),
exchanging halos between event batches.  The round body is written once
along a leading shard axis S: S = P on a ``LocalMesh`` (every shard in
this process, stacked on one device), S = 1 on a ``DistMesh`` (one shard
a process over ``torch.distributed``).

Layout per shard (m = padded local agents, H = padded halo size)::

      theta (m + 1, p)   K (m + 1, k, p)   nbr_p (m, k)   c / sol
      ext = [ theta_loc | theta_halo (H, p) | 0-row ]   # message source

    fetch[q][agent] -> row of ext   (m + H = the zero row = "not here")

Row m of the scattered state is a trash row: writes that JAX drops
(``mode="drop"``) land there, so no round synchronises with the host.

Three properties make a sharded trajectory match the single-device
engine (``simulate.engines``) bit for bit:

* every shard replays the same precomputed event stream
  (``scheduler.precompute_event_stream``, or the caller's) — the fault
  process never reads model state;
* within a round messages read round-start models; the halo refreshed at
  the top of each round is the round-start snapshot of remote models (the
  previous round's ext buffer serves the one-round-stale payloads);
* the per-agent update is the shared ``core.sparse`` arithmetic applied to
  the receiver's own slot row, the same whether the row lives in the
  global state or a shard's block.

The one approximation is the static per-shard buffers: each round a shard
compacts the events touching it into ``E`` slots and its delivery
endpoints into ``U`` slots, in ascending order (8 sigma above the mean
by default); events past them are counted in ``overflow``, kept on the
device and read once at the end.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.graph_learning import prune_rows, reweight_rows
from repro_torch.core.losses import AgentData, local_stats
from repro_torch.core.primal import ExactQuadraticPrimal
from repro_torch.core.sparse import (admm_edge_halfstep,
                                     batched_model_update, live_slots,
                                     record_chunks)
from repro_torch.launch.sim_mesh import (halo_exchange_fn,
                                         halo_payload_bytes, make_sim_mesh,
                                         resolve_halo_codec)
from repro_torch.telemetry import metrics as tmetrics
from repro_torch.telemetry.config import TelemetryConfig, telemetry_on
from repro_torch.telemetry.frames import TelemetryFrames
from .engines import SimTrace, init_sparse_admm
from .scheduler import (EventStream, NetworkConditions,
                        precompute_event_stream, stream_totals)
from .topology import SparseTopology

# ---------------------------------------------------------------------------
# Greedy edge-cut partitioner (linear deterministic greedy over a BFS order)
# ---------------------------------------------------------------------------


def _bfs_order(topo: SparseTopology, seed: int) -> np.ndarray:
    """Deterministic BFS visit order; the seed picks each component's root."""
    tabs = topo.tables
    n = topo.n
    rng = np.random.default_rng(seed)
    seen = np.zeros(n, bool)
    order = np.empty(n, np.int64)
    pos = 0
    start = int(rng.integers(n))
    for root in range(n):
        root = (root + start) % n
        if seen[root]:
            continue
        seen[root] = True
        q = deque([root])
        while q:
            v = q.popleft()
            order[pos] = v
            pos += 1
            for u in tabs.nbr_idx[v, :tabs.deg_count[v]]:
                if not seen[u]:
                    seen[u] = True
                    q.append(int(u))
    return order


def greedy_partition(topo: SparseTopology, n_shards: int, seed: int = 0,
                     refine_passes: int = 4) -> np.ndarray:
    """Greedy edge-cut assignment of agents to ``n_shards`` balanced shards.

    Linear deterministic greedy (Stanton & Kleinberg): visit agents in BFS
    order and put each on the shard holding most of its already-placed
    neighbors, discounted by shard fullness and hard-capped at
    ceil(n / P) agents; then ``refine_passes`` local passes move each agent
    to its majority-neighbor shard when balance allows (never increases the
    cut).  O(E) per pass; deterministic for a fixed seed (the seed only
    picks BFS roots).  Returns the (n,) int32 shard id per agent — the
    JAX package's array for the same topology and seed.
    """
    n = topo.n
    if n_shards <= 1:
        return np.zeros(n, np.int32)
    tabs = topo.tables
    cap = math.ceil(n / n_shards)
    assign = np.full(n, -1, np.int32)
    sizes = np.zeros(n_shards, np.int64)
    order = _bfs_order(topo, seed)
    for v in order:
        nbrs = tabs.nbr_idx[v, :tabs.deg_count[v]]
        placed = assign[nbrs]
        cnt = np.bincount(placed[placed >= 0], minlength=n_shards)
        open_ = sizes < cap
        if cnt.max(initial=0) > 0:
            score = np.where(open_, cnt * (1.0 - sizes / cap), -1.0)
        else:                       # no placed neighbor: least-loaded shard
            score = np.where(open_, -sizes.astype(np.float64), -np.inf)
        s = int(np.argmax(score))
        assign[v] = s  # scatter: unique target (scalar vertex id)
        sizes[s] += 1  # scatter: unique target (scalar shard id)
    # refinement tolerates ~6% imbalance so moves stay possible when every
    # shard sits exactly at cap (the LDG pass always ends there)
    refine_cap = cap + max(1, cap // 16)
    for _ in range(refine_passes):
        moved = False
        for v in order:
            nbrs = tabs.nbr_idx[v, :tabs.deg_count[v]]
            cnt = np.bincount(assign[nbrs], minlength=n_shards)
            cur = assign[v]
            t = int(np.argmax(cnt))
            if t != cur and cnt[t] > cnt[cur] and sizes[t] < refine_cap:
                assign[v] = t  # scatter: unique target (scalar vertex id)
                sizes[t] += 1  # scatter: unique target (scalar shard id)
                sizes[cur] -= 1  # scatter: unique target (scalar shard id)
                moved = True
        if not moved:
            break
    return assign


def block_partition(topo: SparseTopology, n_shards: int) -> np.ndarray:
    """Contiguous-id blocks — the trivial baseline the greedy cut beats."""
    m = math.ceil(topo.n / max(1, n_shards))
    return (np.arange(topo.n) // m).astype(np.int32)


def _directed_edges(tabs, live=None):
    """Directed (receiver, sender) pairs of the candidate slot tables.

    src = the row owner (the agent whose slot it is — the *receiver* of
    messages on that slot), dst = the slot's neighbor (the sender).  An
    optional (n, k_max) bool ``live`` mask restricts to surviving slots
    (joint graph learning prunes slots; DESIGN.md §13).
    """
    cand = np.arange(tabs.k_max)[None, :] < tabs.deg_count[:, None]
    if live is not None:
        cand = cand & np.asarray(live, bool)
    rows, slots = np.nonzero(cand)
    return rows.astype(np.int64), tabs.nbr_idx[rows, slots].astype(np.int64)


def edge_cut(topo: SparseTopology, assignment: np.ndarray) -> int:
    """Number of undirected edges crossing shard boundaries."""
    src, dst = _directed_edges(topo.tables)
    a = np.asarray(assignment)
    return int((a[src] != a[dst]).sum()) // 2


# ---------------------------------------------------------------------------
# Partition layout: local blocks, boundary buffers, halo fetch tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GraphPartition:
    """Host-side shard/halo layout of a topology (see module docstring).

    Shapes: owner/local_pos/perm_slot (n,); local_ids (P, m) with -1 pads;
    bnd_pos (P, B); halo_src_shard/halo_src_pos (P, H); fetch (P, n).
    ``fetch[q, a]`` is agent a's row in shard q's ext buffer: < m if local,
    m..m+H-1 if in q's halo, m+H (the zero row) otherwise.
    """

    n: int
    n_shards: int
    shard_size: int                 # m
    owner: np.ndarray
    local_pos: np.ndarray
    perm_slot: np.ndarray           # owner * m + local_pos
    local_ids: np.ndarray
    bnd_pos: np.ndarray
    halo_src_shard: np.ndarray
    halo_src_pos: np.ndarray
    fetch: np.ndarray
    edge_cut: int

    @property
    def halo_size(self) -> int:
        """Per-shard halo slot count H (max over shards; 0 if no cut)."""
        return self.halo_src_shard.shape[1]

    @property
    def boundary_size(self) -> int:
        """Per-shard boundary slot count B (rows other shards read)."""
        return self.bnd_pos.shape[1]

    @classmethod
    def build(cls, topo: SparseTopology, assignment: np.ndarray,
              n_shards: Optional[int] = None,
              live: Optional[np.ndarray] = None) -> "GraphPartition":
        """Shard/halo layout of ``topo`` under ``assignment``.

        ``live`` (optional, (n, k_max) bool) restricts the layout to the
        surviving directed slots of a joint graph-learning run: the halo
        of a shard then holds only the remote *senders* some local live
        slot still reads, and the boundary only the local agents some
        remote live slot still needs — the halo re-compaction of the joint
        sharded engine (DESIGN.md §13).  The local block layout (owner /
        local_pos / perm_slot) depends only on ``assignment``, so
        re-compacted layouts are drop-in replacements for each other's
        sharded state.
        """
        tabs = topo.tables
        n = topo.n
        owner = np.asarray(assignment, np.int32)
        P_ = int(n_shards if n_shards is not None else owner.max() + 1)
        sizes = np.bincount(owner, minlength=P_)
        m = max(1, int(sizes.max()))

        by_shard = np.argsort(owner, kind="stable")      # id-sorted per shard
        local_pos = np.empty(n, np.int32)
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        local_pos[by_shard] = (np.arange(n) - starts[owner[by_shard]]) \
            .astype(np.int32)  # scatter: unique targets (by_shard is a permutation)
        local_ids = np.full((P_, m), -1, np.int32)
        # scatter: unique targets ((owner, local_pos) pairs are distinct)
        local_ids[owner, local_pos] = np.arange(n, dtype=np.int32)
        perm_slot = owner.astype(np.int64) * m + local_pos

        src, dst = _directed_edges(tabs, live)
        cross = owner[src] != owner[dst]
        cut = int(cross.sum()) // 2

        # boundary: local agents some remote live slot reads (the *senders*
        # published each round), id-sorted per shard.  For the symmetric
        # live=None candidate tables this is exactly "local agents with any
        # cross edge".
        is_bnd = np.zeros(n, bool)
        is_bnd[dst[cross]] = True  # scatter: idempotent (every value is True)
        bnd_lists = [np.where(is_bnd & (owner == q))[0] for q in range(P_)]
        B = max((len(b) for b in bnd_lists), default=0)
        bnd_pos = np.zeros((P_, B), np.int32)
        bnd_rank = np.zeros(n, np.int64)
        for q, lst in enumerate(bnd_lists):
            bnd_pos[q, :len(lst)] = local_pos[lst]
            bnd_rank[lst] = np.arange(len(lst))  # scatter: unique targets

        # halo of q: remote endpoints of q's cross edges, id-sorted
        halo_lists = [np.unique(dst[cross & (owner[src] == q)])
                      for q in range(P_)]
        H = max((len(h) for h in halo_lists), default=0)
        halo_src_shard = np.zeros((P_, H), np.int32)
        halo_src_pos = np.zeros((P_, H), np.int32)
        fetch = np.full((P_, n), m + H, np.int32)
        fetch[owner, np.arange(n)] = local_pos  # scatter: unique targets
        for q, hl in enumerate(halo_lists):
            halo_src_shard[q, :len(hl)] = owner[hl]
            halo_src_pos[q, :len(hl)] = bnd_rank[hl]
            # scatter: unique targets (hl lists distinct halo agents)
            fetch[q, hl] = m + np.arange(len(hl), dtype=np.int32)

        return cls(n=n, n_shards=P_, shard_size=m, owner=owner,
                   local_pos=local_pos, perm_slot=perm_slot,
                   local_ids=local_ids, bnd_pos=bnd_pos,
                   halo_src_shard=halo_src_shard, halo_src_pos=halo_src_pos,
                   fetch=fetch, edge_cut=cut)

    def shard_rows(self, x: np.ndarray) -> np.ndarray:
        """Permute per-agent rows (n, ...) into the stacked padded layout
        (P * m, ...); pad rows are zero."""
        x = np.asarray(x)
        ids = self.local_ids.reshape(-1)
        out = x[np.maximum(ids, 0)]
        out[ids < 0] = 0  # scatter: unique targets (boolean mask)
        return out

    def unshard_rows(self, y):
        """Inverse of :meth:`shard_rows` along the last-but-(ndim-1) axis:
        (..., P * m, ...) indexed back to original agent order (..., n,
        ...).  Works on the leading-agent axis right after any batch dims."""
        return np.asarray(y)[..., self.perm_slot, :]


# ---------------------------------------------------------------------------
# Sharded traces, capacities, set-up
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedSimTrace(SimTrace):
    """SimTrace plus partition diagnostics.

    overflow: events that missed the static per-shard buffers (0 => the
    trajectory is exactly the single-device one).
    """

    n_shards: int = 1
    edge_cut: int = 0
    halo_size: int = 0
    local_batch: int = 0
    overflow: int = 0


@dataclasses.dataclass
class JointShardedTrace(ShardedSimTrace):
    """ShardedSimTrace plus graph-learning outputs and re-compaction stats.

    Fields mirror ``engines.JointSimTrace``; ``recompactions`` counts halo
    re-compactions performed (each shrinks ``halo_size`` to the live cross
    edges at that point — the reported ``halo_size`` is the final one).
    """

    final_w: Optional[torch.Tensor] = None
    final_live: Optional[torch.Tensor] = None
    live_edges_hist: Optional[torch.Tensor] = None
    suppressed: int = 0
    recompactions: int = 0


def _binomial_cap(trials: int, n_shards: int, cap: int) -> int:
    """mean + 8 sigma of Binomial(trials, 1/P), clamped to the lossless
    capacity ``cap`` — at 8 sigma overflow is ~never observed, and any
    occurrence is counted in the trace."""
    if n_shards <= 1:
        return cap
    q = 1.0 / n_shards
    mean = trials * q
    std = math.sqrt(trials * q * (1.0 - q))
    return int(min(cap, math.ceil(mean + 8.0 * std + 16)))


def default_local_batch(batch: int, n_shards: int) -> int:
    """Static per-shard update capacity (each of 2B endpoints lands on a
    given shard w.p. ~1/P; 2B = lossless whatever the draw)."""
    return _binomial_cap(2 * batch, n_shards, 2 * batch)


def default_local_events(batch: int, n_shards: int) -> int:
    """Static per-shard event capacity (an event is relevant to a shard
    when it owns either endpoint, w.p. <= 2/P)."""
    return _binomial_cap(2 * batch, n_shards, batch)


def _sharded_setup(topo, n_shards, mesh, assignment, partition_seed,
                   device=None):
    """Shared preamble of the three sharded runners: resolve the mesh
    (``make_sim_mesh(n_shards, device)`` when None), the shard assignment
    (greedy by default, validated when explicit) and the graph partition.
    Returns ``(mesh, P_, assignment, part)``.
    """
    mesh = make_sim_mesh(n_shards, device) if mesh is None else mesh
    P_ = mesh.n_shards
    if assignment is None:
        assignment = greedy_partition(topo, P_, seed=partition_seed)
    elif int(np.max(assignment)) >= P_:
        raise ValueError(
            f"assignment uses shard {int(np.max(assignment))} but the mesh "
            f"has only {P_} shards (make the mesh with more shards, or one "
            f"process a shard for a DistMesh)")
    part = GraphPartition.build(topo, assignment, P_)
    return mesh, P_, assignment, part


def _local_capacities(batch: int, P_: int, local_batch) -> tuple:
    """Per-shard static (event, update) capacities ``(E, U)`` — the
    8-sigma defaults, or the lossless explicit-capacity override."""
    if local_batch is None:
        E = default_local_events(batch, P_)
        U = default_local_batch(batch, P_)
    else:                      # explicit capacity: lossless event selection
        E = batch
        U = max(1, min(local_batch, 2 * batch))
    return E, min(U, 2 * E)


def _event_stream(stream, topo, tabs, conditions, batch, seed, rounds,
                  device):
    """The run's stream: the caller's (checked to cover the horizon; its
    batch width wins) or one drawn from ``seed`` on ``device``."""
    if stream is None:
        return precompute_event_stream(
            tabs, torch.as_tensor(topo.partition_halves()), conditions,
            batch, seed, rounds, device=device), batch
    if stream.rounds < rounds:
        raise ValueError(f"stream covers {stream.rounds} rounds but the "
                         f"clamped horizon is {rounds}")
    stream = EventStream(*(f[:rounds].to(device) for f in stream))
    return stream, int(stream.i.shape[1])


def _stream_counters(stream, n_rec, record_every):
    """(active_hist, delivered, dropped, invalid) of the run's rounds."""
    total = n_rec * record_every
    run = EventStream(*(f[:total] for f in stream))
    ends = torch.arange(1, n_rec + 1, device=stream.i.device) \
        * record_every - 1
    return (stream.active_frac[ends],) + stream_totals(run)


# ---------------------------------------------------------------------------
# The round body over a leading shard axis
# ---------------------------------------------------------------------------


def _compact(mask, cap: int, fill: int):
    """Per shard, the positions of ``mask`` (S, L)'s True entries in
    ascending order, the first ``cap`` of them, padded with ``fill``:
    (S, cap) int64 (``jnp.nonzero(size=cap, fill_value=fill)`` per shard),
    and the True counts (S,).  A cumsum and a scatter into a trash column,
    so nothing synchronises with the host.  The ranks come from one scan
    over the flattened mask, each row's less the rows before it."""
    S, L = mask.shape
    flat = torch.cumsum(mask.reshape(-1), dim=0).view(S, L)
    before = torch.cat([flat.new_zeros(1), flat[:-1, -1]])
    rank = flat - before[:, None] - 1
    slot = torch.where(mask & (rank < cap), rank, cap)
    out = torch.full((S, cap + 1), fill, dtype=torch.int64,
                     device=mask.device)
    # scatter: unique targets — the ranks below cap are distinct in a row;
    # every other entry lands in the trash column cap
    out.scatter_(1, slot, torch.arange(L, device=mask.device).expand(S, L))
    return out[:, :cap], mask.sum(dim=1)


def _take(x, sel, fill):
    """Each shard's entries ``sel`` (S, cap) of the event fields x (F, L),
    which every shard shares; the out-of-range index L reads ``fill``.
    Returns (F, S, cap)."""
    pad = torch.cat([x, x.new_full((x.shape[0], 1), fill)], dim=1)
    return pad.index_select(1, sel.reshape(-1)).view(
        (x.shape[0],) + tuple(sel.shape))


def _take_rows(x, sel, fill):
    """``x[q, sel[q]]`` for each shard q of x (S, L), sel (S, cap); the
    out-of-range index L reads ``fill``."""
    pad = x.new_full((x.shape[0], 1), fill)
    return torch.cat([x, pad], dim=1).gather(1, sel)


class _Events(NamedTuple):
    """One round's events touching each local shard, compacted (S, E)."""

    i: torch.Tensor
    j: torch.Tensor
    s: torch.Tensor
    r: torch.Tensor
    d_ij: torch.Tensor
    d_ji: torch.Tensor
    st_ij: torch.Tensor
    st_ji: torch.Tensor
    f_i: torch.Tensor          # i's row in the shard's ext buffer
    f_j: torch.Tensor


def _shard_events(ev, fetch, m: int, E: int):
    """Compact round ``ev``'s events to those with an endpoint local to
    each shard (everything after runs at O(E) ~ 2B/P instead of O(B));
    returns the :class:`_Events` and the per-shard overflow (S,)."""
    i, j = ev.i.long(), ev.j.long()
    rel = (fetch.index_select(1, i) < m) | (fetch.index_select(1, j) < m)
    sel, count = _compact(rel, E, int(i.shape[0]))
    ids = _take(torch.stack([i, j, ev.s.long(), ev.r.long()]), sel, 0)
    flags = _take(torch.stack([ev.deliver_ij, ev.deliver_ji, ev.stale_ij,
                               ev.stale_ji]), sel, False)
    ii, jj = ids[0], ids[1]
    out = _Events(ii, jj, ids[2], ids[3], *flags.unbind(0),
                  fetch.gather(1, ii), fetch.gather(1, jj))
    return out, torch.clamp(count - E, min=0)


class _Layout:
    """One ``GraphPartition``'s tables for this process's shards, on the
    mesh's device: the fetch rows (S, n), the halo exchange, and the
    local-id map that places per-agent rows into shard blocks."""

    def __init__(self, part: GraphPartition, mesh, exchange, codec):
        dev = mesh.device
        self.part = part
        self.m, self.H = part.shard_size, part.halo_size
        self.fetch = mesh.local(torch.as_tensor(part.fetch, device=dev)
                                .long())
        self.exchange = halo_exchange_fn(part.bnd_pos, part.halo_src_shard,
                                         part.halo_src_pos, part.halo_size,
                                         mesh, exchange, codec)
        self.ids = mesh.local(torch.as_tensor(part.local_ids, device=dev)
                              .long())
        self.S = int(self.ids.shape[0])
        self.shard = torch.arange(self.S, device=dev)[:, None]

    def block(self, x, trash: bool = False):
        """Per-agent rows (n, ...) -> local shard blocks (S, m, ...), pad
        rows zero; ``trash`` appends the zero trash row (S, m + 1, ...)."""
        out = x[self.ids.clamp(min=0)]
        out[self.ids < 0] = 0  # scatter: unique targets (boolean mask)
        if trash:
            out = torch.cat([out, torch.zeros_like(out[:, :1])], dim=1)
        return out.contiguous()

    def flat_rows(self, rows, size=None):
        """Row ids (S, L) of (S, size, ...) blocks (size m + 1 when None)
        -> flat ids into the (S * size, ...) view."""
        size = self.m + 1 if size is None else size
        return (self.shard * size + rows).reshape(-1)

    def rows(self, x, rows):
        """Rows (S, L) of each shard's block of x (S, R, ...) -> (S * L,
        ...), one flat gather."""
        return x.reshape((-1,) + tuple(x.shape[2:])).index_select(
            0, self.flat_rows(rows, x.shape[1]))


def _gather_shards(mesh, x, axis: int = 0):
    """Per-shard blocks with the shard axis at ``axis`` -> every shard's
    blocks (the identity on a LocalMesh)."""
    if mesh.kind == "local":
        return x
    x = x.movedim(axis, 0).contiguous()
    return mesh.all_gather(x).movedim(0, axis)


def _unshard(part, x, axis: int = 0):
    """Shard blocks with (P, m) at ``axis``, ``axis + 1`` -> agent rows
    (n,) at ``axis``, in agent order."""
    shape = tuple(x.shape)
    flat = x.reshape(shape[:axis] + (shape[axis] * shape[axis + 1],)
                     + shape[axis + 2:])
    return flat.index_select(
        axis, torch.as_tensor(part.perm_slot, device=x.device))


class _ShardTelemetry:
    """A sharded run's telemetry on the device: per-shard staleness (S, m)
    and update counters (S,), advanced from each round's local receivers,
    and the per-chunk snapshots (DESIGN.md §14)."""

    def __init__(self, S: int, m: int, device):
        self.S, self.m = S, m
        self.stale = torch.zeros((S, m), dtype=torch.int32, device=device)
        self.updates = torch.zeros(S, dtype=torch.int64, device=device)
        self.snaps = []

    def round(self, f_u, got):
        """Advance by one round: ``f_u`` (S, 2E) endpoint rows, ``got``
        whether each applied a local update."""
        S, m = self.S, self.m
        shard = torch.arange(S, device=f_u.device)[:, None]
        rows = torch.where(f_u < m, shard * m + f_u, S * m)
        self.stale = tmetrics.staleness_step(
            self.stale.reshape(-1), got.reshape(-1), rows.reshape(-1),
            S * m).reshape(S, m)
        self.updates += got.sum(dim=1)

    def chunk(self, objective, suppressed=None):
        """Snapshot the end of a record chunk with its (S, m) objective."""
        self.snaps.append((objective, self.stale.clone(),
                           self.updates.clone(),
                           None if suppressed is None
                           else suppressed.clone()))


def _tel_blocks(mesh, part, snaps):
    """Stacked per-chunk telemetry of the local shards -> (objective (n_rec,
    n), staleness (n_rec, n), updates (n_rec,), suppressed (n_rec,) or
    None) as numpy, every shard gathered, in agent order."""
    obj, stale, upd, sup = zip(*snaps)

    def agents(x):
        return _unshard(part, _gather_shards(mesh, torch.stack(x), 1), 1) \
            .cpu().numpy()

    def total(x):
        return _gather_shards(mesh, torch.stack(x), 1).sum(dim=1) \
            .cpu().numpy().astype(np.int64)

    return (agents(obj), agents(stale), total(upd),
            None if sup[0] is None else total(sup))


class _MPShards:
    """The MP / joint round body over the local shards' stacked state.

    theta (S, m + 1, p) and K (S, m + 1, k, p) carry a trash row; the
    mixing weights ``w`` (S, m, k) are ``nbr_p``, or the joint engine's
    learned weights with ``live`` (S, m, k) the surviving slots.  Two ext
    buffers (2, S, m + H + 1, p) are taken in turn: this round's, and the
    previous round's, which serves the stale messages.  ``overflow`` and
    ``suppressed`` are (S,) counters on the device.
    """

    def __init__(self, lay: _Layout, theta_sol, c, K0, nbr_p, deg_count,
                 alpha, E, U, backend, graph=None):
        self.lay = lay
        self.alpha, self.E, self.U, self.backend = alpha, E, U, backend
        k = nbr_p.shape[1]
        self.theta = lay.block(theta_sol, trash=True)
        self.K = lay.block(K0, trash=True)
        self.w = lay.block(nbr_p)
        self.c = lay.block(c)
        self.sol = lay.block(theta_sol)
        self.live = lay.block(live_slots(deg_count, k))
        self.graph = graph          # (eta, lam, every, prune_eps) or None
        self.prune = graph is not None and graph[0] > 0.0 \
            and graph[3] is not None
        dev = self.theta.device
        self.overflow = torch.zeros(lay.S, dtype=torch.int64, device=dev)
        self.suppressed = torch.zeros(lay.S, dtype=torch.int64, device=dev)
        self._buffers(lay, self.theta[:, :lay.m])

    def _buffers(self, lay, theta_prev):
        """The two ext buffers of ``lay``, the previous one (index
        ``self.prev``) holding ``theta_prev``'s exchange."""
        m, p = lay.m, self.theta.shape[2]
        self.ext = self.theta.new_empty((2, lay.S, m + lay.H + 1, p))
        self.prev = 1
        self.ext[1, :, :m] = theta_prev
        lay.exchange.fill(self.ext[1], m)

    def relayout(self, lay: _Layout):
        """Adopt a re-compacted layout: the stale-message buffer is rebuilt
        from the previous round's models (its local rows) under it."""
        theta_prev = self.ext[self.prev, :, :lay.m].clone()
        self.lay = lay
        self._buffers(lay, theta_prev)

    def round(self, ev, t: int, tel=None):
        """Global round ``t``: land the delivered messages, then the Eq. 6
        update of every local receiver, then (joint) the graph step."""
        lay, m, S = self.lay, self.lay.m, self.lay.S
        k, p = self.K.shape[2], self.K.shape[3]
        cur, M = 1 - self.prev, m + lay.H + 1
        ext = self.ext[cur]                           # round-start snapshot
        ext[:, :m] = self.theta[:, :m]
        lay.exchange.fill(ext, m)
        e, ovf = _shard_events(ev, lay.fetch, m, self.E)
        self.overflow += ovf
        f_i, f_j = e.f_i, e.f_j
        ok_ij, ok_ji = e.d_ij, e.d_ji
        if self.prune:
            live = self.live.reshape(-1, 1)
            lv_j = lay.rows(live.view(S, -1, 1), f_j.clamp(max=m - 1) * k
                            + e.r).view(S, -1) & (f_j < m)
            lv_i = lay.rows(live.view(S, -1, 1), f_i.clamp(max=m - 1) * k
                            + e.s).view(S, -1) & (f_i < m)
            ok_ij, ok_ji = e.d_ij & lv_j, e.d_ji & lv_i
            self.suppressed += (e.d_ij & (f_j < m) & ~lv_j).sum(dim=1) \
                + (e.d_ji & (f_i < m) & ~lv_i).sum(dim=1)
        # messages: a stale one reads the previous round's buffer
        both = self.ext.view(-1, p)
        base = lay.S * M
        msg_i = both.index_select(0, lay.flat_rows(f_i, M) + base
                                  * torch.where(e.st_ij, self.prev, cur)
                                  .reshape(-1))
        msg_j = both.index_select(0, lay.flat_rows(f_j, M) + base
                                  * torch.where(e.st_ji, self.prev, cur)
                                  .reshape(-1))
        Kf = self.K.view(-1, p)
        row_j = torch.where(ok_ij & (f_j < m), f_j, m)
        row_i = torch.where(ok_ji & (f_i < m), f_i, m)
        # scatter: idempotent — every write to one slot in one round comes
        # from the same sender with the same staleness flag, so duplicate
        # targets carry identical payloads (undelivered ones go to trash)
        Kf[lay.flat_rows(row_j) * k + e.r.reshape(-1)] = msg_i
        # scatter: idempotent (same argument, j -> i direction)
        Kf[lay.flat_rows(row_i) * k + e.s.reshape(-1)] = msg_j

        f_u = torch.cat([f_i, f_j], dim=1)
        got = torch.cat([ok_ji, ok_ij], dim=1) & (f_u < m)
        usel, n_got = _compact(got, self.U, 2 * self.E)
        lu = _take_rows(f_u, usel, m)
        lu_c = lu.clamp(max=m - 1)
        U = self.U
        new = batched_model_update(
            lay.rows(self.w, lu_c), lay.rows(self.K, lu_c),
            lay.rows(self.c, lu_c), lay.rows(self.sol, lu_c), self.alpha,
            self.backend)
        # scatter: idempotent — duplicate rows in lu recompute the same
        # value from the same post-communication K
        self.theta.view(-1, p)[lay.flat_rows(torch.where(lu < m, lu, m))] \
            = new
        self.overflow += torch.clamp(n_got - U, min=0)
        if self.graph is not None:
            eta, lam, every, prune_eps = self.graph
            if eta > 0.0 and (t + 1) % every == 0:
                w = reweight_rows(self.theta[:, :m].reshape(S * m, p),
                                  self.K[:, :m].reshape(S * m, k, p),
                                  self.w.reshape(S * m, k),
                                  self.live.reshape(S * m, k), eta=eta,
                                  lam=lam, backend=self.backend)
                live = self.live.reshape(S * m, k)
                if prune_eps is not None:
                    w, live = prune_rows(w, live, prune_eps)
                self.w = w.reshape(S, m, k)
                self.live = live.reshape(S, m, k)
        if tel is not None:
            tel.round(f_u, got)
        self.prev = cur

    def objective(self):
        """(S, m) Eq. 3 local objective (learned weights, pruned slots at
        0, in joint runs)."""
        lay, m = self.lay, self.lay.m
        S, k, p = lay.S, self.K.shape[2], self.K.shape[3]
        w = self.w if self.graph is None \
            else torch.where(self.live, self.w, 0.0)
        return tmetrics.mp_local_objective(
            self.theta[:, :m].reshape(S * m, p),
            self.K[:, :m].reshape(S * m, k, p), w.reshape(S * m, k),
            self.c.reshape(-1), self.sol.reshape(S * m, p),
            self.alpha).reshape(S, m)


def _mp_setup(topo, theta_sol, c, device):
    n = topo.n
    tabs = topo.device_tables(device)
    theta_sol = torch.as_tensor(theta_sol, dtype=torch.float32,
                                device=device).reshape(n, -1).contiguous()
    c = torch.as_tensor(c, dtype=torch.float32, device=device)
    return tabs, theta_sol, c


def _frames(mesh, part, stream, n_rec, record_every, snaps, overflow,
            halo_bytes):
    obj, stale, upd, sup = _tel_blocks(mesh, part, snaps)
    return TelemetryFrames(
        rounds=(np.arange(n_rec, dtype=np.int64) + 1) * record_every,
        objective=obj, staleness=stale, updates=upd,
        halo_bytes=halo_bytes,
        overflow_per_shard=np.asarray(overflow, np.int64),
        suppressed=sup,
        **tmetrics.stream_chunk_totals(stream, n_rec, record_every))


def run_mp_scenario_sharded(topo: SparseTopology, theta_sol, c, alpha: float,
                            conditions: NetworkConditions, rounds: int,
                            batch: int, seed: int = 0,
                            record_every: int = 10, *,
                            n_shards: Optional[int] = None, mesh=None,
                            assignment: Optional[np.ndarray] = None,
                            local_batch: Optional[int] = None,
                            exchange: str = "all_gather",
                            halo_codec="f32", partition_seed: int = 0,
                            stream: Optional[EventStream] = None,
                            telemetry: Optional[TelemetryConfig] = None,
                            device=None) -> ShardedSimTrace:
    """``engines.run_mp_scenario`` over a graph partitioned across the
    mesh (``make_sim_mesh(n_shards, device)`` when ``mesh`` is None).

    Same scenario semantics as the single-device engine; ``theta_hist``
    equals its per-op round body (``backend=None``) bit for bit whenever
    ``overflow`` is 0.  ``assignment`` reuses a precomputed partition,
    ``exchange="ring"`` takes the ring halo path, and ``halo_codec``
    selects the boundary-row wire format (``launch.sim_mesh.HaloCodec``:
    "f32", the default, or the lossy "bf16"/"int8" with float32
    accumulation); the telemetry ``halo_bytes`` column counts the coded
    wire size.  ``stream`` replays a precomputed EventStream (e.g. the
    JAX package's); otherwise one is drawn from ``seed``.
    """
    mesh, P_, assignment, part = _sharded_setup(
        topo, n_shards, mesh, assignment, partition_seed, device)
    dev = mesh.device
    tabs, theta_sol, c = _mp_setup(topo, theta_sol, c, dev)
    record_every, n_rec = record_chunks(rounds, record_every)
    total_rounds = n_rec * record_every
    stream, batch = _event_stream(stream, topo, tabs, conditions, batch,
                                  seed, total_rounds, dev)
    E, U = _local_capacities(batch, P_, local_batch)
    codec = resolve_halo_codec(halo_codec)
    lay = _Layout(part, mesh, exchange, codec)
    st = _MPShards(lay, theta_sol, c, theta_sol[tabs.nbr_idx.long()],
                   tabs.nbr_p, tabs.deg_count, alpha, E, U, None)
    tel = _ShardTelemetry(lay.S, lay.m, dev) if telemetry_on(telemetry) \
        else None
    hist = []
    for t in range(total_rounds):
        st.round(stream.batch_at(t), t, tel)
        if (t + 1) % record_every == 0:
            hist.append(st.theta[:, :lay.m].clone())
            if tel is not None:
                tel.chunk(st.objective())
    overflow = _gather_shards(mesh, st.overflow)
    frames = None
    if tel is not None:
        per_round = halo_payload_bytes(
            P_, part.boundary_size, codec.row_nbytes((theta_sol.shape[1],)),
            part.halo_size)
        frames = _frames(mesh, part, stream, n_rec, record_every, tel.snaps,
                         overflow.cpu().numpy(),
                         (np.arange(n_rec, dtype=np.int64) + 1)
                         * record_every * per_round)
    theta_hist = _unshard(part, _gather_shards(mesh, torch.stack(hist), 1),
                          1)
    active_hist, delivered, dropped, invalid = _stream_counters(
        stream, n_rec, record_every)
    return ShardedSimTrace(
        theta_hist, active_hist, delivered, dropped, total_rounds,
        total_rounds * batch, invalid, telemetry=frames, n_shards=P_,
        edge_cut=part.edge_cut, halo_size=part.halo_size, local_batch=U,
        overflow=int(overflow.sum()))


# ---------------------------------------------------------------------------
# Sharded CL-ADMM scenario engine (DESIGN.md §12)
# ---------------------------------------------------------------------------


def run_cl_scenario_sharded(topo: SparseTopology, data: AgentData, mu: float,
                            rho: float, conditions: NetworkConditions,
                            rounds: int, batch: int, seed: int = 0,
                            record_every: int = 10, *, theta_sol=None,
                            n_shards: Optional[int] = None, mesh=None,
                            assignment: Optional[np.ndarray] = None,
                            local_batch: Optional[int] = None,
                            exchange: str = "all_gather",
                            halo_codec="f32", partition_seed: int = 0,
                            stream: Optional[EventStream] = None,
                            telemetry: Optional[TelemetryConfig] = None,
                            primal=None, device=None) -> ShardedSimTrace:
    """``engines.run_cl_scenario`` over a graph partitioned across the
    mesh (DESIGN.md §12).

    Same scenario semantics as the single-device CL-ADMM engine —
    ``theta_hist`` reproduces it bit for bit whenever ``overflow`` is 0.
    The six ADMM state arrays are row-sharded; edge state never leaves its
    owner.  Per round one halo exchange, placed between the primal and the
    edge phase, mirrors each boundary agent's post-primal (theta, K) and
    round-start (L_own, L_nbr) rows as one stacked ``[theta | K | L_own |
    L_nbr]`` payload row (one int8 scale per model/dual component under
    the int8 codec) onto the shards holding the other endpoint of its
    cross-shard edges; the previous round's payload buffer serves the
    stale payloads, and each shard applies the shared edge half-step to
    its own slots only.  Knobs match :func:`run_mp_scenario_sharded`.

    ``primal`` selects the primal-phase solver as in
    ``engines.run_cl_scenario`` (``core.primal``); the solve is row-local,
    so a solver needing data gets the rows' padded local datasets
    row-sharded beside the ADMM state.
    """
    mesh, P_, assignment, part = _sharded_setup(
        topo, n_shards, mesh, assignment, partition_seed, device)
    dev = mesh.device
    if primal is None:
        primal = ExactQuadraticPrimal()
    elif not callable(getattr(primal, "solve_batch", None)):
        raise TypeError(f"primal solver {type(primal).__name__} has no "
                        f"solve_batch method")
    if theta_sol is None:
        raise ValueError("need theta_sol (warm start)")
    tabs = topo.device_tables(dev)
    record_every, n_rec = record_chunks(rounds, record_every)
    total_rounds = n_rec * record_every
    stream, batch = _event_stream(stream, topo, tabs, conditions, batch,
                                  seed, total_rounds, dev)
    E, U = _local_capacities(batch, P_, local_batch)
    codec = resolve_halo_codec(halo_codec)
    lay = _Layout(part, mesh, exchange, codec)
    S, m, k = lay.S, lay.m, topo.k_max

    st0 = init_sparse_admm(topo, theta_sol, dev)
    p = st0.theta.shape[1]
    theta, K, Zo, Zn, Lo, Ln = (
        lay.block(a, trash=True)
        for a in (st0.theta, st0.K, st0.Z_own, st0.Z_nbr, st0.L_own,
                  st0.L_nbr))
    del st0
    m_counts, sx = local_stats(data)
    w_b, D_b, mc_b, sx_b = (lay.block(a.to(dev)) for a in (
        tabs.nbr_w, tabs.deg_w, m_counts, sx))
    live_b = lay.block(live_slots(tabs.deg_count, k))
    xym = tuple(lay.block(a.to(dev)) for a in (data.x, data.y, data.mask)) \
        if primal.needs_data else ()
    tel = None
    if telemetry_on(telemetry):
        tel = _ShardTelemetry(S, m, dev)
        if not primal.needs_data:
            x, mask = data.x.to(dev), data.mask.to(dev)
            sxx_b = lay.block(torch.sum(mask * torch.sum(x * x, dim=-1),
                                        dim=1))

    # two payload buffers (2, S, m + H + 1, 1 + 3k, p), taken in turn:
    # this round's and the previous round's (the stale payloads)
    M, W = m + lay.H + 1, 1 + 3 * k
    bufs = torch.empty((2, S, M, W, p), device=dev)
    cells_all = bufs.view(-1, p)

    def publish(buf):
        """Stacked payload rows [theta | K | L_own | L_nbr] -> ext."""
        buf[:, :m, 0] = theta[:, :m]
        buf[:, :m, 1:1 + k] = K[:, :m]
        buf[:, :m, 1 + k:1 + 2 * k] = Lo[:, :m]
        buf[:, :m, 1 + 2 * k:] = Ln[:, :m]
        return lay.exchange.fill(buf, m)

    publish(bufs[1])                                 # warm-start payloads
    overflow = torch.zeros(S, dtype=torch.int64, device=dev)
    hist = []
    for t in range(total_rounds):
        e, ovf = _shard_events(stream.batch_at(t), lay.fetch, m, E)
        overflow += ovf
        f_i, f_j = e.f_i, e.f_j

        # --- primal phase: compact local handshake endpoints, shared
        # exact quadratic step (or the chosen solver)
        f_u = torch.cat([f_i, f_j], dim=1)                   # (S, 2E)
        got = torch.cat([e.d_ji, e.d_ij], dim=1) & (f_u < m)
        usel, n_got = _compact(got, U, 2 * E)
        lu = _take_rows(f_u, usel, m)
        lu_c = lu.clamp(max=m - 1)

        def rows(a):
            return lay.rows(a, lu_c)

        new_theta, theta_js = primal.solve_batch(
            rows(w_b), rows(live_b), rows(Zo), rows(Zn), rows(Lo), rows(Ln),
            rows(D_b), rows(mc_b), rows(sx_b), tuple(rows(a) for a in xym),
            rows(theta), mu, rho)
        new_K = torch.where(rows(live_b)[..., None], theta_js, rows(K))
        rowp = lay.flat_rows(torch.where(lu < m, lu, m))
        # scatter: idempotent — duplicate rows in lu derive identical
        # values from the same round-start Z/L state
        theta.view(-1, p)[rowp] = new_theta
        K.view(-1, k, p)[rowp] = new_K  # scatter: idempotent
        overflow += torch.clamp(n_got - U, min=0)

        # --- publish + halo exchange (post-primal models, round-start
        # duals), then the edge phase reads payloads from ext
        cur = t % 2
        publish(bufs[cur])

        # --- edge phase: one half-step per delivered side whose receiver
        # is local
        own_s = torch.cat([e.s, e.r], dim=1)
        own_c = f_u.clamp(max=m - 1)
        slot = torch.cat([e.r, e.s], dim=1).reshape(-1)    # partner's slot
        # the partner's payload row; a stale side reads the previous
        # round's buffer
        buf = torch.where(torch.cat([e.st_ji, e.st_ij], dim=1), 1 - cur,
                          cur).reshape(-1)
        row = (lay.flat_rows(torch.cat([f_j, f_i], dim=1), M)
               + buf * (S * M)) * W

        def pay(col):
            return cells_all.index_select(0, row + col)

        def cells(a):
            return lay.rows(a.view(S, -1, p), own_c * k + own_s)

        z_own, z_nbr, lo_new, ln_new = admm_edge_halfstep(
            lay.rows(theta, own_c), cells(K), cells(Lo), cells(Ln), pay(0),
            pay(1 + slot), pay(1 + k + slot), pay(1 + 2 * k + slot), rho)
        cell = lay.flat_rows(torch.where(got, f_u, m)) * k \
            + own_s.reshape(-1)
        for arr, val in ((Zo, z_own), (Zn, z_nbr), (Lo, lo_new),
                         (Ln, ln_new)):
            # scatter: idempotent — repeated sides of one edge (wakers are
            # drawn with replacement) read the same round-start cells,
            # post-primal rows and per-sender staleness, so they write
            # identical values; undelivered sides go to the trash row
            arr.view(-1, p)[cell] = val
        if tel is not None:
            tel.round(f_u, got)
        if (t + 1) % record_every == 0:
            hist.append(theta[:, :m].clone())
            if tel is not None:
                th, Kl = theta[:, :m].reshape(S * m, p), \
                    K[:, :m].reshape(S * m, k, p)
                flat = (w_b.reshape(S * m, k), live_b.reshape(S * m, k),
                        D_b.reshape(-1))
                if primal.needs_data:
                    obj = tmetrics.cl_local_objective_from_loss(
                        th, Kl, *flat, primal.batch_local_loss(
                            th, *(a.reshape((S * m,) + tuple(a.shape[2:]))
                                  for a in xym)), mu)
                else:
                    obj = tmetrics.cl_local_objective(
                        th, Kl, *flat, mc_b.reshape(-1),
                        sx_b.reshape(S * m, -1), sxx_b.reshape(-1), mu)
                tel.chunk(obj.reshape(S, m))
    del bufs, cells_all
    overflow = _gather_shards(mesh, overflow)
    frames = None
    if tel is not None:
        per_round = halo_payload_bytes(
            P_, part.boundary_size, codec.row_nbytes((1 + 3 * k, p)),
            part.halo_size)
        frames = _frames(mesh, part, stream, n_rec, record_every, tel.snaps,
                         overflow.cpu().numpy(),
                         (np.arange(n_rec, dtype=np.int64) + 1)
                         * record_every * per_round)
    theta_hist = _unshard(part, _gather_shards(mesh, torch.stack(hist), 1),
                          1)
    active_hist, delivered, dropped, invalid = _stream_counters(
        stream, n_rec, record_every)
    return ShardedSimTrace(
        theta_hist, active_hist, delivered, dropped, total_rounds,
        total_rounds * batch, invalid, telemetry=frames, n_shards=P_,
        edge_cut=part.edge_cut, halo_size=part.halo_size, local_batch=U,
        overflow=int(overflow.sum()))


# ---------------------------------------------------------------------------
# Sharded joint model + collaboration-graph learning (DESIGN.md §13)
# ---------------------------------------------------------------------------


def _live_cross_edges(tabs, owner: np.ndarray, live: np.ndarray) -> int:
    """Directed live candidate slots whose sender lives on another shard
    (the same edge enumeration ``GraphPartition.build`` compacts halos
    from, so the re-compaction trigger and the rebuild always agree)."""
    src, dst = _directed_edges(tabs, live)
    return int((owner[src] != owner[dst]).sum())


def run_joint_scenario_sharded(topo: SparseTopology, theta_sol, c,
                               alpha: float, conditions: NetworkConditions,
                               rounds: int, batch: int, seed: int = 0,
                               record_every: int = 10, *,
                               eta_graph: float = 0.0, lam: float = 1.0,
                               graph_every: int = 1,
                               prune_eps: Optional[float] = None,
                               recompact_every: Optional[int] = None,
                               recompact_frac: float = 0.25,
                               n_shards: Optional[int] = None, mesh=None,
                               assignment: Optional[np.ndarray] = None,
                               local_batch: Optional[int] = None,
                               exchange: str = "all_gather",
                               halo_codec="f32", partition_seed: int = 0,
                               stream: Optional[EventStream] = None,
                               backend=None,
                               telemetry: Optional[TelemetryConfig] = None,
                               device=None) -> JointShardedTrace:
    """``engines.run_joint_scenario`` over a graph partitioned across the
    mesh (DESIGN.md §13).

    Same scenario semantics as the single-device joint engine —
    ``theta_hist``, ``final_w`` and ``final_live`` reproduce it bit for
    bit whenever ``overflow`` is 0.  The learned weights and the
    candidate-liveness are row-sharded state; the graph step is row-local,
    so it needs no collective.

    **Halo re-compaction**: with pruning on (``prune_eps``) and a
    ``recompact_every`` (rounds) cadence, the runner pauses between
    segments, counts the live *cross-shard* candidate slots (the one read
    of the device between segments), and — once that count has dropped by
    ``recompact_frac`` since the last layout — rebuilds the halo/boundary
    tables over the live edges (``GraphPartition.build(live=...)``).
    Pruning is monotone, so dropped halo rows are never read again and the
    trajectory is unaffected; only the exchange volume shrinks.  Segment
    boundaries land on record chunks.
    """
    mesh, P_, assignment, part = _sharded_setup(
        topo, n_shards, mesh, assignment, partition_seed, device)
    owner = np.asarray(assignment, np.int32)
    full_cut = part.edge_cut
    dev = mesh.device
    host_tabs = topo.tables
    tabs, theta_sol, c = _mp_setup(topo, theta_sol, c, dev)
    record_every, n_rec = record_chunks(rounds, record_every)
    total_rounds = n_rec * record_every
    stream, batch = _event_stream(stream, topo, tabs, conditions, batch,
                                  seed, total_rounds, dev)
    E, U = _local_capacities(batch, P_, local_batch)
    codec = resolve_halo_codec(halo_codec)
    lay = _Layout(part, mesh, exchange, codec)
    st = _MPShards(lay, theta_sol, c, theta_sol[tabs.nbr_idx.long()],
                   tabs.nbr_p, tabs.deg_count, alpha, E, U, backend,
                   graph=(eta_graph, lam, graph_every, prune_eps))

    can_recompact = (eta_graph > 0.0 and prune_eps is not None
                     and recompact_every is not None)
    if can_recompact:
        # repro-lint: disable=RPL007  n_rec already record_chunks-normalized
        seg = recompact_every // record_every
        seg_rec = max(1, min(n_rec, seg))
    else:
        seg_rec = n_rec
    live0 = np.arange(host_tabs.k_max)[None, :] \
        < host_tabs.deg_count[:, None]
    cross_at_compact = _live_cross_edges(host_tabs, owner, live0)

    tel = _ShardTelemetry(lay.S, lay.m, dev) if telemetry_on(telemetry) \
        else None
    p_dim = theta_sol.shape[1]
    halo_cum, halo_off = [], 0
    hist, edges = [], []
    recompactions = 0
    done = 0
    while done < n_rec:
        seg = min(seg_rec, n_rec - done)
        for t in range(done * record_every, (done + seg) * record_every):
            st.round(stream.batch_at(t), t, tel)
            if (t + 1) % record_every == 0:
                hist.append(st.theta[:, :lay.m].clone())
                edges.append((st.live & (st.w > 0)).sum(dim=(1, 2)))
                if tel is not None:
                    tel.chunk(st.objective(), st.suppressed)
        if tel is not None:
            # halo payload of *this* segment's layout (re-compaction
            # shrinks the boundary between segments)
            per_round = halo_payload_bytes(
                P_, lay.part.boundary_size, codec.row_nbytes((p_dim,)),
                lay.part.halo_size)
            rnds = (np.arange(seg, dtype=np.int64) + 1) * record_every
            halo_cum.append(halo_off + rnds * per_round)
            halo_off = int(halo_cum[-1][-1])
        done += seg
        if done < n_rec and can_recompact and cross_at_compact > 0:
            live_host = _unshard(lay.part, _gather_shards(mesh, st.live)) \
                .cpu().numpy()
            cur_cross = _live_cross_edges(host_tabs, owner, live_host)
            if cur_cross <= (1.0 - recompact_frac) * cross_at_compact:
                part = GraphPartition.build(topo, assignment, P_,
                                            live=live_host)
                lay = _Layout(part, mesh, exchange, codec)
                st.relayout(lay)
                cross_at_compact = cur_cross
                recompactions += 1

    overflow = _gather_shards(mesh, st.overflow)
    suppressed = _gather_shards(mesh, st.suppressed)
    frames = None
    if tel is not None:
        frames = _frames(mesh, part, stream, n_rec, record_every, tel.snaps,
                         overflow.cpu().numpy(), np.concatenate(halo_cum))
    theta_hist = _unshard(part, _gather_shards(mesh, torch.stack(hist), 1),
                          1)
    final_w = _unshard(part, _gather_shards(mesh, st.w))
    final_live = _unshard(part, _gather_shards(mesh, st.live))
    live_edges = _gather_shards(mesh, torch.stack(edges), 1).sum(dim=1)
    active_hist, delivered, dropped, invalid = _stream_counters(
        stream, n_rec, record_every)
    return JointShardedTrace(
        theta_hist, active_hist, delivered, dropped, total_rounds,
        total_rounds * batch, invalid, telemetry=frames, n_shards=P_,
        edge_cut=full_cut, halo_size=part.halo_size, local_batch=U,
        overflow=int(overflow.sum()), final_w=final_w,
        final_live=final_live, live_edges_hist=live_edges,
        suppressed=int(suppressed.sum()), recompactions=recompactions)
