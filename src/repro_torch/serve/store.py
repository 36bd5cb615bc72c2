"""Agent-state read/write split for the personalization service
(counterpart of ``repro.serve.store``, DESIGN.md §16).

The collaborative engines are the writers: a run commits one snapshot per
record chunk (models and per-agent staleness).  Inference requests are
readers: each takes a user's committed model without touching the run's
buffers, so serving cannot perturb the trajectory, and a reader never
sees a torn snapshot (a commit swaps one reference; a reader holds the
old tuple or the new one).

The committed state lives on the store's device (CUDA when None), and
reads gather rows there.

* :class:`AgentStateStore` — committed ``(round, theta, staleness)``
  snapshots behind an atomic swap.
* :class:`MixedModelCache` — per-user cached model rows, voided by the
  model-update deliveries of each committed chunk
  (``telemetry.metrics.stream_dirty_chunks``): an agent that received no
  update has the same theta row, so a clean entry stays valid.
* :class:`ShardedAgentStateStore` — P per-shard stores, each holding
  only its own block rows (the ``GraphPartition`` layout), behind a read
  router (``launch.sim_mesh.shard_read_route``); it answers every read as
  the single-device store does, bit for bit.
* :class:`ServeReport` — the service's counters and served staleness.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.launch.sim_mesh import shard_read_route


class CommittedState(NamedTuple):
    """One immutable committed snapshot (what readers hold)."""

    round: int               # global round index at the snapshot (1-based)
    theta: torch.Tensor      # (rows, p) float32 personalized models
    staleness: torch.Tensor  # (rows,) int32 rounds since the last update


class AgentStateStore:
    """Read/write-split agent state on ``device``: the writer calls
    :meth:`commit`, readers :meth:`snapshot` and :meth:`read_rows`.  A
    commit copies, then replaces one tuple under a lock; reads take the
    tuple once, without the lock."""

    def __init__(self, n: int, p: int, device=None):
        self.n = int(n)
        self.p = int(p)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._committed = CommittedState(
            0, torch.zeros((self.n, self.p), device=self.device),
            torch.zeros(self.n, dtype=torch.int32, device=self.device))
        self.commits = 0

    def commit(self, round_: int, theta, staleness) -> None:
        """Publish a new snapshot (writer side; copies, then swaps)."""
        theta = torch.as_tensor(theta, dtype=torch.float32).to(
            self.device, copy=True).contiguous()
        staleness = torch.as_tensor(np.asarray(staleness, np.int32)
                                    if not torch.is_tensor(staleness)
                                    else staleness).to(
            self.device, torch.int32, copy=True)
        if tuple(theta.shape) != (self.n, self.p):
            raise ValueError(f"commit shape {tuple(theta.shape)} != "
                             f"({self.n}, {self.p})")
        with self._lock:
            self._committed = CommittedState(int(round_), theta, staleness)
            self.commits += 1

    def snapshot(self) -> CommittedState:
        """The current committed tuple (reader side)."""
        return self._committed

    def snapshot_round(self) -> int:
        """Round index of the current committed snapshot."""
        return self._committed.round

    def read_rows(self, users) -> CommittedState:
        """The requested users' rows of one snapshot: (round, theta,
        staleness).  The tuple is taken once, so a commit racing the
        gather leaves every row from the same snapshot."""
        snap = self.snapshot()
        users = torch.as_tensor(users, device=self.device).long()
        return CommittedState(snap.round, snap.theta[users],
                              snap.staleness[users])


class ShardedAgentStateStore:
    """P per-shard :class:`AgentStateStore` blocks behind one read router,
    on ``device`` (CUDA when None).

    Built from a ``GraphPartition``'s ``owner`` / ``local_pos`` tables:
    shard q's store holds only q's block rows (padded to the shard size
    m), as the partitioned engines shard their state.  :meth:`commit`
    takes agent-order state (what the sharded traces report) and gives
    each shard its own rows; :meth:`read_rows` routes every user to the
    owning shard's store and gathers the row there — the single-device
    store's answer bit for bit.
    """

    def __init__(self, owner, local_pos, p: int,
                 n_shards: Optional[int] = None, device=None):
        self.owner = np.asarray(owner, np.int32)
        self.local_pos = np.asarray(local_pos, np.int32)
        self.n = int(self.owner.shape[0])
        self.p = int(p)
        self.device = resolve_device(device)
        self.n_shards = int(n_shards if n_shards is not None
                            else self.owner.max() + 1)
        m = 1
        for q in range(self.n_shards):
            sel = self.local_pos[self.owner == q]
            m = max(m, int(sel.max()) + 1 if sel.size else 1)
        self.shard_size = m
        # each shard's agents and their rows in its block, on the device
        self._rows = []
        for q in range(self.n_shards):
            ids = np.nonzero(self.owner == q)[0]
            self._rows.append(tuple(torch.as_tensor(a, device=self.device)
                                    for a in (ids, self.local_pos[ids])))
        self._stores = [AgentStateStore(m, p, device=self.device)
                        for _ in range(self.n_shards)]

    def commit(self, round_: int, theta, staleness) -> None:
        """Commit agent-order (n, p) state as per-shard blocks."""
        theta = torch.as_tensor(theta, dtype=torch.float32).to(self.device)
        staleness = torch.as_tensor(np.asarray(staleness, np.int32)
                                    if not torch.is_tensor(staleness)
                                    else staleness).to(self.device,
                                                       torch.int32)
        if tuple(theta.shape) != (self.n, self.p):
            raise ValueError(f"commit shape {tuple(theta.shape)} != "
                             f"({self.n}, {self.p})")
        for store, (ids, pos) in zip(self._stores, self._rows):
            blk = torch.zeros((self.shard_size, self.p), device=self.device)
            stl = torch.zeros(self.shard_size, dtype=torch.int32,
                              device=self.device)
            blk[pos] = theta[ids]  # scatter: unique targets (one row each)
            stl[pos] = staleness[ids]  # scatter: unique targets
            store.commit(round_, blk, stl)

    def snapshot_round(self) -> int:
        """Round index of the latest committed snapshot across shards."""
        return max(s.snapshot().round for s in self._stores)

    def read_rows(self, users) -> CommittedState:
        """Route each user to its owning shard's store and gather rows."""
        users = np.asarray(torch.as_tensor(users).cpu(), np.int64)
        shard, pos = shard_read_route(self.owner, self.local_pos, users)
        theta = torch.empty((users.shape[0], self.p), device=self.device)
        stale = torch.empty(users.shape[0], dtype=torch.int32,
                            device=self.device)
        round_ = 0
        for q in np.unique(shard):
            sel = torch.as_tensor(np.nonzero(shard == q)[0],
                                  device=self.device)
            at = torch.as_tensor(pos[shard == q], device=self.device).long()
            snap = self._stores[q].snapshot()
            theta[sel] = snap.theta[at]  # scatter: unique targets (one each)
            stale[sel] = snap.staleness[at]  # scatter: unique targets
            round_ = max(round_, snap.round)
        return CommittedState(round_, theta, stale)


class MixedModelCache:
    """Per-user cache of served model rows with delivery invalidation, on
    ``device``: a (n,) validity mask, the cached rows, and the round each
    row's model last absorbed an update (``committed round - committed
    staleness``, which cannot change while the entry is clean), so a hit
    at committed round r serves the staleness ``r - last_update`` that a
    fresh store read would.  Counters (hits / misses / invalidations) are
    cumulative."""

    def __init__(self, n: int, p: int, device=None):
        self.n = int(n)
        self.device = resolve_device(device)
        self.valid = torch.zeros(self.n, dtype=torch.bool, device=self.device)
        self.theta = torch.zeros((self.n, int(p)), device=self.device)
        self.last_update = torch.zeros(self.n, dtype=torch.int64,
                                       device=self.device)
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def invalidate(self, dirty) -> int:
        """Void the entries of dirty agents ((n,) bool); returns how many
        were live."""
        dirty = torch.as_tensor(dirty, device=self.device)
        killed = int((self.valid & dirty).sum())
        self.valid &= ~dirty
        self.invalidations += killed
        return killed

    def lookup(self, users, round_: int):
        """``(hit mask, theta rows, staleness rows)`` of a user batch at
        committed round ``round_``; rows of missing users are whatever the
        cache holds — the caller fills them from the store through
        :meth:`fill`.  Advances the hit and miss counters."""
        users = torch.as_tensor(users, device=self.device).long()
        hit = self.valid[users]
        n_hit = int(hit.sum())
        self.hits += n_hit
        self.misses += int(users.shape[0]) - n_hit
        stale = (int(round_) - self.last_update[users]).to(torch.int32)
        return hit, self.theta[users], stale

    def fill(self, users, theta_rows, staleness_rows, round_: int) -> None:
        """Insert freshly read rows for ``users`` (marks them valid)."""
        users = torch.as_tensor(users, device=self.device).long()
        # scatter: idempotent — duplicate users in one batch carry identical
        # rows read from the same committed snapshot
        self.theta[users] = theta_rows
        self.last_update[users] = int(round_) - staleness_rows.long()  # scatter: idempotent
        self.valid[users] = True  # scatter: idempotent (every value is True)


@dataclasses.dataclass
class ServeReport:
    """The accounting of one scenario's served inference requests.

    requests / hits / misses / invalidations: totals over the run;
    served_staleness: (R,) int32 staleness of every served model (rounds
    since the user's model last absorbed a neighbor update, at the
    serving snapshot); requests_c / hits_c / misses_c / invalidations_c:
    (n_rec,) cumulative per-record-chunk counters (what the telemetry
    frames attach).
    """

    requests: int
    hits: int
    misses: int
    invalidations: int
    served_staleness: np.ndarray
    requests_c: np.ndarray
    hits_c: np.ndarray
    misses_c: np.ndarray
    invalidations_c: np.ndarray

    @property
    def hit_rate(self) -> float:
        """Cache hit fraction over all served requests (0.0 if none)."""
        return self.hits / self.requests if self.requests else 0.0

    def staleness_percentile(self, q: float) -> float:
        """Percentile of served staleness (0.0 if nothing was served)."""
        if self.served_staleness.size == 0:
            return 0.0
        return float(np.percentile(self.served_staleness, q))

    def summary(self) -> dict:
        """JSON-ready scalar summary."""
        return {
            "requests": self.requests,
            "cache_hits": self.hits,
            "cache_misses": self.misses,
            "cache_invalidations": self.invalidations,
            "cache_hit_rate": self.hit_rate,
            "served_staleness_p50": self.staleness_percentile(50),
            "served_staleness_p99": self.staleness_percentile(99),
        }
