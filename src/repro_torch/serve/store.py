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
* :class:`ServeReport` — the service's counters and served staleness.

``ShardedAgentStateStore`` (per-shard stores behind a read router) waits
for the multi-GPU slice, ROADMAP queue 1 item 10.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import resolve_device

SHARDED_LATER = ("ShardedAgentStateStore routes reads to per-shard stores "
                 "of a device mesh: it waits for ROADMAP queue 1 item 10 "
                 "(multi-GPU)")


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
    """Per-shard stores behind one read router: not ported (ROADMAP queue
    1 item 10)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(SHARDED_LATER)


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
