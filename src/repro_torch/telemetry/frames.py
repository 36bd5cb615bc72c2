"""Host-side container for a run's accumulated metrics (counterpart of
``repro.telemetry.frames``, field for field).

``TelemetryFrames`` is what the engines attach to their traces
(``SimTrace.telemetry``) when telemetry is enabled: per-record-chunk
per-agent vectors (objective residuals, staleness) plus cumulative
counters (updates, delivered, drop attribution, halo bytes).  All global
reductions — objective sums in float64, staleness percentiles — happen
here, in canonical agent order, so sharded and single-device runs reduce
identical vectors to identical summaries.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class TelemetryFrames:
    """Per-record-chunk metrics of one scenario run (DESIGN.md §14).

    rounds:          (n_rec,) global round index at each snapshot (the end
                     of each record chunk, 1-based)
    objective:       (n_rec, n) per-agent local objective residuals
                     (Eq. 3 / Eq. 7 views; ``metrics.mp_local_objective``
                     / ``metrics.cl_local_objective``)
    staleness:       (n_rec, n) int32 rounds since each agent last
                     absorbed a neighbor update, at each snapshot
    updates:         (n_rec,) cumulative applied model-update ops
    delivered / drop_link / drop_churn / drop_partition / invalid:
                     (n_rec,) cumulative message accounting, drops
                     attributed by cause (``metrics`` module docstring)
    halo_bytes:      (n_rec,) cumulative halo payload bytes published by
                     all shards (sharded runs; None on one device)
    overflow_per_shard: (P,) events that missed a shard's static buffers
                     (sharded runs; None on one device)
    suppressed:      (n_rec,) cumulative deliveries voided by a pruned
                     receiver slot (joint runs; None otherwise)
    serve_requests / serve_hits / serve_misses / serve_invalidations:
                     (n_rec,) cumulative personalization-service counters
                     (DESIGN.md §16) — requests served from each chunk's
                     committed snapshot, mixed-model cache hits/misses,
                     and cache entries invalidated by that chunk's
                     model-update deliveries (None without a serve stream)
    """

    rounds: np.ndarray
    objective: np.ndarray
    staleness: np.ndarray
    updates: np.ndarray
    delivered: np.ndarray
    drop_link: np.ndarray
    drop_churn: np.ndarray
    drop_partition: np.ndarray
    invalid: np.ndarray
    halo_bytes: Optional[np.ndarray] = None
    overflow_per_shard: Optional[np.ndarray] = None
    suppressed: Optional[np.ndarray] = None
    serve_requests: Optional[np.ndarray] = None
    serve_hits: Optional[np.ndarray] = None
    serve_misses: Optional[np.ndarray] = None
    serve_invalidations: Optional[np.ndarray] = None

    @property
    def n_records(self) -> int:
        """Number of record-chunk snapshots in the run."""
        return int(self.rounds.shape[0])

    def summarize(self) -> list:
        """One JSONL-ready dict per record chunk.

        The per-agent vectors are reduced here — and only here — in
        canonical agent order: ``objective`` is the float64 sum over
        agents, ``staleness_p50/p99/max`` are percentiles over agents.
        Identical vectors therefore reduce to identical rows whatever
        mesh produced them.
        """
        rows = []
        for t in range(self.n_records):
            obj = np.asarray(self.objective[t], np.float64)
            st = np.asarray(self.staleness[t], np.float64)
            row = {
                "round": int(self.rounds[t]),
                "objective": float(obj.sum()),
                "objective_mean": float(obj.mean()),
                "staleness_p50": float(np.percentile(st, 50)),
                "staleness_p99": float(np.percentile(st, 99)),
                "staleness_max": int(st.max()),
                "updates": int(self.updates[t]),
                "delivered": int(self.delivered[t]),
                "drop_link": int(self.drop_link[t]),
                "drop_churn": int(self.drop_churn[t]),
                "drop_partition": int(self.drop_partition[t]),
                "invalid": int(self.invalid[t]),
            }
            if self.halo_bytes is not None:
                row["halo_bytes"] = int(self.halo_bytes[t])
            if self.suppressed is not None:
                row["suppressed"] = int(self.suppressed[t])
            if self.serve_requests is not None:
                row["serve_requests"] = int(self.serve_requests[t])
                row["serve_hits"] = int(self.serve_hits[t])
                row["serve_misses"] = int(self.serve_misses[t])
                row["serve_invalidations"] = int(self.serve_invalidations[t])
            rows.append(row)
        if self.overflow_per_shard is not None and rows:
            rows[-1]["overflow_per_shard"] = [
                int(v) for v in np.asarray(self.overflow_per_shard)]
        return rows
