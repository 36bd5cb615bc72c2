"""Sparse graph container + large-topology generators (counterpart of
``repro.simulate.topology``).

``SparseTopology`` wraps the host-side padded-neighbor tables of
``core.sparse`` plus a per-agent ``groups`` labeling used by the partition
scenarios.  The generators draw exactly what the JAX package draws from
the same seed and produce identical tables (tests/test_torch_tables.py);
the edge deduplication and table construction are vectorised, so a
million-agent topology builds in seconds on the host.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import numpy as np

from repro_torch.core.graph import Graph
from repro_torch.core.sparse import (DeviceTables, NeighborTables,
                                     constant_row_sums,
                                     padded_neighbor_tables, tables_from_csr,
                                     to_device)


@dataclasses.dataclass(frozen=True)
class SparseTopology:
    """Padded-neighbor topology over n agents (host-side numpy arrays)."""

    tables: NeighborTables
    groups: np.ndarray          # (n,) int32 — cluster/half labels (partitions)

    @property
    def n(self) -> int:
        """Number of agents."""
        return self.tables.n

    @property
    def k_max(self) -> int:
        """Padded neighbor-slot count (max degree)."""
        return self.tables.k_max

    @property
    def n_edges(self) -> int:
        """Number of undirected edges."""
        return int(self.tables.deg_count.sum()) // 2

    def device_tables(self, device=None) -> DeviceTables:
        """The neighbor tables as tensors on ``device`` (CUDA when None)."""
        return to_device(self.tables, device)

    @functools.cached_property
    def locality_order(self) -> np.ndarray:
        """(n,) int32 permutation of the agents in which neighbors sit
        close together: reverse Cuthill-McKee over the live slots of the
        neighbor tables (``scipy.sparse.csgraph``), each connected
        component in turn, isolated agents included.  Built on the host on
        first use and kept; ``sparse_sync_mp`` hands it to the
        ``sparse_mix`` kernel as its row schedule."""
        try:
            from scipy.sparse import csr_matrix
            from scipy.sparse.csgraph import reverse_cuthill_mckee
        except ImportError as e:
            raise ImportError(
                f"SparseTopology.locality_order needs scipy "
                f"(scipy.sparse.csgraph.reverse_cuthill_mckee): {e}") from e
        t = self.tables
        n, k = t.n, t.k_max
        live = np.arange(k)[None, :] < t.deg_count[:, None]
        rows = np.repeat(np.arange(n), t.deg_count)
        adj = csr_matrix((np.ones(len(rows), np.int8),
                          (rows, t.nbr_idx[live])), shape=(n, n))
        return reverse_cuthill_mckee(adj, symmetric_mode=True).astype(
            np.int32)

    def partition_halves(self) -> np.ndarray:
        """(n,) bool — the two sides the partition scenarios cut between."""
        g = self.groups
        return g < (int(g.max()) + 1) // 2 if g.max() > 0 else \
            np.arange(self.n) < self.n // 2

    @classmethod
    def from_graph(cls, graph: Graph,
                   groups: Optional[np.ndarray] = None) -> "SparseTopology":
        """Wrap a dense ``Graph`` via the shared padded-table constructor."""
        tabs = padded_neighbor_tables(graph)
        if groups is None:
            groups = (np.arange(graph.n) * 2 >= graph.n).astype(np.int32)
        return cls(tabs, np.asarray(groups, np.int32))


def _from_pairs(n: int, src: np.ndarray, dst: np.ndarray,
                groups: np.ndarray, weight: float = 1.0) -> SparseTopology:
    """Build a SparseTopology from directed edge pairs (symmetrized,
    deduped, sorted by (a, b) — each pair encoded as one int64 a*n + b, so
    a 1-D ``np.unique`` gives the order of ``np.unique(axis=0)``)."""
    a = np.concatenate([src, dst]).astype(np.int64)
    b = np.concatenate([dst, src]).astype(np.int64)
    keep = a != b
    code = np.unique(a[keep] * n + b[keep])
    a, b = code // n, code % n
    deg = np.bincount(a, minlength=n)
    if (deg == 0).any():
        raise ValueError("generator produced an isolated agent")
    tabs = tables_from_csr(deg, b, np.full(len(b), weight, np.float64),
                           constant_row_sums(deg, weight))
    return SparseTopology(tabs, np.asarray(groups, np.int32))


def ring_topology(n: int, weight: float = 1.0) -> SparseTopology:
    """Ring over n agents — k_max = 2, the cheapest connected topology."""
    i = np.arange(n, dtype=np.int64)
    src = np.concatenate([i, i])
    dst = np.concatenate([(i + 1) % n, (i - 1) % n])
    groups = (2 * i >= n).astype(np.int32)
    return _from_pairs(n, src, dst, groups, weight)


def random_geometric_topology(n: int, k: int = 8,
                              seed: int = 0) -> SparseTopology:
    """Symmetrized kNN graph over random 2-D positions, without an n x n
    distance matrix: points are bucketed into a coarse grid and each point's
    k nearest are searched within its 3x3 cell neighborhood (O(n * k) work).

    Groups = left/right spatial half (what a geographic partition would cut).
    """
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(n, 2))
    g = max(1, int(np.sqrt(n / max(4 * k, 1))))
    cell = np.minimum((pts * g).astype(np.int64), g - 1)
    cid = cell[:, 0] * g + cell[:, 1]
    order = np.argsort(cid, kind="stable")
    sorted_cid = cid[order]
    starts = np.searchsorted(sorted_cid, np.arange(g * g))
    ends = np.searchsorted(sorted_cid, np.arange(g * g), side="right")

    src_all: List[np.ndarray] = []
    dst_all: List[np.ndarray] = []
    for cx in range(g):
        for cy in range(g):
            mine = order[starts[cx * g + cy]:ends[cx * g + cy]]
            if len(mine) == 0:
                continue
            cand = []
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    x, y = cx + dx, cy + dy
                    if 0 <= x < g and 0 <= y < g:
                        cand.append(order[starts[x * g + y]:ends[x * g + y]])
            cand = np.concatenate(cand)
            d2 = ((pts[mine][:, None, :] - pts[cand][None, :, :]) ** 2).sum(-1)
            d2[cand[None, :] == mine[:, None]] = np.inf  # scatter: unique targets
            kk = min(k, len(cand) - 1)
            if kk <= 0:
                raise ValueError("grid too coarse; lower k or raise n")
            sel = np.argpartition(d2, kk - 1, axis=1)[:, :kk]
            src_all.append(np.repeat(mine, kk))
            dst_all.append(cand[sel].ravel())
    src = np.concatenate(src_all)
    dst = np.concatenate(dst_all)
    groups = (pts[:, 0] >= 0.5).astype(np.int32)
    return _from_pairs(n, src, dst, groups)


def planted_partition_topology(n: int, n_clusters: int = 2,
                               k_intra: int = 6, k_inter: int = 2,
                               seed: int = 0) -> SparseTopology:
    """Planted-partition candidate graph: a ring inside each cluster,
    ``k_intra`` random same-cluster links and ``k_inter`` random
    other-cluster links per agent.  Groups = planted cluster id."""
    rng = np.random.default_rng(seed)
    bounds = np.linspace(0, n, n_clusters + 1).astype(np.int64)
    groups = np.zeros(n, np.int32)
    src_all: List[np.ndarray] = []
    dst_all: List[np.ndarray] = []
    for ci in range(n_clusters):
        lo, hi = bounds[ci], bounds[ci + 1]
        m = hi - lo
        groups[lo:hi] = ci
        ids = np.arange(lo, hi)
        src_all.append(ids)
        dst_all.append(lo + (ids - lo + 1) % m)          # intra ring
        if m > 2 and k_intra > 0:
            partners = lo + rng.integers(0, m, size=(m, k_intra))
            src_all.append(np.repeat(ids, k_intra))
            dst_all.append(partners.ravel())
        if n_clusters > 1 and k_inter > 0:
            others = np.concatenate([np.arange(bounds[cj], bounds[cj + 1])
                                     for cj in range(n_clusters) if cj != ci])
            partners = rng.choice(others, size=(m, k_inter))
            src_all.append(np.repeat(ids, k_inter))
            dst_all.append(partners.ravel())
    return _from_pairs(n, np.concatenate(src_all), np.concatenate(dst_all),
                       groups)


def cluster_topology(n: int, n_clusters: int = 8, k_intra: int = 6,
                     bridges: int = 4, seed: int = 0) -> SparseTopology:
    """Clustered small-world topology: a ring inside each cluster, k_intra
    random intra-cluster links per agent, and ``bridges`` random links
    between consecutive clusters.  Groups = cluster id."""
    rng = np.random.default_rng(seed)
    bounds = np.linspace(0, n, n_clusters + 1).astype(np.int64)
    groups = np.zeros(n, np.int32)
    src_all: List[np.ndarray] = []
    dst_all: List[np.ndarray] = []
    for ci in range(n_clusters):
        lo, hi = bounds[ci], bounds[ci + 1]
        m = hi - lo
        groups[lo:hi] = ci
        ids = np.arange(lo, hi)
        src_all.append(ids)
        dst_all.append(lo + (ids - lo + 1) % m)
        if m > 2 and k_intra > 0:
            partners = lo + rng.integers(0, m, size=(m, k_intra))
            src_all.append(np.repeat(ids, k_intra))
            dst_all.append(partners.ravel())
        nxt = (ci + 1) % n_clusters
        nlo, nhi = bounds[nxt], bounds[nxt + 1]
        nb = max(1, min(bridges, m, nhi - nlo))
        src_all.append(rng.integers(lo, hi, size=nb))
        dst_all.append(rng.integers(nlo, nhi, size=nb))
    src = np.concatenate(src_all)
    dst = np.concatenate(dst_all)
    return _from_pairs(n, src, dst, groups)
