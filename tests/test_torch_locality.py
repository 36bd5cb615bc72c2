"""The locality row order of ``sparse_sync_mp`` on the CPU:
``SparseTopology.locality_order`` (reverse Cuthill-McKee over the live
slots of the neighbor tables) is a deterministic permutation of the agents
on any topology, disconnected and isolated agents included, and brings
neighbors close; ``sparse_sync_mp`` hands it to every ``sparse_mix`` call
and still matches JAX's ``sparse_sync_mp`` within 1e-5; the wrapper checks
the order's dtype, shape and device, and the result does not depend on
it.  The kernel taking rows in that order runs on the card only
(tests/test_torch_cuda.py).
"""

import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.simulate import engines as jeng  # noqa: E402
from repro.simulate import topology as jtopo  # noqa: E402

from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from _port_session import port_background_jobs  # noqa: E402,F401
from repro_torch.core.graph import Graph  # noqa: E402
from repro_torch.core.sparse import padded_neighbor_tables  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import sparse_mix as tsm  # noqa: E402
from repro_torch.simulate import engines as teng  # noqa: E402
from repro_torch.simulate import topology as ttopo  # noqa: E402

CPU = torch.device("cpu")


def is_permutation(order, n):
    return order.dtype == np.int32 and order.shape == (n,) \
        and np.array_equal(np.sort(order), np.arange(n))


def positions(order):
    pos = np.empty(len(order), np.int64)
    pos[order] = np.arange(len(order))      # scatter: unique targets
    return pos


def edge_spread(topo, order=None):
    """|position(row) - position(neighbor)| over every live slot."""
    t = topo.tables
    live = np.arange(t.k_max)[None, :] < t.deg_count[:, None]
    rows = np.repeat(np.arange(t.n), t.deg_count)
    pos = np.arange(t.n) if order is None else positions(order)
    return np.abs(pos[rows] - pos[t.nbr_idx[live]])


@pytest.mark.parametrize("make", [
    lambda: ttopo.random_geometric_topology(500, k=6, seed=3),
    lambda: ttopo.ring_topology(64),
    lambda: ttopo.cluster_topology(300, n_clusters=4, seed=1)])
def test_locality_order_is_a_deterministic_permutation(make):
    topo = make()
    order = topo.locality_order
    assert is_permutation(order, topo.n)
    assert topo.locality_order is order              # built once, kept
    assert np.array_equal(make().locality_order, order)


def two_rings(m):
    """Two disjoint rings of m agents each (2 components)."""
    i = np.arange(m)
    src = np.concatenate([i, m + i])
    dst = np.concatenate([(i + 1) % m, m + (i + 1) % m])
    return ttopo._from_pairs(2 * m, src, dst, (np.arange(2 * m) >= m))


@pytest.mark.parametrize("topo,labels", [
    (two_rings(40), np.arange(80) >= 40),
    (ttopo.planted_partition_topology(200, n_clusters=3, k_inter=0, seed=2),
     None)])
def test_locality_order_on_disconnected_topology(topo, labels):
    """A permutation, with each connected component in one run."""
    labels = topo.groups if labels is None else labels
    order = topo.locality_order
    assert is_permutation(order, topo.n)
    runs = np.count_nonzero(np.diff(labels[order].astype(int))) + 1
    assert runs == len(np.unique(labels))


def test_locality_order_keeps_isolated_agents():
    W = np.zeros((6, 6))
    W[0, 1] = W[1, 0] = W[1, 2] = W[2, 1] = W[4, 5] = W[5, 4] = 1.0
    tabs = padded_neighbor_tables(Graph(W), allow_isolated=True)
    topo = ttopo.SparseTopology(tabs, np.zeros(6, np.int32))  # 3 isolated
    assert topo.tables.deg_count[3] == 0
    assert is_permutation(topo.locality_order, 6)


def test_locality_order_brings_neighbors_close():
    topo = ttopo.random_geometric_topology(20_000, k=8, seed=0)
    ident = np.percentile(edge_spread(topo), 99)
    rcm = np.percentile(edge_spread(topo, topo.locality_order), 99)
    assert rcm * 10 <= ident, (rcm, ident)


def test_sparse_sync_mp_passes_the_order_and_matches_jax(monkeypatch):
    n, p = 300, 6
    jt = jtopo.random_geometric_topology(n, k=5, seed=4)
    tt = ttopo.random_geometric_topology(n, k=5, seed=4)
    rng = np.random.default_rng(4)
    sol = rng.standard_normal((n, p)).astype(np.float32)
    c = rng.uniform(0.05, 1.0, n).astype(np.float32)
    seen = []
    real = teng.resolve

    def spy(op, backend, device):
        fn = real(op, backend, device)

        def call(*args, order=None):
            seen.append(order)
            return fn(*args, order=order)
        return call

    monkeypatch.setattr(teng, "resolve", spy)
    got = teng.sparse_sync_mp(tt, sol, c, 0.9, 9, device=CPU).numpy()
    assert len(seen) == 9
    assert all(torch.equal(o, torch.as_tensor(tt.locality_order))
               for o in seen)
    want = np.asarray(jeng.sparse_sync_mp(jt, sol, c, 0.9, sweeps=9))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_sparse_sync_mp_names_scipy_when_it_is_missing(monkeypatch):
    topo = ttopo.ring_topology(12)               # order not yet built
    monkeypatch.setitem(sys.modules, "scipy.sparse.csgraph", None)
    with pytest.raises(ImportError, match="scipy"):
        teng.sparse_sync_mp(topo, np.zeros((12, 2), np.float32),
                            np.ones(12, np.float32), 0.9, 1, device=CPU)


def mix_inputs(N=40, n=30, k=4, p=5, seed=0):
    rng = np.random.default_rng(seed)
    f = [torch.as_tensor(a, dtype=torch.float32) for a in (
        rng.standard_normal((N, p)), rng.uniform(size=(n, k)),
        rng.uniform(size=n), rng.standard_normal((n, p)))]
    idx = torch.as_tensor(rng.integers(0, N, (n, k)), dtype=torch.int32)
    return f[0], idx, f[1], f[2], f[3]


def test_sparse_gather_mix_result_does_not_depend_on_order():
    table, idx, w, b, sol = mix_inputs()
    perm = torch.randperm(30, generator=torch.Generator().manual_seed(0))
    want = tref.sparse_gather_mix(table, idx, w, b, sol)
    for order in (None, perm.int()):
        assert torch.equal(tsm.sparse_gather_mix(table, idx, w, b, sol,
                                                 order=order), want)
        assert torch.equal(tref.sparse_gather_mix(table, idx, w, b, sol,
                                                  order=order), want)


@pytest.mark.parametrize("bad,err", [
    (torch.arange(30, dtype=torch.int64), TypeError),       # dtype
    (torch.arange(31, dtype=torch.int32), ValueError),      # shape
    (torch.arange(30, dtype=torch.int32)[None], ValueError),
    (torch.arange(60, dtype=torch.int32)[::2], ValueError),  # strided
    (torch.empty(30, dtype=torch.int32, device="meta"), ValueError)])
def test_sparse_gather_mix_rejects_a_bad_order(bad, err):
    table, idx, w, b, sol = mix_inputs()
    with pytest.raises(err, match="order"):
        tsm.sparse_gather_mix(table, idx, w, b, sol, order=bad)
