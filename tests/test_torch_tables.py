"""The PyTorch port's graphs, padded-neighbor tables, topologies and
synthetic problems are exactly the JAX package's: same arrays, same
dtypes, from the same seeds."""

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import graph as jgraph  # noqa: E402
from repro.core import sparse as jsparse  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.simulate import topology as jtopo  # noqa: E402

from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from _port_session import port_background_jobs  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import sparse as tsparse  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.simulate import topology as ttopo  # noqa: E402


def assert_same(a, b, what=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def assert_same_tables(jt, tt):
    for f in jsparse.NeighborTables._fields:
        assert_same(getattr(jt, f), getattr(tt, f), f)


GRAPHS = {
    "gaussian": lambda m: m.gaussian_kernel_graph(
        np.random.default_rng(3).uniform(size=(40, 2)), sigma=0.3),
    "gaussian_threshold": lambda m: m.gaussian_kernel_graph(
        np.random.default_rng(4).uniform(size=(30, 2)), sigma=0.2,
        threshold=0.05),
    "random_geometric": lambda m: m.random_geometric_graph(50, k=4, seed=2),
    "ring": lambda m: m.ring_graph(12, weight=0.3),
    "knn": lambda m: m.knn_graph_from_similarity(
        np.random.default_rng(5).standard_normal((25, 25)), 3),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graphs_and_padded_tables(name):
    jg, tg = GRAPHS[name](jgraph), GRAPHS[name](tgraph)
    assert_same(jg.W, tg.W, "W")
    assert_same(jg.P, tg.P, "P")
    assert_same_tables(jsparse.padded_neighbor_tables(jg),
                       tsparse.padded_neighbor_tables(tg))


def test_two_moons_exact():
    for a, b in zip(jgraph.two_moons(37, seed=9), tgraph.two_moons(37, seed=9)):
        assert_same(a, b)


def test_isolated_agents_and_ragged_weights():
    """Degree-0 rows (allow_isolated) and non-uniform float weights, whose
    degree sums exercise numpy's summation order."""
    rng = np.random.default_rng(7)
    n = 20
    nbrs, wts = [], []
    for i in range(n):
        if i in (3, 11):
            nbrs.append(np.array([], np.int64))
            wts.append(np.ones(0))
            continue
        nb = np.sort(rng.choice([v for v in range(n) if v not in (i, 3, 11)],
                                size=rng.integers(1, 12), replace=False))
        nbrs.append(nb)
        wts.append(rng.uniform(0.01, 1.0, len(nb)))
    assert_same_tables(
        jsparse.tables_from_adjacency(nbrs, wts, allow_isolated=True),
        tsparse.tables_from_adjacency(nbrs, wts, allow_isolated=True))
    with pytest.raises(ValueError):
        tsparse.tables_from_adjacency(nbrs, wts)


TOPOLOGIES = {
    "ring": lambda m: m.ring_topology(50),
    "ring_weighted": lambda m: m.ring_topology(33, weight=0.1),
    "random_geometric": lambda m: m.random_geometric_topology(600, k=6,
                                                              seed=1),
    "planted_partition": lambda m: m.planted_partition_topology(
        120, n_clusters=3, k_intra=5, k_inter=2, seed=4),
    "cluster": lambda m: m.cluster_topology(160, n_clusters=4, k_intra=5,
                                            bridges=3, seed=2),
}


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_topology_generators(name):
    jt, tt = TOPOLOGIES[name](jtopo), TOPOLOGIES[name](ttopo)
    assert_same_tables(jt.tables, tt.tables)
    assert_same(jt.groups, tt.groups, "groups")
    assert_same(jt.partition_halves(), tt.partition_halves(), "halves")
    assert jt.n_edges == tt.n_edges


def test_topology_from_graph():
    g = jgraph.random_geometric_graph(30, k=3, seed=6)
    tg = tgraph.random_geometric_graph(30, k=3, seed=6)
    jt = jtopo.SparseTopology.from_graph(g)
    tt = ttopo.SparseTopology.from_graph(tg)
    assert_same_tables(jt.tables, tt.tables)
    assert_same(jt.groups, tt.groups)


def test_device_tables_mirror_host():
    """The port's device tables equal the JAX package's, whether built by
    the port or carried across by ``convert.tables_from_arrays``."""
    tt = ttopo.random_geometric_topology(200, k=5, seed=3)
    jd = jtopo.random_geometric_topology(200, k=5, seed=3).device_tables()
    for dt in (tt.device_tables("cpu"),
               convert.tables_from_arrays(jd, "cpu")):
        for f in tsparse.DeviceTables._fields:
            assert_same(np.asarray(getattr(jd, f)), getattr(dt, f).numpy(),
                        f)
    live = tsparse.live_slots(tt.device_tables("cpu").deg_count, tt.k_max)
    assert_same(np.asarray(jsparse.live_slots(jd.deg_count, tt.k_max)),
                live.numpy(), "live")


def test_as_torch_matches_as_jnp():
    jg = jgraph.random_geometric_graph(20, k=3, seed=1)
    tg = tgraph.random_geometric_graph(20, k=3, seed=1)
    for a, b in zip(jgraph.as_jnp(jg), tgraph.as_torch(tg, "cpu")):
        assert_same(np.asarray(a), b.numpy())


def test_mean_estimation_problem_exact():
    jg, jd, jtgt, jc = jsyn.mean_estimation_problem(n=60, seed=5)
    tg, td, ttgt, tc = tsyn.mean_estimation_problem(n=60, seed=5,
                                                    device="cpu")
    assert_same(jg.W, tg.W, "W")
    for f in ("x", "y", "mask"):
        assert_same(np.asarray(getattr(jd, f)), getattr(td, f).numpy(), f)
    assert_same(jtgt, ttgt, "targets")
    assert_same(jc, tc, "c")


def test_two_cluster_mean_problem_exact():
    for a, b in zip(jsyn.two_cluster_mean_problem(40, p=5, seed=8),
                    tsyn.two_cluster_mean_problem(40, p=5, seed=8)):
        assert_same(a, b)
