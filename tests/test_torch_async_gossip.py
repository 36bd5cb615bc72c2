"""The paper's asynchronous gossip (§3.2) in the port against the JAX
package: the dense ``core.model_propagation.async_gossip`` and the exact
sparse ``simulate.engines.sparse_async_gossip``.

torch cannot replay ``jax.random``, so the port's engines take the JAX
run's own wake-ups, replayed here with its key schedule: ``split(key,
steps)`` when every tick is recorded, one ``split`` per record chunk
otherwise.  ``theta_hist`` and the final knowledge agree with JAX within
1e-5 (float32 rounding of the same Eq. 6 arithmetic; measured below
1e-6).  Within the port the sparse engine equals the dense one bit for
bit, as the reference claims for itself (DESIGN.md §4).  The JAX runs
and their wake-ups come from a subprocess of their own that starts beside
the tests before this module (``jax_references``; tests/_port_session.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import graph as jgraph  # noqa: E402
from repro.core import model_propagation as jmp  # noqa: E402
from repro.core import sparse as jsparse  # noqa: E402
from repro.simulate import engines as jeng  # noqa: E402
from repro.simulate import topology as jtopo  # noqa: E402

import _port_session  # noqa: E402
from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from _port_session import port_background_jobs  # noqa: E402,F401
from _port_session import as_numpy  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core.model_propagation import async_gossip  # noqa: E402
from repro_torch.core.sparse import tables_from_adjacency  # noqa: E402
from repro_torch.simulate import sparse_async_gossip  # noqa: E402
from repro_torch.simulate.topology import SparseTopology  # noqa: E402

CPU = "cpu"
ATOL = 1e-5


def close(got, want):
    np.testing.assert_allclose(torch.as_tensor(got).numpy(),
                               np.asarray(want), atol=ATOL, rtol=0)


def jax_draws(tabs, n, seed, steps, record_every):
    """The (i, s) wake-ups of the JAX exact engines for ``seed``: their
    key schedule, replayed."""
    key = jax.random.PRNGKey(seed)
    if record_every == 1:
        keys = jax.random.split(key, steps)
    else:
        outer = jax.random.split(key, steps // record_every)
        keys = jax.vmap(lambda k: jax.random.split(k, record_every))(
            outer).reshape(-1, 2)
    i, s = jax.vmap(lambda k: jsparse.sample_event(
        k, n, tabs.slot_cdf, tabs.deg_count))(keys)
    return np.asarray(i), np.asarray(s)


def problem(make, p=3, seed=0):
    """Both packages' graph from ``make`` and numpy models/confidences."""
    jg, tg = make(jgraph), make(tgraph)
    rng = np.random.default_rng(seed)
    sol = rng.standard_normal((jg.n, p)).astype(np.float32)
    c = rng.uniform(0.05, 1.0, jg.n).astype(np.float32)
    return jg, tg, sol, c


CASES = {
    # (graph, steps, record_every): chunked records, and every tick
    "geometric-chunked": (lambda m: m.random_geometric_graph(16, k=3,
                                                             seed=1),
                          400, 50),
    "ring-every-tick": (lambda m: m.ring_graph(8), 64, 1),
}


def jax_dense(case):
    """JAX's dense ``async_gossip`` on the case and its wake-ups."""
    make, steps, rec = CASES[case]
    jg, _, sol, c = problem(make)
    want = jmp.async_gossip(jg, sol, c, 0.9, steps=steps, seed=3,
                            record_every=rec)
    tabs = jsparse.to_device(jsparse.padded_neighbor_tables(jg))
    return as_numpy({"theta_hist": want.theta_hist,
                     "final_knowledge": want.final_knowledge,
                     "comms_hist": want.comms_hist,
                     "draws": jax_draws(tabs, jg.n, 3, steps, rec)})


def jax_sparse(case):
    """JAX's ``sparse_async_gossip`` on the case and its wake-ups."""
    make, steps, rec = CASES[case]
    jg, _, sol, c = problem(make)
    jt = jtopo.SparseTopology.from_graph(jg)
    want = jeng.sparse_async_gossip(jt, sol, c, 0.9, steps=steps, seed=3,
                                    record_every=rec)
    return as_numpy({"theta_hist": want.theta_hist,
                     "final_theta": want.final_theta,
                     "final_knowledge": want.final_knowledge,
                     "comms_hist": want.comms_hist,
                     "draws": jax_draws(jt.device_tables(), jg.n, 3, steps,
                                        rec)})


def jax_isolated():
    """JAX's ``sparse_async_gossip`` with a degree-0 agent, and its
    wake-ups."""
    from repro.core.sparse import tables_from_adjacency as jtables
    jtabs, groups = isolated(jtables)
    jt = jtopo.SparseTopology(jtabs, groups)
    sol, c = isolated_models()
    want = jeng.sparse_async_gossip(jt, sol, c, 0.9, steps=200, seed=0,
                                    record_every=50)
    return as_numpy({"theta_hist": want.theta_hist,
                     "draws": jax_draws(jt.device_tables(), 12, 0, 200,
                                        50)})


def jax_references():
    """The JAX side of the tests against JAX (run in a subprocess of its
    own beside the tests before this module: tests/_port_session.py)."""
    return {"dense": {case: jax_dense(case) for case in CASES},
            "sparse": {case: jax_sparse(case) for case in CASES},
            "isolated": jax_isolated()}


refs = _port_session.reference_fixture(__name__)


@pytest.mark.parametrize("case", sorted(CASES))
def test_async_gossip_matches_jax(refs, case):
    make, steps, rec = CASES[case]
    _, tg, sol, c = problem(make)
    want = refs["dense"][case]
    got = async_gossip(tg, sol, c, 0.9, steps, record_every=rec,
                       draws=want["draws"], device=CPU)
    assert got.theta_hist.shape == want["theta_hist"].shape
    close(got.theta_hist, want["theta_hist"])
    close(got.final_knowledge, want["final_knowledge"])
    np.testing.assert_array_equal(got.comms_hist, want["comms_hist"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_sparse_async_gossip_matches_jax(refs, case):
    make, steps, rec = CASES[case]
    _, tg, sol, c = problem(make)
    want = refs["sparse"][case]
    got = sparse_async_gossip(SparseTopology.from_graph(tg), sol, c, 0.9,
                              steps, record_every=rec, draws=want["draws"],
                              device=CPU)
    close(got.theta_hist, want["theta_hist"])
    close(got.final_theta, want["final_theta"])
    close(got.final_knowledge, want["final_knowledge"])
    np.testing.assert_array_equal(got.comms_hist, want["comms_hist"])


@pytest.mark.parametrize("seed", [0, 5])
def test_sparse_equals_dense_bit_for_bit(seed):
    """The port's sparse engine reproduces its dense one exactly: theta
    rows equal, and each live slot equal to the dense knowledge cell."""
    g = tgraph.random_geometric_graph(20, k=4, seed=2)
    rng = np.random.default_rng(seed)
    sol = rng.standard_normal((20, 5)).astype(np.float32)
    c = rng.uniform(0.05, 1.0, 20).astype(np.float32)
    dense = async_gossip(g, sol, c, 0.8, 300, seed=seed, record_every=30,
                         device=CPU)
    topo = SparseTopology.from_graph(g)
    sparse = sparse_async_gossip(topo, sol, c, 0.8, 300, seed=seed,
                                 record_every=30, device=CPU)
    assert torch.equal(dense.theta_hist, sparse.theta_hist)
    assert torch.equal(dense.final_knowledge.diagonal(dim1=0, dim2=1).T,
                       sparse.final_theta)
    tabs = topo.tables
    live = np.arange(topo.k_max)[None, :] < tabs.deg_count[:, None]
    rows, slots = np.nonzero(live)
    want = dense.final_knowledge[rows, tabs.nbr_idx[rows, slots]]
    assert torch.equal(sparse.final_knowledge[rows, slots], want)
    # the torch-drawn wake-ups replay from their seed, and the run moved
    again = sparse_async_gossip(topo, sol, c, 0.8, 300, seed=seed,
                                record_every=30, device=CPU)
    assert torch.equal(again.theta_hist, sparse.theta_hist)
    assert not np.array_equal(sparse.theta_hist[-1].numpy(), sol)


def isolated(build_tables, n=12, iso=5):
    """A ring over every agent but ``iso``, which has degree 0."""
    others = [a for a in range(n) if a != iso]
    nbrs = [[] for _ in range(n)]
    for a, b in zip(others, others[1:] + others[:1]):
        nbrs[a].append(b)
        nbrs[b].append(a)
    nbrs = [np.array(sorted(x), np.int64) for x in nbrs]
    wts = [np.ones(len(x)) for x in nbrs]
    tabs = build_tables(nbrs, wts, allow_isolated=True)
    groups = (np.arange(n) * 2 >= n).astype(np.int32)
    return tabs, groups


def isolated_models():
    rng = np.random.default_rng(4)
    return rng.standard_normal((12, 2)).astype(np.float32), \
        np.ones(12, np.float32)


def test_degree_zero_agent_is_a_no_op(refs):
    """A degree-0 waker changes nothing: the isolated agent keeps its
    solitary model, and the run matches JAX's on the same wake-ups (which
    do reach the isolated agent)."""
    ttabs, groups = isolated(tables_from_adjacency)
    tt = SparseTopology(ttabs, groups)
    sol, c = isolated_models()
    want = refs["isolated"]
    draws = want["draws"]
    assert (draws[0] == 5).any()
    got = sparse_async_gossip(tt, sol, c, 0.9, 200, record_every=50,
                              draws=draws, device=CPU)
    close(got.theta_hist, want["theta_hist"])
    assert torch.equal(got.final_theta[5], torch.as_tensor(sol[5]))
    # the dense engine builds its tables as JAX's does: no isolated agent
    g = tgraph.Graph(np.asarray(
        [[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 0.0]]))
    with pytest.raises(ValueError, match="neighbor"):
        async_gossip(g, np.zeros((3, 1)), np.ones(3), 0.9, 4, device=CPU)
