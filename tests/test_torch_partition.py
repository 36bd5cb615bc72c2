"""The port's partitioned simulator (``repro_torch.simulate.partition``) on
the CPU.

* ``greedy_partition``, ``block_partition``, ``edge_cut`` and every
  ``GraphPartition`` array (with and without ``live=``) equal to JAX's for
  P in {1, 2, 4, 8}, on n = 203 and on two disjoint rings;
* the MP, CL and joint runners at P = 1 against JAX's sharded runners in
  this process (one JAX device) on JAX's events: overflow, counters,
  activity, the joint run's live mask and suppressed count exactly, and
  theta_hist / final_w within the port-vs-JAX bar of 1e-5 (the port's
  single-device engines differ from JAX's by rounding, and so do these),
  the overflow case of a small ``local_batch`` included;
* a ``LocalMesh`` at P in {2, 4, 8} against the port's single-device
  runs: MP bit for bit the per-op body and within 1e-5 of the fused one,
  CL bit for bit, joint learning bit for bit with halo re-compaction on,
  the ring exchange equal to all_gather;
* CL-ADMM with MLP agents (``InexactPrimal``, the row-sharded local
  data) at P in {1, 2, 4} bit for bit with the single-device run,
  telemetry objective included, and at P = 1 with JAX's sharded runner
  equal to JAX's single-device one;
* the sharded telemetry frames equal to the single-device ones;
* an assignment beyond the mesh raises; a too-small buffer counts its
  overflow.

JAX's runs come from a subprocess of their own that starts beside the
tests before this module (``jax_references``; tests/_port_session.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import primal as jprimal  # noqa: E402
from repro.core.losses import pad_datasets as jpad  # noqa: E402
from repro.core.losses import solitary_mean as jsolitary  # noqa: E402
from repro.core.sparse import tables_from_adjacency as jtables  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import flatten as jflat  # noqa: E402
from repro.simulate import engines as jeng  # noqa: E402
from repro.simulate import partition as jpart  # noqa: E402
from repro.simulate import scheduler as jsched  # noqa: E402
from repro.simulate import topology as jtopo  # noqa: E402

import _dist_worker as dw  # noqa: E402
import _port_session  # noqa: E402
from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from _port_session import port_background_jobs  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch.core.sparse import tables_from_adjacency  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.launch import LocalMesh  # noqa: E402
from repro_torch.simulate import (SparseTopology, run_cl_scenario,  # noqa: E402
                                  run_joint_scenario, run_mp_scenario)
from repro_torch.simulate import partition as tpart  # noqa: E402
from repro_torch.telemetry import TelemetryConfig  # noqa: E402

CPU = "cpu"
SHORT = dict(rounds=20, batch=32, seed=3, record_every=10)
LEARN = dict(eta_graph=0.3, lam=1.0, graph_every=5, prune_eps=0.05)


def two_rings(tables, half=20):
    """Two disjoint rings (tests/test_partition.py): a partition of them
    can have no cross edge."""
    nbrs, wts = [], []
    for comp in range(2):
        lo = comp * half
        for v in range(half):
            a, b = lo + (v - 1) % half, lo + (v + 1) % half
            nbrs.append(np.sort(np.unique([a, b])))
            wts.append(np.ones(len(nbrs[-1])))
    return tables(nbrs, wts), (np.arange(2 * half) >= half).astype(np.int32)


@pytest.fixture(scope="module")
def topologies():
    jt, groups = two_rings(jtables)
    tt, _ = two_rings(tables_from_adjacency)
    return {"rgg203": (jtopo.random_geometric_topology(203, k=5, seed=0),
                       dw.problem()[0]),
            "two-rings": (jtopo.SparseTopology(jt, groups),
                          SparseTopology(tt, groups))}


# ---------------------------------------------------------------------------
# host layout against JAX
# ---------------------------------------------------------------------------


def assert_partitions_equal(a, b):
    for f in ("n", "n_shards", "shard_size", "edge_cut", "halo_size",
              "boundary_size"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("owner", "local_pos", "perm_slot", "local_ids", "bnd_pos",
              "halo_src_shard", "halo_src_pos", "fetch"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("P", [1, 2, 4, 8])
@pytest.mark.parametrize("name", ["rgg203", "two-rings"])
def test_partition_layout_matches_jax(topologies, name, P):
    jt, tt = topologies[name]
    got, want = tpart.greedy_partition(tt, P, seed=1), \
        jpart.greedy_partition(jt, P, seed=1)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(tpart.block_partition(tt, P),
                          jpart.block_partition(jt, P))
    assert tpart.edge_cut(tt, got) == jpart.edge_cut(jt, want)
    live = np.random.default_rng(P).uniform(size=(tt.n, tt.k_max)) < 0.6
    for lv in (None, live):
        assert_partitions_equal(
            tpart.GraphPartition.build(tt, got, P, live=lv),
            jpart.GraphPartition.build(jt, want, P, live=lv))
    part = tpart.GraphPartition.build(tt, got, P)
    x = np.random.default_rng(0).standard_normal((tt.n, 3)).astype(
        np.float32)
    assert np.array_equal(part.unshard_rows(part.shard_rows(x)), x)
    if name == "two-rings" and P == 2:
        groups = jt.groups
        rings = tpart.GraphPartition.build(tt, groups, 2)
        assert_partitions_equal(rings,
                                jpart.GraphPartition.build(jt, groups, 2))
        assert rings.edge_cut == rings.halo_size == 0


def test_capacity_heuristics_match_jax():
    for batch in (32, 100, 100_000):
        for P in (1, 2, 4, 8):
            assert tpart.default_local_batch(batch, P) == \
                jpart.default_local_batch(batch, P)
            assert tpart.default_local_events(batch, P) == \
                jpart.default_local_events(batch, P)


# ---------------------------------------------------------------------------
# P = 1 against JAX's sharded runners
# ---------------------------------------------------------------------------


SHARDED_FIELDS = ("overflow", "n_shards", "edge_cut", "halo_size",
                  "local_batch", "delivered", "dropped", "invalid", "rounds",
                  "events", "active_hist", "theta_hist")


def sharded_fields(tr):
    """A JAX sharded trace's layout, counters and histories, as numpy."""
    return {k: np.asarray(getattr(tr, k)) for k in SHARDED_FIELDS}


def jax_data():
    """JAX's problem arrays: topology, models, confidences, CL data and
    its solitary warm start."""
    jt = jtopo.random_geometric_topology(dw.N, k=5, seed=0)
    rng = np.random.default_rng(0)
    sol = rng.standard_normal((dw.N, dw.P_DIM)).astype(np.float32)
    c = rng.uniform(0.05, 1.0, dw.N).astype(np.float32)
    xs = [rng.standard_normal((int(rng.integers(1, 8)), dw.P_DIM))
          for _ in range(dw.N)]
    data = jpad(xs, [np.zeros(len(x)) for x in xs])
    sol_cl = np.asarray(jsolitary(data), np.float32)
    return jt, sol, c, data, sol_cl


def jax_sharded():
    """JAX's stream and sharded runs at one device."""
    jt, sol, c, data, sol_cl = jax_data()
    cond = jsched.NetworkConditions(**dw.COND)
    js = jsched.precompute_event_stream(
        jt.device_tables(), jnp.asarray(jt.partition_halves()), cond,
        SHORT["batch"], SHORT["seed"], SHORT["rounds"])
    runs = {
        "mp": jpart.run_mp_scenario_sharded(jt, sol, c, 0.9, cond, **SHORT),
        "mp-overflow": jpart.run_mp_scenario_sharded(
            jt, sol, c, 0.9, cond, local_batch=5, **SHORT),
        "cl": jpart.run_cl_scenario_sharded(jt, data, 0.1, 1.0, cond,
                                            theta_sol=sol_cl, **SHORT),
        "joint": jpart.run_joint_scenario_sharded(jt, sol, c, 0.9, cond,
                                                  **SHORT, **LEARN),
    }
    out = {k: sharded_fields(v) for k, v in runs.items()}
    out["joint"].update({k: np.asarray(getattr(runs["joint"], k)) for k in (
        "final_live", "suppressed", "live_edges_hist", "final_w")})
    return {"runs": out, "stream": jax.tree_util.tree_map(np.asarray, js)}


@pytest.fixture(scope="module")
def jax_side(refs):
    """JAX's sharded runs at one device (from the reference job), and the
    port's problem with JAX's stream carried across."""
    _, _, _, data, sol_cl = jax_data()
    want = refs["sharded"]
    return (want["runs"], convert.stream_from_arrays(want["stream"], CPU),
            convert.data_from_arrays(data, CPU), sol_cl)


def assert_matches_jax(got, want, tol=1e-5):
    assert (got.overflow, got.n_shards, got.edge_cut, got.halo_size,
            got.local_batch) == tuple(int(want[k]) for k in (
                "overflow", "n_shards", "edge_cut", "halo_size",
                "local_batch"))
    assert (got.delivered, got.dropped, got.invalid, got.rounds,
            got.events) == tuple(int(want[k]) for k in (
                "delivered", "dropped", "invalid", "rounds", "events"))
    np.testing.assert_array_equal(got.active_hist.numpy(),
                                  want["active_hist"])
    np.testing.assert_allclose(got.theta_hist.numpy(), want["theta_hist"],
                               atol=tol, rtol=0)


@pytest.mark.parametrize("algo", ["mp", "mp-overflow", "cl", "joint"])
def test_single_shard_matches_jax_sharded_runner(jax_side, algo):
    runs, stream, data, sol_cl = jax_side
    topo, sol, c, _, _, cond, *_ = dw.problem()
    kw = dict(mesh=LocalMesh(1, CPU), stream=stream, **SHORT)
    if algo == "cl":
        got = tpart.run_cl_scenario_sharded(topo, data, 0.1, 1.0, cond,
                                            theta_sol=sol_cl, **kw)
    elif algo == "joint":
        got = tpart.run_joint_scenario_sharded(topo, sol, c, 0.9, cond,
                                               **kw, **LEARN)
    else:
        got = tpart.run_mp_scenario_sharded(
            topo, sol, c, 0.9, cond, **kw,
            local_batch=5 if algo == "mp-overflow" else None)
    want = runs[algo]
    assert_matches_jax(got, want)
    if algo == "mp-overflow":
        assert got.overflow > 0
    if algo == "joint":
        assert np.array_equal(got.final_live.numpy(), want["final_live"])
        assert got.suppressed == int(want["suppressed"])
        np.testing.assert_array_equal(got.live_edges_hist.numpy(),
                                      want["live_edges_hist"])
        np.testing.assert_allclose(got.final_w.numpy(), want["final_w"],
                                   atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# LocalMesh against the port's single-device engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def single():
    topo, sol, c, data, sol_cl, cond, *_ = dw.problem()
    kw = dict(device=CPU, **dw.RUN)
    return {
        "mp": run_mp_scenario(topo, sol, c, 0.9, cond, **kw),
        "mp-fused": run_mp_scenario(topo, sol, c, 0.9, cond,
                                    backend=dispatch.ReproBackend(), **kw),
        "cl": run_cl_scenario(topo, data, 0.1, 1.0, cond, theta_sol=sol_cl,
                              **kw),
        "joint": run_joint_scenario(topo, sol, c, 0.9, cond, **kw,
                                    **LEARN),
    }


@pytest.mark.parametrize("P", [2, 4, 8])
@pytest.mark.parametrize("algo", ["mp", "cl", "joint"])
def test_local_mesh_equals_single_device(single, algo, P):
    topo, sol, c, data, sol_cl, cond, *_ = dw.problem()
    one = single[algo]
    mesh = LocalMesh(P, CPU)
    hists = []
    for exchange in ("all_gather", "ring"):
        kw = dict(mesh=mesh, exchange=exchange, **dw.RUN)
        if algo == "mp":
            sh = tpart.run_mp_scenario_sharded(topo, sol, c, 0.9, cond, **kw)
        elif algo == "cl":
            sh = tpart.run_cl_scenario_sharded(topo, data, 0.1, 1.0, cond,
                                               theta_sol=sol_cl, **kw)
        else:
            sh = tpart.run_joint_scenario_sharded(
                topo, sol, c, 0.9, cond, recompact_every=10,
                recompact_frac=0.05, **kw, **LEARN)
            assert sh.recompactions >= 1
            assert sh.edge_cut == tpart.edge_cut(
                topo, tpart.greedy_partition(topo, P))
            assert torch.equal(sh.final_w, one.final_w)
            assert torch.equal(sh.final_live, one.final_live)
            assert torch.equal(sh.live_edges_hist, one.live_edges_hist)
            assert sh.suppressed == one.suppressed
        assert sh.overflow == 0 and sh.n_shards == P
        assert (sh.delivered, sh.dropped, sh.invalid, sh.events) == \
            (one.delivered, one.dropped, one.invalid, one.events)
        assert torch.equal(sh.active_hist, one.active_hist)
        assert torch.equal(sh.theta_hist, one.theta_hist)
        hists.append(sh.theta_hist)
    assert torch.equal(hists[0], hists[1])
    if algo == "mp":
        fused = single["mp-fused"].theta_hist
        assert (hists[0] - fused).abs().max().item() <= 1e-5


def jax_mlp():
    """The JAX side of the MLP-agent problem: the solitary warm start,
    the event stream, JAX's sharded run at one device, and its
    single-device ``run_cl_scenario`` from that warm start and from the
    warm start nudged up by one float32 ulp."""
    jm = jflat.MLPAgent(in_dim=2, hidden=(4,))
    jt, jtrain, _, _ = jsyn.federated_moons_problem(**dw.MOONS)
    sol = np.asarray(jprimal.solitary_adamw(jtrain, loss="logistic",
                                            model=jm, steps=50, seed=0))
    jcond = jsched.NetworkConditions(**dw.COND)
    js = jsched.precompute_event_stream(
        jt.device_tables(), jnp.asarray(jt.partition_halves()), jcond,
        dw.MLP_RUN["batch"], dw.MLP_RUN["seed"], dw.MLP_RUN["rounds"])
    jp = jprimal.InexactPrimal(loss="logistic", model=jm, b_steps=4,
                               lr=0.05)
    r = dw.MLP_RUN

    def run(theta_sol):
        return np.asarray(jeng.run_cl_scenario(
            jt, jtrain, dw.MLP_MU, dw.MLP_RHO, jcond, r["rounds"],
            r["batch"], seed=r["seed"], record_every=r["record_every"],
            theta_sol=theta_sol, stream=js, primal=jp).theta_hist)
    want = jpart.run_cl_scenario_sharded(
        jt, jtrain, dw.MLP_MU, dw.MLP_RHO, jcond, **dw.MLP_RUN,
        theta_sol=sol, stream=js, primal=jp)
    nudged = np.nextafter(sol, np.float32(np.inf))
    assert nudged.dtype == np.float32 and np.all(nudged > sol)
    return {"sol": sol, "stream": jax.tree_util.tree_map(np.asarray, js),
            "sharded": sharded_fields(want), "one": run(sol),
            "nudged": run(nudged)}


def jax_references():
    """The JAX side of the tests against JAX's runners (run in a
    subprocess of its own beside the tests before this module:
    tests/_port_session.py)."""
    return {"sharded": jax_sharded(), "mlp": jax_mlp()}


refs = _port_session.reference_fixture(__name__)


@pytest.fixture(scope="module")
def mlp_jax(refs):
    """The JAX side of the MLP-agent problem (:func:`jax_mlp`)."""
    return refs["mlp"]


@pytest.fixture(scope="module")
def mlp_side(mlp_jax):
    """CL-ADMM with MLP agents (the data-hungry ``InexactPrimal`` path):
    JAX's sharded run at this process's one device, and the port's
    single-device run with telemetry on, both on JAX's stream and warm
    start."""
    j = mlp_jax
    _, jtrain, _, _ = jsyn.federated_moons_problem(**dw.MOONS)
    topo, _, _, primal = dw.mlp_problem()
    kw = dict(theta_sol=convert.agent_rows_from_arrays(j["sol"], CPU),
              primal=primal, stream=convert.stream_from_arrays(j["stream"],
                                                               CPU),
              telemetry=TelemetryConfig(enabled=True), **dw.MLP_RUN)
    data = convert.data_from_arrays(jtrain, CPU)
    one = run_cl_scenario(topo, data, dw.MLP_MU, dw.MLP_RHO,
                          dw.problem()[5], device=CPU, **kw)
    return (j["sharded"], j["one"]), topo, data, kw, one


@pytest.mark.parametrize("P", [1, 2, 4])
def test_inexact_primal_sharded_equals_single_device(mlp_side, P):
    """The row-sharded ``xym`` blocks, ``primal.solve_batch`` on them and
    ``batch_local_loss`` in the telemetry objective: bit for bit the
    single-device run at every P.  At P = 1 the counters equal JAX's
    sharded runner's, and its theta_hist equals JAX's single-device one bit
    for bit, so the sharded port differs from the sharded JAX exactly as
    the single-device port differs from the single-device JAX (held in
    tests/test_torch_primal.py)."""
    (want, jone), topo, data, kw, one = mlp_side
    cond = dw.problem()[5]
    for exchange in ("all_gather", "ring"):
        sh = tpart.run_cl_scenario_sharded(
            topo, data, dw.MLP_MU, dw.MLP_RHO, cond, mesh=LocalMesh(P, CPU),
            exchange=exchange, **kw)
        assert sh.overflow == 0 and sh.n_shards == P
        assert (sh.delivered, sh.dropped, sh.invalid, sh.events) == \
            (one.delivered, one.dropped, one.invalid, one.events)
        assert torch.equal(sh.theta_hist, one.theta_hist)
        np.testing.assert_array_equal(sh.telemetry.objective,
                                      one.telemetry.objective)
    assert not torch.equal(one.theta_hist[-1], kw["theta_sol"])
    if P == 1:
        assert (sh.overflow, sh.delivered, sh.dropped, sh.invalid,
                sh.events) == tuple(int(want[k]) for k in (
                    "overflow", "delivered", "dropped", "invalid", "events"))
        np.testing.assert_array_equal(sh.active_hist.numpy(),
                                      want["active_hist"])
        np.testing.assert_array_equal(want["theta_hist"], jone)


def test_mlp_drift_is_within_jax_rounding_sensitivity(mlp_jax, mlp_side):
    """The port's single-device CL-ADMM with MLP agents under faults
    leaves JAX's 1e-4 bar by the last record, and JAX leaves it too when
    its own warm start moves by one float32 ulp: the trajectory amplifies
    any rounding.  At every record the port's gap to JAX stays within
    JAX's gap to itself from that one-ulp nudge (or 1e-5), and that
    self-gap passes 1e-4 at the last record, so the bound is not
    vacuous."""
    (_, jone), _, _, _, one = mlp_side
    jup = mlp_jax["nudged"]
    port = one.theta_hist.numpy()
    assert port.shape == jone.shape == jup.shape
    axes = tuple(range(1, port.ndim))
    gap = np.abs(port - jone).max(axis=axes)
    self_gap = np.abs(jup - jone).max(axis=axes)
    bound = np.maximum(1e-5, self_gap)
    assert np.all(gap <= bound), (gap, self_gap)
    assert self_gap[-1] > 1e-4, self_gap


@pytest.mark.parametrize("algo", ["mp", "cl", "joint"])
def test_sharded_telemetry_equals_single_device(algo):
    topo, sol, c, data, sol_cl, cond, *_ = dw.problem()
    tel = TelemetryConfig(enabled=True)
    kw = dict(device=CPU, telemetry=tel, **dw.RUN)
    if algo == "mp":
        one = run_mp_scenario(topo, sol, c, 0.9, cond, **kw)
        sh = tpart.run_mp_scenario_sharded(topo, sol, c, 0.9, cond,
                                           mesh=LocalMesh(4, CPU), **kw)
    elif algo == "cl":
        one = run_cl_scenario(topo, data, 0.1, 1.0, cond, theta_sol=sol_cl,
                              **kw)
        sh = tpart.run_cl_scenario_sharded(topo, data, 0.1, 1.0, cond,
                                           theta_sol=sol_cl,
                                           mesh=LocalMesh(4, CPU), **kw)
    else:
        one = run_joint_scenario(topo, sol, c, 0.9, cond, **kw, **LEARN)
        sh = tpart.run_joint_scenario_sharded(
            topo, sol, c, 0.9, cond, mesh=LocalMesh(4, CPU),
            recompact_every=10, recompact_frac=0.05, **kw, **LEARN)
    a, b = sh.telemetry, one.telemetry
    for f in ("rounds", "objective", "staleness", "updates", "delivered",
              "drop_link", "drop_churn", "drop_partition", "invalid",
              "suppressed"):
        x, y = getattr(a, f), getattr(b, f)
        if y is None:
            assert x is None, f
        else:
            np.testing.assert_array_equal(x, y, err_msg=f)
    assert np.array_equal(a.overflow_per_shard, np.zeros(4))
    assert a.halo_bytes.shape == (a.n_records,)
    assert (np.diff(a.halo_bytes) >= 0).all() and a.halo_bytes[-1] > 0
    assert b.halo_bytes is None


def test_assignment_beyond_the_mesh_raises_and_overflow_counts():
    topo, sol, c, _, _, cond, *_ = dw.problem()
    bad = np.arange(topo.n, dtype=np.int32) % 5
    with pytest.raises(ValueError, match="mesh"):
        tpart.run_mp_scenario_sharded(topo, sol, c, 0.9, cond,
                                      mesh=LocalMesh(4, CPU), assignment=bad,
                                      **SHORT)
    tr = tpart.run_mp_scenario_sharded(topo, sol, c, 0.9, cond,
                                       mesh=LocalMesh(4, CPU), local_batch=1,
                                       **SHORT)
    assert tr.overflow > 0 and torch.isfinite(tr.theta_hist).all()
