"""Joint model and collaboration-graph learning (DESIGN.md §13) in the
port against the JAX package.

* ``simplex_project_rows`` and ``edge_reweight`` against JAX's ``ref``
  within 1e-6 (float32 sort, cumsum and threshold; a few ulps of values
  of order 1), and the invariants ``tests/test_joint.py`` holds: simplex
  rows, eta = 0 is the identity, eta = 1 the projection, the lam limits,
  monotone pruning.
* ``run_joint_scenario`` replaying the JAX run's stream under faults:
  counters exactly, ``final_w`` and ``theta_hist`` within 1e-5 (the
  simulator's bar; float32 rounding over 120 rounds), the prune's
  outcome (``final_live``, ``suppressed``, ``live_edges_hist``) exactly
  except at a slot whose weight came within 1e-5 of ``prune_eps``, where
  float32 rounding may decide it differently (such slots are reported).
* ``eta_graph = 0`` is the port's ``run_mp_scenario`` bit for bit; the
  planted two-cluster recovery reaches 90 % of the intra-cluster edges;
  ``learned_weight_tables`` equals JAX's.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import graph_learning as jgl  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.simulate import engines as jeng  # noqa: E402
from repro.simulate import scheduler as jsched  # noqa: E402
from repro.simulate import topology as jtopo  # noqa: E402

import _port_session  # noqa: E402
from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from _port_session import port_background_jobs  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch.core import graph_learning as tgl  # noqa: E402
from repro_torch.data.synthetic import two_cluster_mean_problem  # noqa: E402
from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.simulate import (NetworkConditions,  # noqa: E402
                                  ScenarioSpec, run_scenario)
from repro_torch.simulate import engines as teng  # noqa: E402
from repro_torch.simulate import topology as ttopo  # noqa: E402

CPU = "cpu"

#: the tuned operating point of the two-cluster runs (tests/test_joint.py)
LEARN_KW = dict(eta_graph=0.3, lam=1.0, graph_every=5, prune_eps=1e-3)
FAULTY = NetworkConditions(drop_prob=0.1, stale_prob=0.3, churn_rate=0.01,
                           straggler_frac=0.3, partition_start=10,
                           partition_end=30)


def rows(seed=0, B=30, k=6):
    """Random weight rows on the simplex over a random live mask (row 0
    has no live slot), and distances."""
    rng = np.random.default_rng(seed)
    live = rng.uniform(size=(B, k)) < 0.8
    live[0] = False
    w = rng.uniform(0, 1, (B, k)) * live
    w = (w / np.maximum(w.sum(axis=1, keepdims=True), 1e-9)) \
        .astype(np.float32)
    d = rng.uniform(0, 4, (B, k)).astype(np.float32)
    return d, w, live


def t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


# ---------------------------------------------------------------------------
# the edge_reweight op
# ---------------------------------------------------------------------------


REWEIGHT = [(0, 0.5, 0.7), (1, 1.0, 1e-3), (2, 0.3, 1e3), (3, 0.1, 1.0)]


def jax_reweight(seed, eta, lam):
    """JAX's ``edge_reweight`` and the simplex projection of -d / (2 lam)
    on ``rows(seed, B=64, k=9)``."""
    d, w, live = rows(seed, B=64, k=9)
    v = (-d / (2 * lam)).astype(np.float32)
    return (np.asarray(jref.edge_reweight(
                jnp.asarray(d), jnp.asarray(w), jnp.asarray(live), eta=eta,
                lam=lam)),
            np.asarray(jref.simplex_project_rows(jnp.asarray(v),
                                                 jnp.asarray(live))))


@pytest.mark.parametrize("seed,eta,lam", REWEIGHT)
def test_edge_reweight_matches_jax(refs, seed, eta, lam):
    d, w, live = rows(seed, B=64, k=9)
    want, want_proj = refs["reweight"][seed, eta, lam]
    got = ref.edge_reweight(*t(d, w, live), eta=eta, lam=lam)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    v = (-d / (2 * lam)).astype(np.float32)
    np.testing.assert_allclose(
        ref.simplex_project_rows(*t(v, live)).numpy(), want_proj,
        atol=1e-6, rtol=0)


def test_edge_reweight_invariants():
    """Rows stay on the simplex with dead slots exactly 0; eta = 0 is the
    identity and eta = 1 the projection of -d / (2 lam); a tiny lam puts
    all mass on the closest slot, a huge one spreads it evenly."""
    d, w, live = t(*rows())
    out = ref.edge_reweight(d, w, live, eta=0.5, lam=0.7)
    assert (out >= 0).all() and (out[~live] == 0).all()
    has = live.any(dim=1)
    np.testing.assert_allclose(out.sum(1)[has].numpy(), 1.0, atol=1e-5)
    assert (out.sum(1)[~has] == 0).all()
    assert torch.equal(ref.edge_reweight(d, w, live, eta=0.0, lam=0.7), w)
    np.testing.assert_allclose(
        ref.edge_reweight(d, w, live, eta=1.0, lam=0.7).numpy(),
        ref.simplex_project_rows(-d / 1.4, live).numpy(), atol=1e-6)
    sharp = ref.edge_reweight(d, w, live, eta=1.0, lam=1e-3)
    flat = ref.edge_reweight(d, w, live, eta=1.0, lam=1e3)
    assert sharp[1].max().item() == pytest.approx(1.0)
    np.testing.assert_allclose(flat[1][live[1]].numpy(),
                               1.0 / live[1].sum().item(), atol=1e-3)
    near = ref.edge_reweight(torch.tensor([[0.1, 0.2, 5.0, 5.0]]),
                             torch.full((1, 4), 0.25),
                             torch.ones((1, 4), dtype=torch.bool), eta=1.0,
                             lam=0.5)
    assert near[0, :2].sum().item() == pytest.approx(1.0)
    assert (near[0, 2:] == 0).all()


def test_prune_rows_monotone():
    w = torch.tensor([[0.5, 0.4, 1e-5, 0.0]])
    live = torch.tensor([[True, True, True, False]])
    w2, live2 = tgl.prune_rows(w, live, 1e-3)
    assert live2.tolist() == [[True, True, False, False]]
    assert w2[0, 2].item() == 0.0
    # a pruned slot never comes back, even at zero model distance
    out = tgl.reweight_rows(torch.zeros((1, 2)), torch.zeros((1, 4, 2)),
                            w2, live2, eta=1.0, lam=1.0)
    assert out[0, 2].item() == 0.0
    theta = torch.randn(3, 2)
    K = torch.randn(3, 4, 2)
    lv = torch.rand(3, 4) < 0.7
    d = tgl.slot_sq_distances(theta, K, lv)
    want = jgl.slot_sq_distances(jnp.asarray(theta.numpy()),
                                 jnp.asarray(K.numpy()),
                                 jnp.asarray(lv.numpy()))
    np.testing.assert_allclose(d.numpy(), np.asarray(want), rtol=1e-6)


def test_edge_reweight_dispatch():
    assert dispatch.implementations("edge_reweight") == ("reference",)
    assert dispatch.resolve("edge_reweight", None, CPU) is ref.edge_reweight
    assert dispatch.resolve("edge_reweight", None, "cuda") \
        is ref.edge_reweight


# ---------------------------------------------------------------------------
# the joint engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def two_cluster():
    """The port's planted two-cluster topology and the numpy problem (JAX
    builds its own in ``jax_references``)."""
    tt = ttopo.planted_partition_topology(80, 2, k_intra=5, k_inter=2,
                                          seed=0)
    labels, _, sol, c = two_cluster_mean_problem(80, p=4, seed=0)
    assert np.array_equal(labels, tt.groups)
    return tt, labels, sol, c


def jax_two_cluster():
    jt = jtopo.planted_partition_topology(80, 2, k_intra=5, k_inter=2,
                                          seed=0)
    _, _, sol, c = two_cluster_mean_problem(80, p=4, seed=0)
    return jt, sol, c


def joint_spec(tt, sol, c, cond, rounds, batch, record_every, **kw):
    return ScenarioSpec(algo="joint", topology=tt, conditions=cond,
                        rounds=rounds, batch=batch, seed=3,
                        record_every=record_every, theta_sol=sol, c=c,
                        alpha=0.9, device=CPU, **kw)


@pytest.mark.parametrize("cond", [NetworkConditions(), FAULTY],
                         ids=["clean", "faulty"])
def test_rate_zero_is_mp_bit_for_bit(two_cluster, cond):
    tt, _, sol, c = two_cluster
    mp = run_scenario(ScenarioSpec(
        algo="mp", topology=tt, conditions=cond, rounds=60, batch=24,
        seed=3, record_every=20, theta_sol=sol, c=c, alpha=0.9,
        device=CPU))
    jt = run_scenario(joint_spec(tt, sol, c, cond, 60, 24, 20))
    assert torch.equal(jt.theta_hist, mp.theta_hist)
    assert (jt.delivered, jt.dropped, jt.invalid, jt.rounds, jt.events) \
        == (mp.delivered, mp.dropped, mp.invalid, mp.rounds, mp.events)
    assert jt.suppressed == 0
    assert torch.equal(jt.final_w, tt.device_tables(CPU).nbr_p)


JOINT_RUN = dict(rounds=120, batch=32, rec=40)
JOINT_FIELDS = ("delivered", "dropped", "invalid", "rounds", "events",
                "active_hist", "theta_hist", "final_w", "final_live",
                "suppressed", "live_edges_hist")


def joint_kw(prune):
    return dict(LEARN_KW, prune_eps=LEARN_KW["prune_eps"] if prune else None)


def jax_joint_run(prune):
    """JAX's event stream (FAULTY) and its joint run on the planted
    topology, its record's fields as numpy arrays."""
    jt, sol, c = jax_two_cluster()
    rounds, batch, rec = (JOINT_RUN[k] for k in ("rounds", "batch", "rec"))
    cond_j = jsched.NetworkConditions(**vars(FAULTY))
    js = jsched.precompute_event_stream(
        jt.device_tables(), jnp.asarray(jt.partition_halves()), cond_j,
        batch, 3, rounds)
    want = jeng.run_joint_scenario(jt, sol, c, 0.9, cond_j, rounds, batch,
                                   record_every=rec, stream=js,
                                   **joint_kw(prune))
    return {"stream": js._replace(**{f: np.asarray(getattr(js, f))
                                     for f in js._fields}),
            **{f: np.asarray(getattr(want, f)) for f in JOINT_FIELDS}}


@pytest.mark.parametrize("prune", [False, True], ids=["no-prune", "prune"])
def test_run_joint_scenario_matches_jax(refs, two_cluster, prune,
                                        monkeypatch):
    tt, _, sol, c = two_cluster
    kw = joint_kw(prune)
    rounds, batch, rec = (JOINT_RUN[k] for k in ("rounds", "batch", "rec"))
    want = types.SimpleNamespace(**refs["joint_run"][prune])
    js = want.stream
    # record the port's pre-prune weights at every graph step, to tell a
    # rounding-decided prune from a real disagreement
    pre = []
    real_prune = teng.prune_rows

    def spy(w, live, eps):
        pre.append(torch.where(live, w, 0.0))
        return real_prune(w, live, eps)
    monkeypatch.setattr(teng, "prune_rows", spy)
    got = run_scenario(joint_spec(tt, sol, c, FAULTY, rounds, batch, rec,
                                  stream=convert.stream_from_arrays(js, CPU),
                                  **kw))
    assert (got.delivered, got.dropped, got.invalid, got.rounds,
            got.events) == (want.delivered, want.dropped, want.invalid,
                            want.rounds, want.events)
    np.testing.assert_array_equal(got.active_hist.numpy(),
                                  np.asarray(want.active_hist))
    np.testing.assert_allclose(got.theta_hist.numpy(),
                               np.asarray(want.theta_hist), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got.final_w.numpy(), np.asarray(want.final_w),
                               atol=1e-5, rtol=0)
    assert len(pre) == (rounds // 5 if prune else 0)
    eps = kw["prune_eps"]
    near = torch.zeros_like(got.final_live)
    for w in pre:
        near |= (w - eps).abs() <= 1e-5
    flipped = got.final_live.numpy() != np.asarray(want.final_live)
    if flipped.any() or near.any():
        print(f"slots within 1e-5 of prune_eps: {int(near.sum())}; "
              f"final_live differs at {int(flipped.sum())}")
    assert not (flipped & ~near.numpy()).any()
    if not flipped.any():
        assert got.suppressed == want.suppressed
        np.testing.assert_array_equal(got.live_edges_hist.numpy(),
                                      np.asarray(want.live_edges_hist))
    if prune:
        assert got.suppressed > 0
        assert (got.live_edges_hist[1:] <= got.live_edges_hist[:-1]).all()


def test_two_cluster_recovery(two_cluster):
    """>= 90 % of the planted intra-cluster candidate edges keep weight
    and the inter-cluster ones are suppressed (the port's own stream)."""
    tt, labels, sol, c = two_cluster
    tr = run_scenario(ScenarioSpec(
        algo="joint", topology=tt, conditions=NetworkConditions(),
        rounds=300, batch=40, seed=1, record_every=50, theta_sol=sol, c=c,
        alpha=0.9, device=CPU, **LEARN_KW))
    rec = tgl.cluster_edge_recovery(tt.tables.nbr_idx, tt.tables.deg_count,
                                    tr.final_w, labels)
    assert rec.intra_recovered >= 0.9, rec
    assert rec.inter_suppressed >= 0.9, rec
    assert rec.inter_mass <= 0.05, rec
    assert tr.live_edges_hist[-1] < tr.live_edges_hist[0]
    assert tr.suppressed > 0
    assert tr.delivered + tr.dropped == 2 * (tr.events - tr.invalid)
    want = jgl.cluster_edge_recovery(tt.tables.nbr_idx, tt.tables.deg_count,
                                     tr.final_w.numpy(), labels)
    assert dataclasses.astuple(rec) == dataclasses.astuple(want)


def jax_learned_tables():
    """JAX's joint run on the clean network and the weight tables it
    learned (numpy fields)."""
    jt, sol, c = jax_two_cluster()
    tr = jeng.run_joint_scenario(jt, sol, c, 0.9, jsched.NetworkConditions(),
                                 rounds=100, batch=40, seed=1,
                                 record_every=50, **LEARN_KW)
    want = jgl.learned_weight_tables(jt.tables, tr.final_w, tr.final_live)
    return {"final_w": np.array(tr.final_w),
            "final_live": np.array(tr.final_live),
            "tables": {f: np.asarray(getattr(want, f))
                       for f in want._fields}}


def test_learned_weight_tables_match_jax(refs, two_cluster):
    tt, _, sol, c = two_cluster
    want = refs["learned"]
    got = tgl.learned_weight_tables(tt.tables,
                                    torch.tensor(want["final_w"]),
                                    torch.tensor(want["final_live"]))
    for f, w in want["tables"].items():
        np.testing.assert_array_equal(getattr(got, f), w)
    assert got.nbr_idx is tt.tables.nbr_idx         # candidate structure
    # the learned tables drive a fixed-graph run
    again = run_scenario(ScenarioSpec(
        algo="mp", topology=ttopo.SparseTopology(got, tt.groups),
        conditions=NetworkConditions(), rounds=20, batch=16,
        record_every=20, theta_sol=sol, c=c, alpha=0.9, device=CPU))
    assert torch.isfinite(again.theta_hist).all()


# ---------------------------------------------------------------------------
# the JAX side, in a subprocess of its own
# ---------------------------------------------------------------------------


def jax_references():
    """JAX's results for the op and engine comparisons of this module."""
    return {"reweight": {case: jax_reweight(*case) for case in REWEIGHT},
            "joint_run": {prune: jax_joint_run(prune)
                          for prune in (False, True)},
            "learned": jax_learned_tables()}


refs = _port_session.reference_fixture(__name__)
