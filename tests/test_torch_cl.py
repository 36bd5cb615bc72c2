"""The port's CL-ADMM slice against the JAX package on the same inputs.

* Problems, graphs and losses: ``linear_classification_problem`` and
  ``angular_kernel_graph`` build identically from the same seed; losses,
  ``solitary_gd``, the consensus baseline and ``direct_minimize`` within
  1e-5, and the summed losses and ``cl_objective`` (values of 1e3 and
  more in float32) within a relative 1e-6.
* Dense references: ``async_admm`` (fed the JAX run's own wake-ups) and
  ``sync_admm``, quadratic and hinge, within 1e-5 per recorded snapshot;
  ``sync_admm``'s batched primal (every agent at once) against the
  per-agent primals in turn, quadratic, hinge and logistic, within 1e-5;
  the port's ``sparse_async_admm`` equals its dense ``async_admm`` bit for
  bit (the sparse-vs-dense claim) and the JAX ``sparse_async_admm``
  within 1e-5.
* The scenario engine: ``run_scenario(algo="cl")`` replays the JAX
  ``run_cl_scenario`` events (its stream, carried across by
  ``convert.stream_from_arrays``) under the five named scenarios:
  counters and ``active_hist`` exactly, ``theta_hist`` and the final
  state within 1e-5, from the warm start and from a carried-over state.

The JAX side of these comparisons runs in a subprocess of its own that
starts beside the tests before this module (``jax_references``;
tests/_port_session.py).
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import collaborative as jcol  # noqa: E402
from repro.core import consensus as jcons  # noqa: E402
from repro.core import graph as jgraph  # noqa: E402
from repro.core import losses as jloss  # noqa: E402
from repro.core import sparse as jsparse  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.simulate import engines as jeng  # noqa: E402
from repro.simulate import scheduler as jsched  # noqa: E402
from repro.simulate import topology as jtopo  # noqa: E402

import _port_session  # noqa: E402
from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from _port_session import port_background_jobs  # noqa: E402,F401
from _port_session import as_numpy  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import collaborative as tcol  # noqa: E402
from repro_torch.core import consensus as tcons  # noqa: E402
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import losses as tloss  # noqa: E402
from repro_torch.core.primal import ExactQuadraticPrimal  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.simulate import (NetworkConditions,  # noqa: E402
                                  ScenarioSpec, get_scenario,
                                  init_sparse_admm, list_scenarios,
                                  run_scenario, sparse_async_admm)
from repro_torch.simulate import topology as ttopo  # noqa: E402

CPU = "cpu"
ATOL = 1e-5


def jax_references():
    """The JAX side of the tests against JAX (run in a subprocess of its
    own beside the tests before this module: tests/_port_session.py)."""
    return {"losses": jax_losses_and_objective(), "dense": jax_dense(),
            "scenarios": jax_scenarios()}


refs = _port_session.reference_fixture(__name__)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(torch.as_tensor(got).numpy(),
                               np.asarray(want), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# problems, graphs, losses
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lin():
    """The §5.2 problem built by both packages from one seed."""
    j = jsyn.linear_classification_problem(n=24, p=6, seed=2)
    tp = tsyn.linear_classification_problem(n=24, p=6, seed=2, device=CPU)
    return j, tp


@pytest.mark.parametrize("knn", [None, 4])
def test_linear_classification_problem_identical(knn):
    j = jsyn.linear_classification_problem(n=20, p=5, seed=1, knn=knn)
    tp = tsyn.linear_classification_problem(n=20, p=5, seed=1, knn=knn,
                                            device=CPU)
    np.testing.assert_array_equal(tp[0].W, j[0].W)
    np.testing.assert_array_equal(tp[3], j[3])
    for td, jd in ((tp[1], j[1]), (tp[2], j[2])):
        for f in ("x", "y", "mask"):
            np.testing.assert_array_equal(getattr(td, f).numpy(),
                                          np.asarray(getattr(jd, f)))


def test_angular_kernel_graph_identical():
    m = np.random.default_rng(0).standard_normal((15, 3))
    m[4] = 0.0                                       # a zero-norm row
    np.testing.assert_array_equal(tgraph.angular_kernel_graph(m, 0.2).W,
                                  jgraph.angular_kernel_graph(m, 0.2).W)
    with pytest.raises(ValueError):
        tgraph.angular_kernel_graph(m, 0.0)


def loss_inputs():
    """The losses test's draws: theta (24, 6), then 7 values and a mask."""
    rng = np.random.default_rng(0)
    theta = rng.standard_normal((24, 6)).astype(np.float32)
    vals = rng.standard_normal(7).astype(np.float32)
    mask = (rng.uniform(size=7) > 0.4).astype(np.float32)
    return theta, vals, mask


def objective_theta():
    return np.random.default_rng(1).standard_normal((24, 6)) \
        .astype(np.float32)


def jax_losses_and_objective():
    """JAX's side of the two tests on the §5.2 problem."""
    jg, jtr, _, _ = jsyn.linear_classification_problem(n=24, p=6, seed=2)
    theta, vals, mask = loss_inputs()
    out = {"total": {}, "one": {}}
    for name in ("quadratic", "hinge", "logistic"):
        out["total"][name] = jloss.total_loss(jloss.LOSSES[name],
                                              jnp.asarray(theta), jtr)
        out["one"][name] = jloss.LOSSES[name](jnp.asarray(theta[0]),
                                              jtr.x[0], jtr.y[0],
                                              jtr.mask[0])
    out["solitary"] = jloss.solitary_gd(jtr, "hinge", steps=30)
    out["masked_sum"] = jloss.masked_sum(jnp.asarray(vals),
                                         jnp.asarray(mask))
    out["accuracy"] = jsyn.accuracy(theta, jtr)
    theta = objective_theta()
    out["objective"] = jcol.cl_objective(jnp.asarray(theta), jg.W, 0.5,
                                         jloss.hinge_loss, jtr)
    out["consensus_model"] = jcons.consensus_model(jtr, "hinge", steps=40)
    out["consensus_mean"] = jcons.consensus_mean(jtr)
    out["direct"] = {loss: jcol.direct_minimize(jg, jtr, 0.5, loss,
                                                steps=60)
                     for loss in ("hinge", "logistic")}
    return as_numpy(out)


def test_losses_and_solitary_models_match_jax(lin, refs):
    (_, ttr, _, _) = lin[1]
    want = refs["losses"]
    theta, vals, mask = loss_inputs()
    for name in ("quadratic", "hinge", "logistic"):
        # a sum of about 2e3 in float32: relative 1e-6, a few ulp
        np.testing.assert_allclose(
            tloss.total_loss(tloss.LOSSES[name], torch.as_tensor(theta),
                             ttr).numpy(),
            want["total"][name], rtol=1e-6, atol=0)
        close(tloss.LOSSES[name](torch.as_tensor(theta[0]), ttr.x[0],
                                 ttr.y[0], ttr.mask[0]),
              want["one"][name])
    close(tloss.solitary_gd(ttr, "hinge", steps=30), want["solitary"])
    close(tloss.masked_sum(torch.as_tensor(vals), torch.as_tensor(mask)),
          want["masked_sum"])
    acc = tsyn.accuracy(theta, ttr)
    np.testing.assert_array_equal(acc, want["accuracy"])


def test_objective_consensus_and_direct_minimize_match_jax(lin, refs):
    (tg, ttr, _, _) = lin[1]
    want = refs["losses"]
    theta = objective_theta()
    np.testing.assert_allclose(           # a sum of ~1e3: relative 1e-6
        tcol.cl_objective(torch.as_tensor(theta), tg.W, 0.5,
                          tloss.hinge_loss, ttr).numpy(),
        want["objective"], rtol=1e-6, atol=0)
    close(tcons.consensus_model(ttr, "hinge", steps=40),
          want["consensus_model"])
    close(tcons.consensus_mean(ttr), want["consensus_mean"])
    for loss in ("hinge", "logistic"):
        close(tcol.direct_minimize(tg, ttr, 0.5, loss, steps=60),
              want["direct"][loss])


# ---------------------------------------------------------------------------
# dense references and the sparse exact engine
# ---------------------------------------------------------------------------

N_D, P_D, STEPS, REC = 24, 4, 40, 20


def dense_problem():
    """A small graph of both packages, quadratic data (JAX's) and the
    solitary warm start."""
    jg = jgraph.random_geometric_graph(N_D, k=3, seed=0)
    tg = tgraph.random_geometric_graph(N_D, k=3, seed=0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N_D, 4, P_D)).astype(np.float32)
    ys = [np.sign(rng.standard_normal(4)) for _ in range(N_D)]
    jd = jloss.pad_datasets(list(x), ys)
    sol = np.asarray(jloss.solitary_mean(jd), np.float32)
    return jg, tg, jd, sol


def jax_dense():
    """The wake-ups the JAX ``async_admm(seed=3)`` draws (its key
    schedule, replayed), and JAX's dense and sparse runs."""
    jg, _, jd, sol = dense_problem()
    tabs = jsparse.to_device(jsparse.padded_neighbor_tables(jg))
    draws = ([], [])
    for key in jax.random.split(jax.random.PRNGKey(3), STEPS // REC):
        for kk in jax.random.split(key, REC):
            i, s = jsparse.sample_event(kk, N_D, tabs.slot_cdf,
                                        tabs.deg_count)
            draws[0].append(int(i))
            draws[1].append(int(s))
    out = {"draws": draws, "async": {}, "sync": {},
           "direct": jcol.direct_minimize(jg, jd, 0.5, "quadratic",
                                          steps=60)}
    for loss in ("quadratic", "hinge"):
        tr = jcol.async_admm(jg, jd, 0.5, 1.0, loss=loss, steps=STEPS,
                             seed=3, record_every=REC, theta_sol=sol,
                             k_steps=3)
        out["async"][loss] = {"theta_hist": tr.theta_hist,
                              "comms_hist": tr.comms_hist,
                              "L_own": tr.final.L_own}
        tr = jcol.sync_admm(jg, jd, 0.5, 1.0, loss=loss, steps=4,
                            theta_sol=sol, k_steps=3)
        out["sync"][loss] = {"theta_hist": tr.theta_hist,
                             "comms_hist": tr.comms_hist}
    out["sparse"] = jeng.sparse_async_admm(
        jtopo.SparseTopology.from_graph(jg), jd, 0.5, 1.0, steps=STEPS,
        seed=3, record_every=REC, theta_sol=sol).theta_hist
    return as_numpy(out)


@pytest.fixture(scope="module")
def dense(refs):
    """The small problem, its data on both sides, the warm start and the
    JAX run's wake-ups."""
    jg, tg, jd, sol = dense_problem()
    draws = tuple(list(d) for d in refs["dense"]["draws"])
    return jg, tg, jd, convert.data_from_arrays(jd, CPU), sol, draws


def test_direct_minimize_quadratic_matches_jax(dense, refs):
    _, tg, _, td, _, _ = dense
    close(tcol.direct_minimize(tg, td, 0.5, "quadratic", steps=60),
          refs["dense"]["direct"])


@pytest.mark.parametrize("loss", ["quadratic", "hinge"])
def test_async_admm_matches_jax(dense, refs, loss):
    _, tg, _, td, sol, draws = dense
    want = refs["dense"]["async"][loss]
    got = tcol.async_admm(tg, td, 0.5, 1.0, loss=loss, steps=STEPS,
                          record_every=REC, theta_sol=sol, k_steps=3,
                          draws=draws, device=CPU)
    close(got.theta_hist, want["theta_hist"])
    np.testing.assert_array_equal(got.comms_hist, want["comms_hist"])
    close(got.final.L_own, want["L_own"])


@pytest.mark.parametrize("loss", ["quadratic", "hinge"])
def test_sync_admm_matches_jax(dense, refs, loss):
    _, tg, _, td, sol, _ = dense
    want = refs["dense"]["sync"][loss]
    got = tcol.sync_admm(tg, td, 0.5, 1.0, loss=loss, steps=4,
                         theta_sol=sol, k_steps=3, device=CPU)
    close(got.theta_hist, want["theta_hist"])
    np.testing.assert_array_equal(got.comms_hist, want["comms_hist"])


def agent_loop_sync_admm(g, data, mu, rho, loss, steps, k_steps, lr, sol):
    """``sync_admm`` as the JAX reference orders it: each agent's own
    primal (``_make_primal``) in turn, then every edge's Z and dual
    update; a snapshot of the models per iteration."""
    _, st, _, tabs, W, D, mask = tcol._setup(g, data, sol, None, CPU)
    primal = tcol._make_primal(tabs, W, D, mask, mu, rho, data, loss,
                               k_steps, lr, None)
    hist = []
    for _ in range(steps):
        for agent in range(g.n):
            primal(st, agent)
        tcol._all_zl_update(st, mask, rho)
        hist.append(st.models().clone())
    return torch.stack(hist)


@pytest.mark.parametrize("loss", ["quadratic", "hinge", "logistic"])
def test_sync_admm_batched_primal_equals_agent_loop(lin, loss):
    """The batched primal of every agent at once against the per-agent
    primals in turn over the same state, per recorded snapshot."""
    (tg, ttr, _, _) = lin[1]
    sol = tloss.solitary_gd(ttr, "hinge", steps=30)
    got = tcol.sync_admm(tg, ttr, 0.5, 1.0, loss=loss, steps=6, k_steps=4,
                         lr=0.05, theta_sol=sol, device=CPU)
    want = agent_loop_sync_admm(tg, ttr, 0.5, 1.0, loss, 6, 4, 0.05, sol)
    assert got.theta_hist.shape == want.shape
    close(got.theta_hist, want)
    # the models moved off the warm start
    assert (got.theta_hist[-1] - sol).abs().max() > 1e-3


def test_sparse_async_admm_equals_dense_bit_for_bit(dense, refs):
    _, tg, _, td, sol, draws = dense
    topo = ttopo.SparseTopology.from_graph(tg)
    sp = sparse_async_admm(topo, td, 0.5, 1.0, steps=STEPS,
                           record_every=REC, theta_sol=sol, draws=draws,
                           device=CPU)
    dn = tcol.async_admm(tg, td, 0.5, 1.0, steps=STEPS, record_every=REC,
                         theta_sol=sol, draws=draws, device=CPU)
    assert torch.equal(sp.theta_hist, dn.theta_hist)
    close(sp.theta_hist, refs["dense"]["sparse"])
    # the torch-drawn wake-ups replay from their seed
    a = sparse_async_admm(topo, td, 0.5, 1.0, steps=10, seed=5,
                          record_every=10, theta_sol=sol, device=CPU)
    b = sparse_async_admm(topo, td, 0.5, 1.0, steps=10, seed=5,
                          record_every=10, theta_sol=sol, device=CPU)
    assert torch.equal(a.theta_hist, b.theta_hist)


# ---------------------------------------------------------------------------
# the scenario engine against JAX run_cl_scenario
# ---------------------------------------------------------------------------

N, P, ROUNDS, BATCH, RECORD, SEED = 150, 6, 30, 60, 10, 7


def scen_problem():
    """The JAX topology, the benchmark's quadratic CL data (three
    standard-normal draws per agent) and its solitary means."""
    jt = jtopo.random_geometric_topology(N, k=5, seed=0)
    x = np.random.default_rng(1).standard_normal((N, 3, P)) \
        .astype(np.float32)
    jd = jloss.pad_datasets(list(x), [np.zeros(3)] * N)
    sol = np.asarray(jloss.solitary_mean(jd), np.float32)
    return jt, jd, sol


@pytest.fixture(scope="module")
def scen():
    """JAX and port topologies, the CL data on both sides and the
    solitary means."""
    jt, jd, sol = scen_problem()
    tt = ttopo.random_geometric_topology(N, k=5, seed=0)
    return jt, tt, jd, convert.data_from_arrays(jd, CPU), sol


def jax_stream(jt, cond_j, rounds=ROUNDS):
    return jsched.precompute_event_stream(
        jt.device_tables(), jnp.asarray(jt.partition_halves()), cond_j,
        BATCH, SEED, rounds)


STATE_FIELDS = ("theta", "K", "Z_own", "Z_nbr", "L_own", "L_nbr")


def cl_fields(tr):
    """A JAX CL trace's counters, histories and final state."""
    out = {k: getattr(tr, k) for k in (
        "delivered", "dropped", "invalid", "rounds", "events",
        "active_hist", "theta_hist")}
    out["final"] = {f: getattr(tr.final, f) for f in STATE_FIELDS}
    return out


def jax_scenarios():
    """JAX's ``run_cl_scenario`` under every scenario, with its stream;
    and lossy-10 continued from its final state."""
    jt, jd, sol = scen_problem()
    out = {}
    for scenario in list_scenarios():
        cond_j = jsched.NetworkConditions(**vars(
            get_scenario(scenario).make_conditions(ROUNDS)))
        js = jax_stream(jt, cond_j)
        tr = jeng.run_cl_scenario(jt, jd, 0.1, 1.0, cond_j, ROUNDS, BATCH,
                                  record_every=RECORD, theta_sol=sol,
                                  stream=js)
        out[scenario] = {"stream": js, "trace": cl_fields(tr)}
        if scenario == "lossy-10":
            again = jeng.run_cl_scenario(jt, jd, 0.1, 1.0, cond_j, ROUNDS,
                                         BATCH, record_every=RECORD,
                                         state=tr.final, stream=js)
            out["carried"] = {"first": {f: getattr(tr.final, f)
                                        for f in STATE_FIELDS},
                              "trace": cl_fields(again)}
    jinit = jeng.init_sparse_admm(jt, sol)
    out["init"] = {f: getattr(jinit, f) for f in STATE_FIELDS}
    return as_numpy(out)


def assert_cl_matches(got, want):
    assert (got.delivered, got.dropped, got.invalid, got.rounds,
            got.events) == tuple(int(want[k]) for k in (
                "delivered", "dropped", "invalid", "rounds", "events"))
    np.testing.assert_array_equal(got.active_hist.numpy(),
                                  want["active_hist"])
    close(got.theta_hist, want["theta_hist"])
    for f in STATE_FIELDS:
        close(getattr(got.final, f), want["final"][f])


def cl_spec(tt, td, cond, stream, **kw):
    return ScenarioSpec(algo="cl", topology=tt, conditions=cond,
                        rounds=ROUNDS, batch=BATCH, record_every=RECORD,
                        data=td, mu=0.1, rho=1.0, stream=stream, device=CPU,
                        **kw)


@pytest.mark.parametrize("scenario", list_scenarios())
def test_run_scenario_cl_matches_jax(scen, refs, scenario):
    _, tt, _, td, sol = scen
    want = refs["scenarios"][scenario]
    cond = get_scenario(scenario).make_conditions(ROUNDS)
    stream = convert.stream_from_arrays(want["stream"], CPU)
    got = run_scenario(cl_spec(tt, td, cond, stream, theta_sol=sol))
    assert_cl_matches(got, want["trace"])
    assert got.delivered + got.dropped == 2 * (got.events - got.invalid)
    if scenario == "lossy-10":
        # the explicit exact solver is the default computation
        again = run_scenario(cl_spec(tt, td, cond, stream, theta_sol=sol,
                                     primal=ExactQuadraticPrimal()))
        assert torch.equal(again.theta_hist, got.theta_hist)


def test_run_scenario_cl_from_carried_state(scen, refs):
    """Both sides continue from the same mid-run state (the JAX final
    state, carried across by ``convert.admm_state_from_arrays``)."""
    _, tt, _, td, sol = scen
    cond = get_scenario("lossy-10").make_conditions(ROUNDS)
    carried = refs["scenarios"]["carried"]
    state = convert.admm_state_from_arrays(
        types.SimpleNamespace(**carried["first"]), CPU)
    got = run_scenario(cl_spec(
        tt, td, cond, convert.stream_from_arrays(
            refs["scenarios"]["lossy-10"]["stream"], CPU), state=state))
    assert got.final is state                       # updated in place
    assert_cl_matches(got, carried["trace"])
    init = init_sparse_admm(tt, sol, CPU)
    for f in STATE_FIELDS:
        np.testing.assert_array_equal(getattr(init, f).numpy(),
                                      refs["scenarios"]["init"][f])
    dense = convert.admm_state_from_arrays(jcol.init_state(
        jgraph.ring_graph(5), np.ones((5, 2), np.float32)), CPU)
    assert isinstance(dense, tcol.ADMMState) and dense.T.shape == (5, 5, 2)


def test_cl_torch_stream_invariant_and_replay(scen):
    """The port's own torch-drawn stream: the accounting invariant holds
    and the same seed replays bit for bit."""
    _, tt, _, td, sol = scen
    cond = NetworkConditions(drop_prob=0.1, stale_prob=0.2)
    kw = dict(algo="cl", topology=tt, conditions=cond, rounds=20,
              batch=BATCH, seed=4, record_every=10, data=td, mu=0.1,
              rho=1.0, theta_sol=sol, device=CPU)
    a = run_scenario(ScenarioSpec(**kw))
    b = run_scenario(ScenarioSpec(**kw))
    assert a.delivered + a.dropped == 2 * (a.events - a.invalid)
    assert a.delivered > 0 and a.dropped > 0
    assert torch.equal(a.theta_hist, b.theta_hist)
    assert torch.isfinite(a.theta_hist).all()


def test_cl_spec_rejects_what_is_not_ported(scen):
    _, tt, _, td, sol = scen
    cond = get_scenario("clean").make_conditions(ROUNDS)

    class NoSolve:                        # a "solver" without solve_batch
        needs_data = True

    with pytest.raises(TypeError, match="solve_batch"):
        run_scenario(cl_spec(tt, td, cond, None, theta_sol=sol,
                             primal=NoSolve()))
    with pytest.raises(ValueError, match="data"):
        run_scenario(ScenarioSpec(algo="cl", topology=tt, conditions=cond,
                                  rounds=ROUNDS, batch=BATCH, mu=0.1,
                                  rho=1.0, theta_sol=sol, device=CPU))
    with pytest.raises(ValueError, match="primal"):
        ScenarioSpec(algo="mp", topology=tt, conditions=cond, rounds=4,
                     batch=2, primal=ExactQuadraticPrimal())
