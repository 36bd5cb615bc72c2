"""The port's CL-ADMM slice against the JAX package on the same inputs.

* Problems, graphs and losses: ``linear_classification_problem`` and
  ``angular_kernel_graph`` build identically from the same seed; losses,
  ``solitary_gd``, the consensus baseline and ``direct_minimize`` within
  1e-5, and the summed losses and ``cl_objective`` (values of 1e3 and
  more in float32) within a relative 1e-6.
* Dense references: ``async_admm`` (fed the JAX run's own wake-ups) and
  ``sync_admm``, quadratic and hinge, within 1e-5 per recorded snapshot;
  the port's ``sparse_async_admm`` equals its dense ``async_admm`` bit for
  bit (the sparse-vs-dense claim) and the JAX ``sparse_async_admm``
  within 1e-5.
* The scenario engine: ``run_scenario(algo="cl")`` replays the JAX
  ``run_cl_scenario`` events (its stream, carried across by
  ``convert.stream_from_arrays``) under the five named scenarios:
  counters and ``active_hist`` exactly, ``theta_hist`` and the final
  state within 1e-5, from the warm start and from a carried-over state.
"""

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

from _jax_caches import fresh_jax_caches  # noqa: E402,F401
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


def test_losses_and_solitary_models_match_jax(lin):
    (_, jtr, _, _), (_, ttr, _, _) = lin
    rng = np.random.default_rng(0)
    theta = rng.standard_normal((24, 6)).astype(np.float32)
    for name in ("quadratic", "hinge", "logistic"):
        # a sum of about 2e3 in float32: relative 1e-6, a few ulp
        np.testing.assert_allclose(
            tloss.total_loss(tloss.LOSSES[name], torch.as_tensor(theta),
                             ttr).numpy(),
            np.asarray(jloss.total_loss(jloss.LOSSES[name],
                                        jnp.asarray(theta), jtr)),
            rtol=1e-6, atol=0)
        close(tloss.LOSSES[name](torch.as_tensor(theta[0]), ttr.x[0],
                                 ttr.y[0], ttr.mask[0]),
              jloss.LOSSES[name](jnp.asarray(theta[0]), jtr.x[0], jtr.y[0],
                                 jtr.mask[0]))
    close(tloss.solitary_gd(ttr, "hinge", steps=30),
          jloss.solitary_gd(jtr, "hinge", steps=30))
    vals = rng.standard_normal(7).astype(np.float32)
    mask = (rng.uniform(size=7) > 0.4).astype(np.float32)
    close(tloss.masked_sum(torch.as_tensor(vals), torch.as_tensor(mask)),
          jloss.masked_sum(jnp.asarray(vals), jnp.asarray(mask)))
    acc = tsyn.accuracy(theta, ttr)
    np.testing.assert_array_equal(acc, jsyn.accuracy(theta, jtr))


def test_objective_consensus_and_direct_minimize_match_jax(lin):
    (jg, jtr, _, _), (tg, ttr, _, _) = lin
    theta = np.random.default_rng(1).standard_normal((24, 6)) \
        .astype(np.float32)
    np.testing.assert_allclose(           # a sum of ~1e3: relative 1e-6
        tcol.cl_objective(torch.as_tensor(theta), tg.W, 0.5,
                          tloss.hinge_loss, ttr).numpy(),
        np.asarray(jcol.cl_objective(jnp.asarray(theta), jg.W, 0.5,
                                     jloss.hinge_loss, jtr)),
        rtol=1e-6, atol=0)
    close(tcons.consensus_model(ttr, "hinge", steps=40),
          jcons.consensus_model(jtr, "hinge", steps=40))
    close(tcons.consensus_mean(ttr), jcons.consensus_mean(jtr))
    for loss in ("hinge", "logistic"):
        close(tcol.direct_minimize(tg, ttr, 0.5, loss, steps=60),
              jcol.direct_minimize(jg, jtr, 0.5, loss, steps=60))


# ---------------------------------------------------------------------------
# dense references and the sparse exact engine
# ---------------------------------------------------------------------------

N_D, P_D, STEPS, REC = 24, 4, 40, 20


@pytest.fixture(scope="module")
def dense():
    """A small graph, quadratic data, warm starts and the wake-ups the JAX
    ``async_admm(seed=3)`` draws (its key schedule, replayed here)."""
    jg = jgraph.random_geometric_graph(N_D, k=3, seed=0)
    tg = tgraph.random_geometric_graph(N_D, k=3, seed=0)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N_D, 4, P_D)).astype(np.float32)
    ys = [np.sign(rng.standard_normal(4)) for _ in range(N_D)]
    jd = jloss.pad_datasets(list(x), ys)
    sol = np.asarray(jloss.solitary_mean(jd), np.float32)
    tabs = jsparse.to_device(jsparse.padded_neighbor_tables(jg))
    draws = ([], [])
    for key in jax.random.split(jax.random.PRNGKey(3), STEPS // REC):
        for kk in jax.random.split(key, REC):
            i, s = jsparse.sample_event(kk, N_D, tabs.slot_cdf,
                                        tabs.deg_count)
            draws[0].append(int(i))
            draws[1].append(int(s))
    return jg, tg, jd, convert.data_from_arrays(jd, CPU), sol, draws


def test_direct_minimize_quadratic_matches_jax(dense):
    jg, tg, jd, td, _, _ = dense
    close(tcol.direct_minimize(tg, td, 0.5, "quadratic", steps=60),
          jcol.direct_minimize(jg, jd, 0.5, "quadratic", steps=60))


@pytest.mark.parametrize("loss", ["quadratic", "hinge"])
def test_async_admm_matches_jax(dense, loss):
    jg, tg, jd, td, sol, draws = dense
    want = jcol.async_admm(jg, jd, 0.5, 1.0, loss=loss, steps=STEPS, seed=3,
                           record_every=REC, theta_sol=sol, k_steps=3)
    got = tcol.async_admm(tg, td, 0.5, 1.0, loss=loss, steps=STEPS,
                          record_every=REC, theta_sol=sol, k_steps=3,
                          draws=draws, device=CPU)
    close(got.theta_hist, want.theta_hist)
    np.testing.assert_array_equal(got.comms_hist, want.comms_hist)
    close(got.final.L_own, want.final.L_own)


@pytest.mark.parametrize("loss", ["quadratic", "hinge"])
def test_sync_admm_matches_jax(dense, loss):
    jg, tg, jd, td, sol, _ = dense
    want = jcol.sync_admm(jg, jd, 0.5, 1.0, loss=loss, steps=4,
                          theta_sol=sol, k_steps=3)
    got = tcol.sync_admm(tg, td, 0.5, 1.0, loss=loss, steps=4,
                         theta_sol=sol, k_steps=3, device=CPU)
    close(got.theta_hist, want.theta_hist)
    np.testing.assert_array_equal(got.comms_hist, want.comms_hist)


def test_sparse_async_admm_equals_dense_bit_for_bit(dense):
    jg, tg, jd, td, sol, draws = dense
    topo = ttopo.SparseTopology.from_graph(tg)
    sp = sparse_async_admm(topo, td, 0.5, 1.0, steps=STEPS,
                           record_every=REC, theta_sol=sol, draws=draws,
                           device=CPU)
    dn = tcol.async_admm(tg, td, 0.5, 1.0, steps=STEPS, record_every=REC,
                         theta_sol=sol, draws=draws, device=CPU)
    assert torch.equal(sp.theta_hist, dn.theta_hist)
    want = jeng.sparse_async_admm(jtopo.SparseTopology.from_graph(jg), jd,
                                  0.5, 1.0, steps=STEPS, seed=3,
                                  record_every=REC, theta_sol=sol)
    close(sp.theta_hist, want.theta_hist)
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


@pytest.fixture(scope="module")
def scen():
    """JAX and port topologies, the benchmark's quadratic CL data (three
    standard-normal draws per agent) and its solitary means."""
    jt = jtopo.random_geometric_topology(N, k=5, seed=0)
    tt = ttopo.random_geometric_topology(N, k=5, seed=0)
    x = np.random.default_rng(1).standard_normal((N, 3, P)) \
        .astype(np.float32)
    jd = jloss.pad_datasets(list(x), [np.zeros(3)] * N)
    sol = np.asarray(jloss.solitary_mean(jd), np.float32)
    return jt, tt, jd, convert.data_from_arrays(jd, CPU), sol


def jax_stream(jt, cond_j, rounds=ROUNDS):
    return jsched.precompute_event_stream(
        jt.device_tables(), jnp.asarray(jt.partition_halves()), cond_j,
        BATCH, SEED, rounds)


def assert_cl_matches(got, want):
    assert (got.delivered, got.dropped, got.invalid, got.rounds,
            got.events) == (want.delivered, want.dropped, want.invalid,
                            want.rounds, want.events)
    np.testing.assert_array_equal(got.active_hist.numpy(),
                                  np.asarray(want.active_hist))
    close(got.theta_hist, want.theta_hist)
    for f in ("theta", "K", "Z_own", "Z_nbr", "L_own", "L_nbr"):
        close(getattr(got.final, f), getattr(want.final, f))


def cl_spec(tt, td, cond, stream, **kw):
    return ScenarioSpec(algo="cl", topology=tt, conditions=cond,
                        rounds=ROUNDS, batch=BATCH, record_every=RECORD,
                        data=td, mu=0.1, rho=1.0, stream=stream, device=CPU,
                        **kw)


@pytest.mark.parametrize("scenario", list_scenarios())
def test_run_scenario_cl_matches_jax(scen, scenario):
    jt, tt, jd, td, sol = scen
    cond = get_scenario(scenario).make_conditions(ROUNDS)
    cond_j = jsched.NetworkConditions(**vars(cond))
    js = jax_stream(jt, cond_j)
    want = jeng.run_cl_scenario(jt, jd, 0.1, 1.0, cond_j, ROUNDS, BATCH,
                                record_every=RECORD, theta_sol=sol,
                                stream=js)
    stream = convert.stream_from_arrays(js, CPU)
    got = run_scenario(cl_spec(tt, td, cond, stream, theta_sol=sol))
    assert_cl_matches(got, want)
    assert got.delivered + got.dropped == 2 * (got.events - got.invalid)
    if scenario == "lossy-10":
        # the explicit exact solver is the default computation
        again = run_scenario(cl_spec(tt, td, cond, stream, theta_sol=sol,
                                     primal=ExactQuadraticPrimal()))
        assert torch.equal(again.theta_hist, got.theta_hist)


def test_run_scenario_cl_from_carried_state(scen):
    """Both sides continue from the same mid-run state (the JAX final
    state, carried across by ``convert.admm_state_from_arrays``)."""
    jt, tt, jd, td, sol = scen
    cond = get_scenario("lossy-10").make_conditions(ROUNDS)
    cond_j = jsched.NetworkConditions(**vars(cond))
    js = jax_stream(jt, cond_j)
    first = jeng.run_cl_scenario(jt, jd, 0.1, 1.0, cond_j, ROUNDS, BATCH,
                                 record_every=RECORD, theta_sol=sol,
                                 stream=js)
    want = jeng.run_cl_scenario(jt, jd, 0.1, 1.0, cond_j, ROUNDS, BATCH,
                                record_every=RECORD, state=first.final,
                                stream=js)
    state = convert.admm_state_from_arrays(first.final, CPU)
    got = run_scenario(cl_spec(tt, td, cond,
                               convert.stream_from_arrays(js, CPU),
                               state=state))
    assert got.final is state                       # updated in place
    assert_cl_matches(got, want)
    init = init_sparse_admm(tt, sol, CPU)
    jinit = jeng.init_sparse_admm(jt, sol)
    for f in ("theta", "K", "Z_own", "Z_nbr", "L_own", "L_nbr"):
        np.testing.assert_array_equal(getattr(init, f).numpy(),
                                      np.asarray(getattr(jinit, f)))
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
