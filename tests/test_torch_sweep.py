"""The port's multi-trial sweeps (``repro_torch.experiments``) against the
JAX package's (``repro.experiments``) and against per-instance runs.

* The trial builders make JAX's trials: the same numpy draws, so every
  array is equal (the solitary models within float32 rounding: each
  package sums the samples in its own order).
* ``run_mp_sweep``, ``closed_form_comparison``, ``run_joint_sweep``,
  ``run_admm_sweep``, and ``run_scenario_sweep`` with
  ``inexact_primal_axis`` against their JAX twins, and the sweeps against
  the port's per-instance algorithms, within ``tests/test_sweep.py``'s
  tolerances (1e-4 on models; 1e-3 relative on the closed form's errors).
* The ``mix`` op with a trial axis: the batched plain version equals a
  per-trial loop of the unbatched one bit for bit, at D = 1 (the sweeps'
  shape) and D > 1; a joint sweep's eta = 0 column equals the MP sweep
  bit for bit.

The JAX side of every comparison runs in a subprocess of its own beside
the tests before this module (``jax_references``; tests/_port_session.py).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import experiments as jexp  # noqa: E402
from repro.core import losses as jloss  # noqa: E402
from repro.simulate import scheduler as jsched  # noqa: E402
from repro.simulate import spec as jspec  # noqa: E402
from repro.simulate import topology as jtopo  # noqa: E402

import _port_session  # noqa: E402
from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from _port_session import port_background_jobs  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch import experiments as texp  # noqa: E402
from repro_torch.core import closed_form, sync_admm, synchronous  # noqa: E402
from repro_torch.data import mean_estimation_problem  # noqa: E402
from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.kernels import graph_mix as tgm  # noqa: E402
from repro_torch.simulate import (NetworkConditions,  # noqa: E402
                                  ScenarioSpec, run_scenario)
from repro_torch.simulate import topology as ttopo  # noqa: E402

CPU = "cpu"
SEEDS, ALPHAS, N = [0, 1, 2], [0.9, 0.99], 24


@pytest.fixture(scope="module")
def mp_trials(refs):
    return (refs["mp_trials"],
            texp.mean_estimation_trials(seeds=SEEDS, alphas=ALPHAS, n=N))


def numpy_fields(rec):
    """A JAX package record (a dataclass or a named tuple) with its array
    fields as numpy arrays."""
    if dataclasses.is_dataclass(rec):
        names = [f.name for f in dataclasses.fields(rec)]
        replace = lambda **kw: dataclasses.replace(rec, **kw)  # noqa: E731
    else:
        names, replace = rec._fields, rec._replace
    return replace(**{name: np.asarray(getattr(rec, name)) for name in names
                      if hasattr(getattr(rec, name), "shape")})


def result_fields(res, names):
    return {f: np.asarray(getattr(res, f)) for f in names}


def assert_trials_equal(got, want, rounded=("theta_sol",)):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), np.asarray(getattr(want, f.name))
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        if f.name in rounded:
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f.name)


def close(got, want, atol=1e-4, rtol=1e-4):
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


# ---------------------------------------------------------------------------
# trial builders
# ---------------------------------------------------------------------------


NOISES = [(0.0,), (0.0, 0.2)]
ADMM_TRIALS = dict(seeds=[0, 1], mus=[0.05, 0.2], rhos=[1.0], n=12)
JOINT_TRIALS = dict(seeds=[0, 1], alphas=[0.9], etas=[0.0, 0.3],
                    lams=[1.0, 0.5], n=16)


def mp_trials_kw(noises):
    return dict(seeds=[0, 1], alphas=[0.9], graph_noises=noises, n=20)


@pytest.mark.parametrize("noises", NOISES)
def test_mp_trials_match_jax(refs, noises):
    got = texp.mean_estimation_trials(**mp_trials_kw(noises))
    assert_trials_equal(got, refs["trials"][noises])
    assert got.n_trials == 2 * len(noises)
    if len(noises) == 2:
        assert np.abs(got.W[1] - got.W[0]).max() > 0
        np.testing.assert_allclose(got.W[1], got.W[1].T)


def test_admm_and_joint_trials_match_jax(refs):
    assert_trials_equal(texp.admm_mean_estimation_trials(**ADMM_TRIALS),
                        refs["admm_trials"])
    assert_trials_equal(texp.joint_mean_estimation_trials(**JOINT_TRIALS),
                        refs["joint_trials"])


# ---------------------------------------------------------------------------
# the mix op over a trial axis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,n,D", [(6, 30, 1), (3, 64, 1), (4, 17, 3),
                                   (2, 40, 8), (1, 25, 1)])
def test_batched_plain_graph_mix_equals_per_trial_loop(T, n, D):
    rng = np.random.default_rng(T * 100 + n + D)
    theta, sol = (torch.as_tensor(rng.standard_normal((T, n, D)),
                                  dtype=torch.float32) for _ in range(2))
    A = torch.as_tensor(rng.uniform(size=(T, n, n)) / n, dtype=torch.float32)
    b = torch.as_tensor(rng.uniform(size=(T, n)), dtype=torch.float32)
    got = ref.graph_mix(theta, sol, A, b)
    loop = torch.stack([ref.graph_mix(theta[t], sol[t], A[t], b[t])
                        for t in range(T)])
    assert torch.equal(got, loop)
    want = A.double() @ theta.double() + b.double()[..., None] * sol.double()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    # the dispatch op takes the trial axis on the CPU, with no launch
    dispatch.reset_launch_counts()
    assert torch.equal(dispatch.resolve("mix", None, CPU)(theta, sol, A, b),
                       got)
    assert dispatch.launch_counts()["graph_mix"] == 0


def test_graph_mix_wrapper_checks_the_trial_axis():
    T, n, D = 3, 8, 1
    z = torch.zeros
    good = (z(T, n, D), z(T, n, D), z(T, n, n), z(T, n))
    tgm._check(*good)
    tgm._check(*(a[0] for a in good))
    with pytest.raises(ValueError, match="shape"):
        tgm._check(z(T, n, D), z(T, n, D), z(n, n), z(T, n))
    with pytest.raises(ValueError, match="shape"):
        tgm._check(z(T, n, D), z(T, n, D), z(T, n, n), z(n))
    with pytest.raises(ValueError, match="trials"):
        tgm._check(z(0, n, D), z(0, n, D), z(0, n, n), z(0, n))
    with pytest.raises(ValueError, match="trials"):
        big = tgm.MAX_TRIALS + 1
        tgm._check(*(torch.empty(big, *a.shape[1:]) for a in good))
    with pytest.raises(ValueError, match=r"\(n, D\) or \(T, n, D\)"):
        tgm._check(z(2, T, n, D), z(2, T, n, D), z(2, T, n, n), z(2, T, n))


# ---------------------------------------------------------------------------
# the sweeps against their JAX twins and per-instance runs
# ---------------------------------------------------------------------------


MP_SWEEPS = 120
SWEEP_FIELDS = ("theta_final", "err_hist", "objective_hist")


def test_mp_sweep_matches_jax_and_per_instance(refs, mp_trials):
    _, tt = mp_trials
    sweeps = MP_SWEEPS
    want = refs["mp_sweep"]
    got = texp.run_mp_sweep(tt, sweeps=sweeps, device=CPU)
    assert got.objective_hist.shape == (tt.n_trials, sweeps)
    assert got.err_hist.shape == (tt.n_trials, sweeps)
    close(got.theta_final, want["theta_final"])
    close(got.err_hist, want["err_hist"])
    close(got.objective_hist, want["objective_hist"])
    # each trial is the port's synchronous run on its own instance
    i = 0
    for seed in SEEDS:
        g, _, _, _ = mean_estimation_problem(n=N, seed=seed, device=CPU)
        for alpha in ALPHAS:
            one = synchronous(g, tt.theta_sol[i], tt.c[i], alpha, sweeps,
                              device=CPU)
            close(got.theta_final[i], one.numpy())
            i += 1
    assert np.all(np.diff(got.objective_hist, axis=1) <= 1e-5)


def test_mp_sweep_converges_to_closed_form():
    trials = texp.mean_estimation_trials(seeds=[0, 1], alphas=[0.9], n=N)
    res = texp.run_mp_sweep(trials, sweeps=800, device=CPU)
    for i, seed in enumerate([0, 1]):
        g, _, _, _ = mean_estimation_problem(n=N, seed=seed, device=CPU)
        star = closed_form(g, trials.theta_sol[i], trials.c[i], 0.9,
                           device=CPU)
        close(res.theta_final[i], star.numpy(), atol=1e-3, rtol=0)


def test_closed_form_comparison_matches_jax(refs, mp_trials):
    _, tt = mp_trials
    got = texp.closed_form_comparison(tt, device=CPU)
    for g, w in zip(got, refs["closed_form"]):
        assert g.shape == (tt.n_trials,)
        np.testing.assert_allclose(g, w, rtol=1e-3)
    e_c, e_nc, win = got
    i = 0
    for seed in SEEDS:
        g, _, targets, _ = mean_estimation_problem(n=N, seed=seed,
                                                   device=CPU)
        t = targets[:, None]
        for alpha in ALPHAS:
            with_c = closed_form(g, tt.theta_sol[i], tt.c[i], alpha,
                                 device=CPU).numpy()
            no_c = closed_form(g, tt.theta_sol[i], np.ones(g.n), alpha,
                               device=CPU).numpy()
            np.testing.assert_allclose(
                e_c[i], np.mean(np.sum((with_c - t) ** 2, -1)), rtol=1e-3)
            np.testing.assert_allclose(
                e_nc[i], np.mean(np.sum((no_c - t) ** 2, -1)), rtol=1e-3)
            i += 1
    assert win.mean() >= 0.5


JOINT_SWEEP = dict(seeds=[0, 1], alphas=[0.9], etas=[0.0, 0.3],
                   lams=[1.0], n=N)
JOINT_FIELDS = ("objective_hist", "err_hist", "intra_mass_hist",
                "theta_final", "P_final")


def test_joint_sweep_matches_jax_and_anchors_on_mp(refs):
    tt = texp.joint_mean_estimation_trials(**JOINT_SWEEP)
    want = refs["joint_sweep"]
    got = texp.run_joint_sweep(tt, sweeps=60, graph_every=5, device=CPU)
    for f in JOINT_FIELDS:
        close(getattr(got, f), want[f])
    # the eta = 0 column is the MP sweep on the same instance, bit for bit
    mp = texp.run_mp_sweep(texp.mean_estimation_trials(
        seeds=[0, 1], alphas=[0.9], n=N), sweeps=60, device=CPU)
    frozen = tt.eta == 0.0
    np.testing.assert_array_equal(got.theta_final[frozen], mp.theta_final)
    np.testing.assert_array_equal(got.objective_hist[frozen],
                                  mp.objective_hist)
    np.testing.assert_array_equal(got.P_final[frozen], tt.P[frozen])
    learned = got.P_final[~frozen]
    np.testing.assert_allclose(learned.sum(axis=-1), 1.0, atol=1e-5)
    assert (learned[~tt.adj[~frozen]] == 0).all()


ADMM_SWEEP = dict(seeds=[0, 1], mus=[0.05, 0.2], rhos=[1.0, 0.5], n=12)
ADMM_ITERS = 20


def test_admm_sweep_matches_jax_and_sync_admm(refs):
    seeds, mus, rhos, n = (ADMM_SWEEP[k] for k in ("seeds", "mus", "rhos",
                                                     "n"))
    iters = ADMM_ITERS
    tt = texp.admm_mean_estimation_trials(**ADMM_SWEEP)
    want = refs["admm_sweep"]
    got = texp.run_admm_sweep(tt, iters=iters, device=CPU)
    assert got.objective_hist.shape == (tt.n_trials, iters)
    close(got.theta_final, want["theta_final"])
    close(got.err_hist, want["err_hist"])
    np.testing.assert_allclose(got.objective_hist, want["objective_hist"],
                               rtol=1e-5)
    i = 0
    for seed in seeds:
        g, data, _, _ = mean_estimation_problem(n=n, seed=seed, device=CPU)
        for mu in mus:
            for rho in rhos:
                trc = sync_admm(g, data, mu=mu, rho=rho, loss="quadratic",
                                steps=iters, theta_sol=tt.theta_sol[i],
                                device=CPU)
                close(got.theta_final[i], trc.theta_hist[-1].numpy())
                i += 1


SCENARIO = dict(n=12, rounds=10, batch=4)


def jax_scenario_sweep():
    """The JAX side of the inexact-primal-axis sweep: its data, solitary
    models and event stream, and each cell's theta_hist."""
    rng = np.random.default_rng(0)
    n, rounds, batch = (SCENARIO[k] for k in ("n", "rounds", "batch"))
    jt = jtopo.random_geometric_topology(n, k=3, seed=0)
    xs = [rng.standard_normal((4, 2)) for _ in range(n)]
    jdata = jloss.pad_datasets(xs, [np.zeros(4)] * n)
    sol = np.asarray(jdata.x.mean(axis=1), np.float32)
    js = jsched.precompute_event_stream(
        jt.device_tables(), np.asarray(jt.partition_halves()),
        jsched.NetworkConditions(), batch, 1, rounds)
    jbase = jspec.ScenarioSpec(
        algo="cl", topology=jt, data=jdata, mu=0.4, rho=1.0,
        conditions=jsched.NetworkConditions(), rounds=rounds, batch=batch,
        seed=1, record_every=5, theta_sol=sol, stream=js)
    want = jexp.run_scenario_sweep(jbase, primal=jexp.inexact_primal_axis(
        [2, None], loss="quadratic", lr=0.2))
    return {"data": numpy_fields(jdata), "sol": sol,
            "stream": numpy_fields(js),
            "theta_hist": [np.asarray(w.theta_hist) for w in want.traces]}


def test_scenario_sweep_over_inexact_primal_axis_matches_jax(refs):
    """A ``primal=`` axis over inner-step budgets on JAX's stream: each
    cell within 1e-5 of its JAX twin; the b_steps=None column is the
    exact-engine anchor, b_steps=2 is really inexact."""
    n, rounds, batch = (SCENARIO[k] for k in ("n", "rounds", "batch"))
    tt = ttopo.random_geometric_topology(n, k=3, seed=0)
    want = refs["scenario"]
    sol = want["sol"]
    base = ScenarioSpec(
        algo="cl", topology=tt,
        data=convert.data_from_arrays(want["data"], CPU),
        mu=0.4, rho=1.0, conditions=NetworkConditions(), rounds=rounds,
        batch=batch, seed=1, record_every=5, theta_sol=sol,
        stream=convert.stream_from_arrays(want["stream"], CPU), device=CPU)
    axis = texp.inexact_primal_axis([2, None], loss="quadratic", lr=0.2)
    got = texp.run_scenario_sweep(base, primal=axis)
    assert got.n_trials == 2 and got.cells[0]["primal"].b_steps == 2
    assert [s.primal for s in got.specs] == list(axis)
    for g, w in zip(got.traces, want["theta_hist"]):
        close(g.theta_hist.numpy(), w, atol=1e-5, rtol=0)
    exact = run_scenario(base)
    err_b2 = (got.traces[0].theta_hist - exact.theta_hist).abs().max()
    err_inf = (got.traces[1].theta_hist - exact.theta_hist).abs().max()
    assert err_inf <= 1e-5 < err_b2
    with pytest.raises(ValueError, match="no field"):
        texp.run_scenario_sweep(base, bogus=[1])


def test_sweep_runners_default_to_cuda(monkeypatch):
    """Without CUDA, device=None raises — never a silent CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mp = texp.mean_estimation_trials(seeds=[0], alphas=[0.9], n=8)
    jt = texp.joint_mean_estimation_trials(seeds=[0], alphas=[0.9],
                                           etas=[0.3], n=8)
    at = texp.admm_mean_estimation_trials(seeds=[0], mus=[0.1], rhos=[1.0],
                                          n=8)
    for call in (lambda: texp.run_mp_sweep(mp, sweeps=2),
                 lambda: texp.closed_form_comparison(mp),
                 lambda: texp.run_joint_sweep(jt, sweeps=2),
                 lambda: texp.run_admm_sweep(at, iters=2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ---------------------------------------------------------------------------
# the JAX side, in a subprocess of its own
# ---------------------------------------------------------------------------


def jax_references():
    """JAX's trials and sweeps for every comparison of this module."""
    jt = jexp.mean_estimation_trials(seeds=SEEDS, alphas=ALPHAS, n=N)
    return {
        "mp_trials": numpy_fields(jt),
        "trials": {noises: numpy_fields(jexp.mean_estimation_trials(
            **mp_trials_kw(noises))) for noises in NOISES},
        "admm_trials": numpy_fields(
            jexp.admm_mean_estimation_trials(**ADMM_TRIALS)),
        "joint_trials": numpy_fields(
            jexp.joint_mean_estimation_trials(**JOINT_TRIALS)),
        "mp_sweep": result_fields(jexp.run_mp_sweep(jt, sweeps=MP_SWEEPS),
                                  SWEEP_FIELDS),
        "closed_form": [np.asarray(w)
                        for w in jexp.closed_form_comparison(jt)],
        "joint_sweep": result_fields(jexp.run_joint_sweep(
            jexp.joint_mean_estimation_trials(**JOINT_SWEEP), sweeps=60,
            graph_every=5), JOINT_FIELDS),
        "admm_sweep": result_fields(jexp.run_admm_sweep(
            jexp.admm_mean_estimation_trials(**ADMM_SWEEP),
            iters=ADMM_ITERS), SWEEP_FIELDS),
        "scenario": jax_scenario_sweep()}


refs = _port_session.reference_fixture(__name__)
