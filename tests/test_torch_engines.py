"""The port's MP engines against the JAX package on the same inputs.

``sparse_sync_mp`` within 1e-5.  ``run_scenario(algo="mp")`` under the
five named fault scenarios, with both round bodies (per-op and fused
``round_step``), replaying the JAX run's own events: the stream comes
from ``repro.simulate.scheduler.precompute_event_stream``, which
reproduces the inline engine's key schedule, carried across by
``repro_torch.convert.stream_from_arrays``.  Counters and ``active_hist``
match exactly and ``theta_hist`` within 1e-5 (the bar of
tests/test_round_fuse.py).  The port's own torch-drawn stream keeps the
accounting invariant, and the sharding fields (with their knobs, and with
serving) run the partitioned runners bit for bit with the single-device
engines.  The JAX runs and their streams come from a subprocess of their
own that starts beside the tests before this module (``jax_references``;
tests/_port_session.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.dispatch import ReproBackend as JaxBackend  # noqa: E402
from repro.simulate import engines as jeng  # noqa: E402
from repro.simulate import scheduler as jsched  # noqa: E402
from repro.simulate import spec as jspec  # noqa: E402
from repro.simulate import topology as jtopo  # noqa: E402

import _port_session  # noqa: E402
from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from _port_session import port_background_jobs  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.simulate import (ScenarioSpec, get_scenario,  # noqa: E402
                                  list_scenarios, run_scenario,
                                  sparse_sync_mp, stream_totals)
from repro_torch.simulate import topology as ttopo  # noqa: E402

CPU = "cpu"
N, P, ROUNDS, BATCH, RECORD, SEED = 300, 8, 30, 40, 10, 7


@pytest.fixture(scope="module")
def setup():
    """JAX and port topologies, and the numpy solitary models and
    confidences (the port's runs take them as carried across by
    ``convert.models_from_arrays``)."""
    jt = jtopo.random_geometric_topology(N, k=5, seed=0)
    tt = ttopo.random_geometric_topology(N, k=5, seed=0)
    rng = np.random.default_rng(0)
    sol = rng.standard_normal((N, P)).astype(np.float32)
    c = rng.uniform(0.05, 1.0, N).astype(np.float32)
    return jt, tt, sol, c


def port(sol, c):
    return convert.models_from_arrays(jnp.asarray(sol), jnp.asarray(c), CPU)


def jax_stream(jt, cond):
    return jsched.precompute_event_stream(
        jt.device_tables(), jnp.asarray(jt.partition_halves()), cond, BATCH,
        SEED, ROUNDS)


def trace_fields(tr):
    """A JAX trace's counters and histories, as numpy."""
    return {k: np.asarray(getattr(tr, k)) for k in (
        "delivered", "dropped", "invalid", "rounds", "events",
        "active_hist", "theta_hist")}


def jax_problem():
    jt = jtopo.random_geometric_topology(N, k=5, seed=0)
    rng = np.random.default_rng(0)
    sol = rng.standard_normal((N, P)).astype(np.float32)
    c = rng.uniform(0.05, 1.0, N).astype(np.float32)
    return jt, sol, c


def jax_scenario(scenario, jt, sol, c, **kw):
    """JAX's ``run_scenario(algo="mp")`` under ``scenario`` and the stream
    of its events (``kw``: a JAX backend)."""
    cond_j = jsched.NetworkConditions(**vars(
        get_scenario(scenario).make_conditions(ROUNDS)))
    want = jspec.run_scenario(jspec.ScenarioSpec(
        algo="mp", topology=jt, conditions=cond_j, rounds=ROUNDS,
        batch=BATCH, seed=SEED, record_every=RECORD, theta_sol=sol, c=c,
        alpha=0.9, **kw))
    stream = jax_stream(jt, cond_j)
    return {"trace": trace_fields(want),
            "stream": jax.tree_util.tree_map(np.asarray, stream)}


def jax_references():
    """The JAX side of the tests against JAX (run in a subprocess of its
    own beside the tests before this module: tests/_port_session.py)."""
    jt, sol, c = jax_problem()
    return {"sync": np.asarray(jeng.sparse_sync_mp(jt, sol, c, 0.9,
                                                   sweeps=12)),
            "scenarios": {name: jax_scenario(name, jt, sol, c)
                          for name in list_scenarios()},
            "fused": jax_scenario("lossy-10", jt, sol, c,
                                  backend=JaxBackend.using(
                                      round_step="xla"))}


refs = _port_session.reference_fixture(__name__)


def test_sparse_sync_mp_matches_jax(setup, refs):
    jt, tt, sol, c = setup
    got = sparse_sync_mp(tt, sol, c, 0.9, 12, device=CPU).numpy()
    np.testing.assert_allclose(got, refs["sync"], atol=1e-5, rtol=0)


def assert_trace_matches(got, want):
    assert (got.delivered, got.dropped, got.invalid, got.rounds,
            got.events) == tuple(int(want[k]) for k in (
                "delivered", "dropped", "invalid", "rounds", "events"))
    np.testing.assert_array_equal(got.active_hist.numpy(),
                                  want["active_hist"])
    np.testing.assert_allclose(got.theta_hist.numpy(), want["theta_hist"],
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("scenario", list_scenarios())
def test_run_scenario_matches_jax(setup, refs, scenario):
    """Per-op and fused bodies replay the JAX run's events: counters
    exact, trajectory within 1e-5 of the JAX per-op run."""
    jt, tt, sol, c = setup
    want = refs["scenarios"][scenario]
    stream = convert.stream_from_arrays(want["stream"], CPU)
    cond = get_scenario(scenario).make_conditions(ROUNDS)
    sol_t, c_t = port(sol, c)
    for backend in (None, dispatch.ReproBackend()):
        got = run_scenario(ScenarioSpec(
            algo="mp", topology=tt, conditions=cond, rounds=ROUNDS,
            batch=BATCH, record_every=RECORD, theta_sol=sol_t, c=c_t,
            alpha=0.9, stream=stream, backend=backend, device=CPU))
        assert_trace_matches(got, want["trace"])


def test_fused_kernel_algorithm_drives_the_engine(setup, refs):
    """The fused body run through the reference round_step (the CUDA
    kernel's algorithm, in place) matches the JAX fused-XLA run."""
    jt, tt, sol, c = setup
    cond = get_scenario("lossy-10").make_conditions(ROUNDS)
    want = refs["fused"]
    got = run_scenario(ScenarioSpec(
        algo="mp", topology=tt, conditions=cond, rounds=ROUNDS, batch=BATCH,
        record_every=RECORD, theta_sol=sol, c=c, alpha=0.9,
        stream=convert.stream_from_arrays(want["stream"], CPU),
        backend=dispatch.ReproBackend(), device=CPU))
    assert_trace_matches(got, want["trace"])


@pytest.mark.parametrize("scenario", ["straggler-tail", "churn-5",
                                      "partition-heal"])
def test_torch_stream_accounting_invariant(setup, scenario):
    """The port's own torch-drawn stream: delivered + dropped ==
    2 (events - invalid), per-op and fused agree, same seed replays."""
    _, tt, sol, c = setup
    cond = get_scenario(scenario).make_conditions(ROUNDS)
    if scenario == "churn-5":
        cond = type(cond)(churn_rate=0.05)        # churn visible in 30 rounds
    kw = dict(algo="mp", topology=tt, conditions=cond, rounds=ROUNDS,
              batch=BATCH, seed=3, record_every=RECORD, theta_sol=sol, c=c,
              alpha=0.9, device=CPU)
    per_op = run_scenario(ScenarioSpec(**kw))
    fused = run_scenario(ScenarioSpec(**kw, backend=dispatch.ReproBackend()))
    again = run_scenario(ScenarioSpec(**kw))
    for tr in (per_op, fused):
        assert tr.delivered + tr.dropped == 2 * (tr.events - tr.invalid)
        assert tr.delivered > 0
    assert (fused.delivered, fused.dropped, fused.invalid) == \
        (per_op.delivered, per_op.dropped, per_op.invalid)
    np.testing.assert_allclose(fused.theta_hist.numpy(),
                               per_op.theta_hist.numpy(), atol=1e-5, rtol=0)
    assert torch.equal(again.theta_hist, per_op.theta_hist)
    if scenario == "churn-5":
        assert (per_op.active_hist < 1.0).any()


def test_stream_totals_invariant(setup):
    from repro_torch.simulate import precompute_event_stream
    _, tt, _, _ = setup
    cond = get_scenario("lossy-10").make_conditions(ROUNDS)
    s = precompute_event_stream(tt.device_tables(CPU),
                                torch.as_tensor(tt.partition_halves()),
                                cond, BATCH, seed=1, rounds=ROUNDS,
                                device=CPU)
    delivered, dropped, invalid = stream_totals(s)
    assert delivered + dropped == 2 * (ROUNDS * BATCH - invalid)
    assert s.i.dtype == torch.int32 and s.deliver_ij.dtype == torch.bool


SHARDED_CASES = [
    ("mp", dict(sharded=True)),
    ("mp", dict(serve="requests", sharded=True)),
    ("mp", dict(sharded=True, n_shards=4, exchange="ring")),
    ("cl", dict(sharded=True, mesh="local-2", local_batch=8)),
    ("joint", dict(sharded=True, recompact_every=5, recompact_frac=0.5,
                   eta_graph=0.3)),
    ("joint", dict(serve="requests", serve_batch=8, sharded=True)),
]


@pytest.mark.parametrize(
    "algo,fields", SHARDED_CASES,
    ids=[f"{a}-fields{q}-item 10" for q, (a, _) in enumerate(SHARDED_CASES)])
def test_unported_spec_fields_raise(setup, algo, fields):
    """The sharding fields (with their knobs, and with a serve stream,
    which the sharded store serves) run the partitioned runners, which
    these fields once refused: the runs equal the single-device ones bit
    for bit (per-op MP, CL, joint), serving reports equal the unsharded
    report, and a CL run whose update buffer is too small counts its
    overflow.  (The case ids are the names the refusals had.)"""
    from repro_torch.core.losses import pad_datasets, solitary_mean
    from repro_torch.launch import LocalMesh
    from repro_torch.simulate import precompute_serve_stream
    _, tt, sol, c = setup
    fields = dict(fields)
    kw = dict(algo=algo, topology=tt, conditions=get_scenario(
        "lossy-10").make_conditions(ROUNDS), rounds=ROUNDS, batch=BATCH,
        theta_sol=sol, c=c, device=CPU)
    if fields.get("serve") == "requests":
        fields["serve"] = precompute_serve_stream(N, ROUNDS, rate=50, seed=2)
    if fields.get("mesh") == "local-2":
        fields["mesh"] = LocalMesh(2, CPU)
    if algo == "cl":
        rng = np.random.default_rng(4)
        data = pad_datasets(list(rng.standard_normal((N, 3, P))),
                            device=CPU)
        kw.update(c=None, data=data, mu=0.1, rho=1.0,
                  theta_sol=solitary_mean(data))
    one = run_scenario(ScenarioSpec(**kw, **{
        k: v for k, v in fields.items()
        if k in ("serve", "serve_batch", "eta_graph")}))
    sh = run_scenario(ScenarioSpec(**kw, **fields))
    assert (sh.delivered, sh.dropped, sh.invalid, sh.events) == \
        (one.delivered, one.dropped, one.invalid, one.events)
    if "local_batch" in fields:
        assert sh.overflow > 0 and torch.isfinite(sh.theta_hist).all()
        return
    assert sh.overflow == 0
    assert sh.n_shards == fields.get("n_shards", 1)
    assert torch.equal(sh.theta_hist, one.theta_hist)
    if algo == "joint":
        assert torch.equal(sh.final_w, one.final_w)
        assert torch.equal(sh.final_live, one.final_live)
    if "serve" in fields:
        assert sh.serve.summary() == one.serve.summary()
        np.testing.assert_array_equal(sh.serve.served_staleness,
                                      one.serve.served_staleness)
