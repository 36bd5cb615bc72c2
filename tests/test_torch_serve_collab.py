"""The port's gossip-backed personalization service on the CPU against the
JAX package (DESIGN.md §16).

* ``precompute_serve_stream`` and ``serve_chunk_requests``: JAX's draws
  and chunks, exactly;
* ``run_scenario(ScenarioSpec(serve=...))`` for mp, cl and joint on JAX's
  event stream (``convert.stream_from_arrays``): the ``ServeReport``'s
  counters, per-chunk columns and every served staleness exactly equal
  to JAX's ``_drive_serve``; ``theta_hist`` bit for bit the serve-free
  run's; the telemetry frames' ``serve_*`` columns equal to JAX's;
* ``CollabServeEngine.serve`` on one committed state: predictions within
  1e-5 of JAX's (float32 row sums of values up to ~50 in another order),
  staleness and the cache's counters exactly;
* the store's snapshots never torn; ``ShardedAgentStateStore`` reading
  what ``AgentStateStore`` reads, bit for bit; a sharded ``serve=`` run
  reporting what the single-device run reports.

The JAX side of every comparison runs in a subprocess of its own beside
the tests before this module (``jax_references``; tests/_port_session.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro import simulate as jsim  # noqa: E402
from repro import telemetry as jtel  # noqa: E402
from repro.core.losses import AgentData as JAgentData  # noqa: E402

import _port_session  # noqa: E402
from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from _port_session import port_background_jobs  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch.core.losses import pad_datasets, solitary_mean  # noqa: E402
from repro_torch.serve import (AgentStateStore,  # noqa: E402
                               CollabServeEngine, ShardedAgentStateStore)
from repro_torch.simulate import (NetworkConditions,  # noqa: E402
                                  ScenarioSpec, precompute_serve_stream,
                                  random_geometric_topology, run_scenario,
                                  serve_chunk_requests)
from repro_torch.telemetry import TelemetryConfig  # noqa: E402

CPU = "cpu"
N, P, SEED = 80, 3, 7
RUN = dict(rounds=60, batch=8, seed=SEED, record_every=10)
COND = dict(drop_prob=0.2, churn_rate=0.01, stale_prob=0.2)
LEARN_KW = dict(eta_graph=0.3, lam=1.0, graph_every=5, prune_eps=1e-3)
REPORT = ("requests", "hits", "misses", "invalidations")
COLUMNS = ("requests_c", "hits_c", "misses_c", "invalidations_c",
           "served_staleness")


def problem_arrays():
    """The port's topology and the problem's numpy and port arrays (the
    JAX specs take the same arrays)."""
    tt = random_geometric_topology(N, k=4, seed=0)
    rng = np.random.default_rng(0)
    sol = rng.standard_normal((N, P)).astype(np.float32)
    c = np.full(N, 0.8, np.float32)
    xs = [rng.standard_normal((int(rng.integers(1, 5)), P))
          for _ in range(N)]
    data = pad_datasets(xs, [np.zeros(len(x)) for x in xs], device=CPU)
    return dict(tt=tt, sol=sol, c=c, data=data,
                cl_sol=solitary_mean(data).numpy(),
                serve=precompute_serve_stream(N, RUN["rounds"], rate=6.0,
                                              seed=5))


@pytest.fixture(scope="module")
def problem(refs):
    """``problem_arrays`` and JAX's event stream, carried across."""
    return dict(problem_arrays(),
                ts=convert.stream_from_arrays(refs["stream"], CPU))


def payloads(pb, algo):
    """(JAX payload, port payload) of one algo."""
    payload = dict(theta_sol=pb["sol"], c=pb["c"], alpha=0.9)
    tpay = dict(payload)
    if algo == "cl":
        d = pb["data"]
        jdata = JAgentData(*(jnp.asarray(getattr(d, f).numpy())
                             for f in ("x", "y", "mask")))
        payload = dict(data=jdata, mu=0.1, rho=1.0, theta_sol=pb["cl_sol"])
        tpay = dict(data=d, mu=0.1, rho=1.0, theta_sol=pb["cl_sol"])
    elif algo == "joint":
        payload.update(LEARN_KW)
        tpay.update(LEARN_KW)
    return payload, tpay


def jax_spec(pb, jt, js, algo, **kw):
    """JAX's spec of one algo on its stream (mp draws inline)."""
    jstream = {} if algo == "mp" else dict(stream=js)
    jkw = {k: v for k, v in kw.items() if k != "telemetry"}
    if "telemetry" in kw:
        jkw["telemetry"] = jtel.TelemetryConfig(enabled=True)
    return jsim.ScenarioSpec(algo=algo, topology=jt,
                             conditions=jsim.NetworkConditions(**COND),
                             **RUN, **payloads(pb, algo)[0], **jstream,
                             **jkw)


def port_spec(pb, algo, **kw):
    """The port's spec of one algo on JAX's stream."""
    return ScenarioSpec(algo=algo, topology=pb["tt"],
                        conditions=NetworkConditions(**COND), **RUN,
                        **payloads(pb, algo)[1], stream=pb["ts"],
                        device=CPU, **kw)


SERVE_STREAMS = ((40, 3.0, 0), (60, 2.5, 5), (7, 0.4, 1))


def test_serve_stream_and_chunks_match_jax(refs):
    for case in SERVE_STREAMS:
        got = precompute_serve_stream(N, *case)
        n_requests, users, rounds, chunks = refs["serve_streams"][case]
        assert got.n_requests == n_requests
        for f, w in (("user", users), ("round", rounds)):
            np.testing.assert_array_equal(getattr(got, f), w)
            assert getattr(got, f).dtype == np.int32
        for (gu, gr), (wu, wr) in zip(serve_chunk_requests(got, 4, 10),
                                      chunks):
            np.testing.assert_array_equal(gu, wu)
            np.testing.assert_array_equal(gr, wr)
    with pytest.raises(ValueError):
        precompute_serve_stream(N, 0, 1.0)


ALGOS = ["mp", "cl", "joint"]


@pytest.mark.parametrize("algo", ALGOS)
def test_service_matches_jax_and_leaves_the_run_untouched(refs, problem,
                                                          algo):
    want = refs["serve"][algo]
    got_trace = run_scenario(port_spec(problem, algo, serve=problem["serve"],
                                       serve_batch=16))
    got = got_trace.serve
    for f in REPORT:
        assert getattr(got, f) == getattr(want, f), f
    for f in COLUMNS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.served_staleness.dtype == np.int32
    assert got.summary() == want.summary()
    assert got.hits > 0 and got.misses > 0 and got.invalidations > 0
    plain = run_scenario(port_spec(problem, algo))
    assert plain.serve is None
    assert torch.equal(got_trace.theta_hist, plain.theta_hist)


def test_serve_counters_reach_the_frames_as_in_jax(refs, problem):
    want = refs["telemetry"]
    tr = run_scenario(port_spec(problem, "mp", serve=problem["serve"],
                                telemetry=TelemetryConfig(enabled=True)))
    got = tr.telemetry
    for f in ("serve_requests", "serve_hits", "serve_misses",
              "serve_invalidations"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.serve_requests[-1] == tr.serve.requests
    rows, wrows = got.summarize(), want.summarize()
    assert [r["serve_hits"] for r in rows] == \
        [r["serve_hits"] for r in wrows]


def engine_inputs():
    rng = np.random.default_rng(3)
    theta = rng.standard_normal((N, P)).astype(np.float32)
    stale = rng.integers(0, 9, N).astype(np.int32)
    dirty = rng.random(N) < 0.3
    users = rng.integers(0, N, 300)
    x = rng.standard_normal((300, P)).astype(np.float32)
    return theta, stale, dirty, users, x


def jax_engine():
    """JAX's engine over three commits and serves: each commit's return,
    each serve's predictions and staleness and the cache's counters, and
    the report's summary."""
    theta, stale, dirty, users, x = engine_inputs()
    j = jserve.CollabServeEngine(jserve.AgentStateStore(N, P), N, P,
                                 batch_size=64)
    steps = []
    for rnd, xx in ((10, None), (20, x), (30, None)):
        commit = j.commit(rnd, theta + rnd, stale + rnd % 3, dirty)
        wp, ws = j.serve(users, xx)
        steps.append((commit, np.asarray(wp), np.asarray(ws),
                      (j.cache.hits, j.cache.misses, j.cache.invalidations)))
    return steps, j.report().summary()


def test_engine_predictions_and_cache_match_jax(refs):
    theta, stale, dirty, users, x = engine_inputs()
    t = CollabServeEngine(AgentStateStore(N, P, device=CPU), N, P,
                          batch_size=64)
    steps, summary = refs["engine"]
    for (rnd, xx), (commit, wp, ws, counters) in zip(
            ((10, None), (20, x), (30, None)), steps):
        assert t.commit(rnd, theta + rnd, stale + rnd % 3, dirty) == commit
        gp, gs = t.serve(users, xx)
        np.testing.assert_allclose(gp, wp, rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(gs, ws)
        assert (t.cache.hits, t.cache.misses, t.cache.invalidations) == \
            counters
    assert t.report().summary() == summary


def test_store_reads_one_snapshot_and_sharding_waits():
    store = AgentStateStore(4, 2, device=CPU)
    store.commit(3, np.ones((4, 2)), np.arange(4))
    snap = store.snapshot()
    store.commit(4, np.zeros((4, 2)), np.zeros(4))
    assert snap.round == 3 and bool((snap.theta == 1).all())
    got = store.read_rows([2, 0, 2])
    assert got.round == 4 and got.staleness.tolist() == [0, 0, 0]
    assert store.commits == 2
    with pytest.raises(ValueError, match="commit shape"):
        store.commit(5, np.zeros((3, 2)), np.zeros(3))
    # the per-shard stores behind the read router answer as the one store
    from repro_torch.simulate import greedy_partition
    from repro_torch.simulate.partition import GraphPartition
    topo = random_geometric_topology(N, k=4, seed=1)
    part = GraphPartition.build(topo, greedy_partition(topo, 4), 4)
    one = AgentStateStore(N, P, device=CPU)
    sharded = ShardedAgentStateStore(part.owner, part.local_pos, P, 4,
                                     device=CPU)
    rng = np.random.default_rng(3)
    for rnd in (5, 9):
        theta = rng.standard_normal((N, P)).astype(np.float32)
        stale = rng.integers(0, 30, N).astype(np.int32)
        one.commit(rnd, theta, stale)
        sharded.commit(rnd, torch.as_tensor(theta), stale)
        users = rng.integers(0, N, 50)
        want, got = one.read_rows(users), sharded.read_rows(users)
        assert got.round == want.round == sharded.snapshot_round() == rnd
        assert torch.equal(got.theta, want.theta)
        assert torch.equal(got.staleness, want.staleness)
    assert sharded.shard_size == part.shard_size


@pytest.mark.parametrize("algo", ["mp", "cl"])
def test_sharded_serve_spec_equals_the_unsharded_report(algo):
    """``ScenarioSpec(serve=..., sharded=True)`` on a LocalMesh of 4
    shards: theta_hist and the ServeReport (counters, per-chunk columns,
    every served staleness) equal the single-device run's."""
    from repro_torch.launch import LocalMesh
    topo = random_geometric_topology(N, k=4, seed=1)
    rng = np.random.default_rng(0)
    kw = dict(algo=algo, topology=topo, conditions=NetworkConditions(**COND),
              serve=precompute_serve_stream(N, RUN["rounds"], rate=7,
                                            seed=1), serve_batch=16,
              device=CPU, **RUN)
    if algo == "cl":
        data = pad_datasets(list(rng.standard_normal((N, 3, P))),
                            device=CPU)
        kw.update(data=data, mu=0.1, rho=1.0, theta_sol=solitary_mean(data))
    else:
        kw.update(theta_sol=rng.standard_normal((N, P)).astype(np.float32),
                  c=rng.uniform(0.1, 1.0, N).astype(np.float32), alpha=0.9)
    one = run_scenario(ScenarioSpec(**kw))
    sh = run_scenario(ScenarioSpec(**kw, sharded=True,
                                   mesh=LocalMesh(4, CPU)))
    assert sh.overflow == 0 and sh.n_shards == 4
    assert torch.equal(sh.theta_hist, one.theta_hist)
    for f in REPORT:
        assert getattr(sh.serve, f) == getattr(one.serve, f)
    for f in COLUMNS:
        np.testing.assert_array_equal(getattr(sh.serve, f),
                                      getattr(one.serve, f))


# ---------------------------------------------------------------------------
# the JAX side, in a subprocess of its own
# ---------------------------------------------------------------------------


def jax_references():
    """JAX's event stream, serve streams, service reports, telemetry and
    engine for every comparison of this module."""
    pb = problem_arrays()
    jt = jsim.random_geometric_topology(N, k=4, seed=0)
    js = jsim.precompute_event_stream(
        jt.device_tables(), jnp.asarray(jt.partition_halves()),
        jsim.NetworkConditions(**COND), RUN["batch"], SEED, RUN["rounds"])
    streams = {}
    for case in SERVE_STREAMS:
        want = jsim.precompute_serve_stream(N, *case)
        streams[case] = (want.n_requests, np.asarray(want.user),
                         np.asarray(want.round),
                         [(np.asarray(u), np.asarray(r)) for u, r in
                          jsim.serve_chunk_requests(want, 4, 10)])
    return {
        "stream": js._replace(**{f: np.asarray(getattr(js, f))
                                 for f in js._fields}),
        "serve_streams": streams,
        "serve": {algo: jsim.run_scenario(jax_spec(
            pb, jt, js, algo, serve=pb["serve"], serve_batch=16)).serve
            for algo in ALGOS},
        "telemetry": jsim.run_scenario(jax_spec(
            pb, jt, js, "mp", serve=pb["serve"], telemetry=True)).telemetry,
        "engine": jax_engine()}


refs = _port_session.reference_fixture(__name__)
