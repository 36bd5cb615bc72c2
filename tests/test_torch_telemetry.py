"""The port's run telemetry (``repro_torch.telemetry`` and the engines'
``telemetry=``) against the JAX package on the same event stream.

* The row-local metric expressions and the stream reductions equal JAX's
  (reductions and integer counters exactly, float32 expressions within
  1e-6 relative).
* ``run_scenario(..., telemetry=TelemetryConfig(enabled=True))`` for MP
  (per-op and fused bodies), CL (exact, and the inexact primal with an
  MLP agent) and joint learning (with prune), replaying JAX's draws
  (``convert.stream_from_arrays``): counters and staleness exactly equal
  to JAX's frames, the objective within 1e-5 relative.  Joint staleness
  counts the admitted deliveries only, so it is held against JAX's
  in-scan counters, never against a stream replay.
* Telemetry only observes: ``theta_hist`` is bit-identical with it off,
  on and absent, and it attaches frames only when on.
* Summary rows of identical vectors are identical; the manifest carries
  JAX's keys with torch's versions and the device in place of jax's; a
  run directory the port writes loads in the JAX package, and the
  reverse.

The JAX runs behind the frame tests come from a subprocess of their own
that starts beside the tests before this module (``jax_references``;
tests/_port_session.py).
"""

import dataclasses
import json
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import primal as jprimal  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.kernels.dispatch import ReproBackend as JaxBackend  # noqa: E402
from repro.models import flatten as jflat  # noqa: E402
from repro.simulate import engines as jeng  # noqa: E402
from repro.simulate import scheduler as jsched  # noqa: E402
from repro.simulate import topology as jtopo  # noqa: E402
from repro import telemetry as jtel  # noqa: E402
from repro.telemetry import metrics as jmet  # noqa: E402

import _port_session  # noqa: E402
from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from _port_session import port_background_jobs  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch import telemetry as ttel  # noqa: E402
from repro_torch.core.losses import pad_datasets, solitary_mean  # noqa: E402
from repro_torch.core.primal import InexactPrimal  # noqa: E402
from repro_torch.data import federated_moons_problem  # noqa: E402
from repro_torch.data.synthetic import two_cluster_mean_problem  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import MLPAgent  # noqa: E402
from repro_torch.simulate import (NetworkConditions,  # noqa: E402
                                  ScenarioSpec, run_scenario)
from repro_torch.simulate import engines as teng  # noqa: E402
from repro_torch.simulate import topology as ttopo  # noqa: E402
from repro_torch.telemetry import TelemetryConfig  # noqa: E402
from repro_torch.telemetry import metrics as tmet  # noqa: E402

CPU = "cpu"
N, P, ROUNDS, BATCH, RECORD, SEED = 60, 4, 40, 12, 10, 3
#: every fault mechanism active, so all three drop causes accumulate
FAULTY = NetworkConditions(drop_prob=0.1, stale_prob=0.3, churn_rate=0.01,
                           straggler_frac=0.3, partition_start=5,
                           partition_end=20)
ON, OFF = TelemetryConfig(enabled=True), TelemetryConfig(enabled=False)
J_ON = jtel.TelemetryConfig(enabled=True)
COUNTERS = ("updates", "delivered", "drop_link", "drop_churn",
            "drop_partition", "invalid")
LEARN_KW = dict(eta_graph=0.3, lam=1.0, graph_every=5, prune_eps=1e-3)


def jax_cond(cond):
    return jsched.NetworkConditions(**vars(cond))


def jax_stream(jt, cond, batch=BATCH, seed=SEED, rounds=ROUNDS):
    return jsched.precompute_event_stream(
        jt.device_tables(), jnp.asarray(jt.partition_halves()),
        jax_cond(cond), batch, seed, rounds)


def problem_arrays():
    """Both packages' topology, the numpy models and the port's CL data
    (on the CPU, as JAX takes it)."""
    jt = jtopo.random_geometric_topology(N, k=4, seed=0)
    tt = ttopo.random_geometric_topology(N, k=4, seed=0)
    rng = np.random.default_rng(0)
    sol = rng.standard_normal((N, P)).astype(np.float32)
    c = rng.uniform(0.05, 1.0, N).astype(np.float32)
    xs = [rng.standard_normal((int(rng.integers(1, 6)), P))
          for _ in range(N)]
    data = pad_datasets(xs, [np.zeros(len(x)) for x in xs], device=CPU)
    return dict(jt=jt, tt=tt, sol=sol, c=c, data=data,
                cl_sol=solitary_mean(data).numpy())


@pytest.fixture(scope="module")
def problem(refs):
    """:func:`problem_arrays`, and the port's copy of JAX's faulty stream
    (``jax_references``)."""
    return dict(problem_arrays(),
                ts=convert.stream_from_arrays(refs["stream"], CPU))


FRAME_FIELDS = ("rounds",) + COUNTERS + ("staleness", "objective",
                                         "suppressed")


def frame_fields(frames):
    """JAX telemetry frames as a namespace of numpy arrays."""
    return {k: None if getattr(frames, k) is None
            else np.asarray(getattr(frames, k)) for k in FRAME_FIELDS}


def frames(fields):
    return types.SimpleNamespace(**fields)


def jax_mp_frames(pb, body):
    jb = None if body == "per-op" else JaxBackend.using(round_step="xla")
    want = jeng.run_mp_scenario(pb["jt"], pb["sol"], pb["c"], 0.9,
                                jax_cond(FAULTY), ROUNDS, BATCH, seed=SEED,
                                record_every=RECORD, telemetry=J_ON,
                                backend=jb)
    return {"counts": (want.delivered, want.dropped, want.invalid),
            "frames": frame_fields(want.telemetry)}


def jax_cl_exact_frames(pb):
    want = jeng.run_cl_scenario(
        pb["jt"], pb["data"], 0.1, 1.0, jax_cond(FAULTY), ROUNDS,
        BATCH, record_every=RECORD, theta_sol=pb["cl_sol"],
        stream=jax_stream(pb["jt"], FAULTY), telemetry=J_ON)
    return frame_fields(want.telemetry)


def mp_spec(pb, **kw):
    return ScenarioSpec(algo="mp", topology=pb["tt"], conditions=FAULTY,
                        rounds=ROUNDS, batch=BATCH, record_every=RECORD,
                        theta_sol=pb["sol"], c=pb["c"], alpha=0.9,
                        stream=pb["ts"], device=CPU, **kw)


def cl_spec(pb, **kw):
    return ScenarioSpec(algo="cl", topology=pb["tt"], conditions=FAULTY,
                        rounds=ROUNDS, batch=BATCH, record_every=RECORD,
                        data=pb["data"], mu=0.1, rho=1.0,
                        theta_sol=pb["cl_sol"], stream=pb["ts"], device=CPU,
                        **kw)


def assert_frames_match(got, want):
    """Counters and staleness exactly, the objective within 1e-5 relative
    to the chunk's largest agent objective."""
    assert got is not None and want is not None
    np.testing.assert_array_equal(got.rounds, want.rounds)
    for f in COUNTERS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
        assert getattr(got, f).dtype == np.int64
    np.testing.assert_array_equal(got.staleness, want.staleness)
    assert got.staleness.dtype == np.int32
    obj, ref = got.objective, np.asarray(want.objective)
    assert obj.shape == ref.shape and obj.dtype == np.float32
    scale = np.abs(ref).max(axis=1, keepdims=True)
    assert (np.abs(obj - ref) <= 1e-5 * scale).all()


def jax_references():
    """The JAX side of the frame tests (run in a subprocess of its own
    beside the tests before this module: tests/_port_session.py)."""
    pb = problem_arrays()
    js = jax_stream(pb["jt"], FAULTY)
    return {"mp": {body: jax_mp_frames(pb, body)
                   for body in ("per-op", "fused")},
            "cl_exact": jax_cl_exact_frames(pb),
            "cl_inexact": jax_cl_inexact(), "joint": jax_joint(),
            "stream": js._replace(**{f: np.asarray(getattr(js, f))
                                     for f in js._fields}),
            "reductions": jax_stream_reductions(js),
            "row_local": jax_row_local()}


refs = _port_session.reference_fixture(__name__)


def assert_invariants(tr):
    f = tr.telemetry
    assert int(f.delivered[-1]) == tr.delivered
    assert int(f.invalid[-1]) == tr.invalid
    drops = f.drop_link + f.drop_churn + f.drop_partition
    assert int(drops[-1]) == tr.dropped
    for col in (f.delivered, drops, f.invalid, f.updates):
        assert np.all(np.diff(col) >= 0)


# ---------------------------------------------------------------------------
# the metric expressions and the stream reductions
# ---------------------------------------------------------------------------


def row_local_inputs():
    rng = np.random.default_rng(1)
    R, k, p = 33, 5, 3
    theta, sol, sx = (rng.standard_normal((R, p)).astype(np.float32)
                      for _ in range(3))
    K = rng.standard_normal((R, k, p)).astype(np.float32)
    w = rng.uniform(size=(R, k)).astype(np.float32)
    live = rng.uniform(size=(R, k)) < 0.7
    c, D, m, sxx, lv = (rng.uniform(0.1, 3.0, R).astype(np.float32)
                        for _ in range(5))
    stale = rng.integers(0, 9, R).astype(np.int32)
    rows = rng.integers(0, R, 40).astype(np.int32)
    got = rng.uniform(size=40) < 0.5
    flags = [rng.uniform(size=50) < q for q in (0.7, 0.7, 0.9, 0.3, 0.3)]
    return (R, theta, sol, sx, K, w, live, c, D, m, sxx, lv, stale, rows,
            got, flags)


def row_local_metrics(mod, arr):
    """``mod``'s (the port's or JAX's metrics module) three local
    objectives, staleness step and drop causes on ``row_local_inputs``,
    its arrays made by ``arr``."""
    (R, theta, sol, sx, K, w, live, c, D, m, sxx, lv, stale, rows, got,
     flags) = row_local_inputs()
    a = arr
    return ([mod.mp_local_objective(a(theta), a(K), a(w), a(c), a(sol), 0.9),
             mod.cl_local_objective(a(theta), a(K), a(w), a(live), a(D),
                                    a(m), a(sx), a(sxx), 0.3),
             mod.cl_local_objective_from_loss(a(theta), a(K), a(w), a(live),
                                              a(D), a(lv), 0.3)],
            mod.staleness_step(a(stale), a(got), a(rows), R),
            [int(v) for v in mod.batch_drop_causes(*map(a, flags))])


def jax_row_local():
    objs, step, causes = row_local_metrics(jmet, jnp.asarray)
    return [np.asarray(o) for o in objs], np.asarray(step), causes


def test_row_local_metrics_match_jax(refs):
    objs, step, causes = row_local_metrics(tmet, torch.as_tensor)
    want_objs, want_step, want_causes = refs["row_local"]
    for got, want in zip(objs, want_objs):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    np.testing.assert_array_equal(step.numpy(), want_step)
    assert causes == want_causes


STREAM_CHUNKS = ("stream_dirty_chunks", "stream_staleness_chunks")


def jax_stream_reductions(js):
    n_rec = ROUNDS // RECORD
    return {"causes": jmet.stream_drop_causes(js),
            "totals": {k: np.asarray(v) for k, v in
                       jmet.stream_chunk_totals(js, n_rec, RECORD).items()},
            **{fn: np.asarray(getattr(jmet, fn)(js, N, n_rec, RECORD))
               for fn in STREAM_CHUNKS}}


def test_stream_reductions_match_jax(refs, problem):
    ts = problem["ts"]
    want = refs["reductions"]
    n_rec = ROUNDS // RECORD
    assert tmet.stream_drop_causes(ts) == want["causes"]
    got = tmet.stream_chunk_totals(ts, n_rec, RECORD)
    assert set(got) == set(want["totals"])
    for key, w in want["totals"].items():
        np.testing.assert_array_equal(got[key], w, err_msg=key)
        assert got[key].dtype == np.int64
    for fn in STREAM_CHUNKS:
        g = getattr(tmet, fn)(ts, N, n_rec, RECORD)
        w = want[fn]
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w, err_msg=fn)


# ---------------------------------------------------------------------------
# the engines' frames against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("body", ["per-op", "fused"])
def test_mp_frames_match_jax(problem, refs, body):
    want = refs["mp"][body]
    got = run_scenario(mp_spec(problem, telemetry=ON, backend=None
                               if body == "per-op"
                               else dispatch.ReproBackend()))
    assert (got.delivered, got.dropped, got.invalid) == \
        tuple(int(v) for v in want["counts"])
    assert_frames_match(got.telemetry, frames(want["frames"]))
    assert_invariants(got)
    np.testing.assert_array_equal(
        got.telemetry.staleness,
        tmet.stream_staleness_chunks(problem["ts"], N, ROUNDS // RECORD,
                                     RECORD))
    assert int(got.telemetry.updates[-1]) == got.delivered
    assert got.telemetry.suppressed is None


def test_cl_exact_frames_match_jax(problem, refs):
    got = run_scenario(cl_spec(problem, telemetry=ON))
    assert_frames_match(got.telemetry, frames(refs["cl_exact"]))
    assert_invariants(got)
    np.testing.assert_array_equal(
        got.telemetry.staleness,
        tmet.stream_staleness_chunks(problem["ts"], N, ROUNDS // RECORD,
                                     RECORD))


def jax_cl_inexact():
    """JAX's CL run with the inexact primal over MLP agents, its warm
    start, stream and frames."""
    jm = jflat.MLPAgent(in_dim=2, hidden=(4,))
    jt, jtrain, _, _ = jsyn.federated_moons_problem(n=24, seed=0)
    sol = np.asarray(jprimal.solitary_adamw(jtrain, loss="logistic",
                                            model=jm, steps=30, seed=0))
    cond = NetworkConditions(drop_prob=0.1, stale_prob=0.2)
    js = jax_stream(jt, cond, batch=8, seed=1, rounds=20)
    want = jeng.run_cl_scenario(
        jt, jtrain, 0.5, 0.5, jax_cond(cond), 20, 8, record_every=10,
        theta_sol=sol, stream=js, telemetry=J_ON,
        primal=jprimal.InexactPrimal(loss="logistic", model=jm, b_steps=3,
                                     lr=0.05))
    return {"sol": sol, "stream": jax.tree_util.tree_map(np.asarray, js),
            "frames": frame_fields(want.telemetry)}


def test_cl_inexact_mlp_frames_match_jax(refs):
    """The inexact primal with MLP agents: the objective's loss term goes
    through ``InexactPrimal.batch_local_loss``."""
    jm = jflat.MLPAgent(in_dim=2, hidden=(4,))
    _, jtrain, _, _ = jsyn.federated_moons_problem(n=24, seed=0)
    want = refs["cl_inexact"]
    cond = NetworkConditions(drop_prob=0.1, stale_prob=0.2)
    tt, _, _, _ = federated_moons_problem(n=24, seed=0, device=CPU)
    primal = InexactPrimal(loss="logistic", model=MLPAgent(2, (4,)),
                           b_steps=3, lr=0.05)
    got = run_scenario(ScenarioSpec(
        algo="cl", topology=tt, data=convert.data_from_arrays(jtrain, CPU),
        mu=0.5, rho=0.5, conditions=cond, rounds=20, batch=8,
        record_every=10,
        theta_sol=convert.agent_rows_from_arrays(want["sol"], CPU),
        stream=convert.stream_from_arrays(want["stream"], CPU),
        primal=primal, telemetry=ON, device=CPU))
    assert_frames_match(got.telemetry, frames(want["frames"]))
    assert_invariants(got)
    rows = got.theta_hist[-1]
    d = convert.data_from_arrays(jtrain, CPU)
    np.testing.assert_allclose(
        primal.batch_local_loss(rows, d.x, d.y, d.mask).numpy(),
        np.asarray(jprimal.InexactPrimal(loss="logistic", model=jm)
                   .batch_local_loss(jnp.asarray(rows.numpy()), jtrain.x,
                                     jtrain.y, jtrain.mask)),
        rtol=1e-5, atol=1e-6)


JOINT_RUN = dict(rounds=120, batch=24, rec=40)


def two_cluster_arrays():
    jt = jtopo.planted_partition_topology(64, 2, k_intra=5, k_inter=2,
                                          seed=0)
    _, _, sol, c = two_cluster_mean_problem(64, p=4, seed=0)
    return jt, sol, c


@pytest.fixture(scope="module")
def two_cluster():
    jt, sol, c = two_cluster_arrays()
    tt = ttopo.planted_partition_topology(64, 2, k_intra=5, k_inter=2,
                                          seed=0)
    return jt, tt, sol, c


def jax_joint():
    """JAX's joint run with prune under FAULTY: its stream, final live
    mask and frames."""
    jt, sol, c = two_cluster_arrays()
    rounds, batch, rec = (JOINT_RUN[k] for k in ("rounds", "batch", "rec"))
    js = jax_stream(jt, FAULTY, batch=batch, seed=SEED, rounds=rounds)
    want = jeng.run_joint_scenario(jt, sol, c, 0.9, jax_cond(FAULTY), rounds,
                                   batch, record_every=rec, stream=js,
                                   telemetry=J_ON, **LEARN_KW)
    return {"stream": jax.tree_util.tree_map(np.asarray, js),
            "final_live": np.asarray(want.final_live),
            "frames": frame_fields(want.telemetry)}


def test_joint_frames_match_jax(two_cluster, refs, monkeypatch):
    """Joint learning with prune: staleness and updates count the
    admitted deliveries, ``suppressed`` the voided ones, the objective is
    taken under the learned weights.  A slot whose weight came within
    1e-5 of ``prune_eps`` may be pruned on one side only (float32
    rounding; tests/test_torch_joint.py), and then the admitted
    deliveries may differ; the counters are held exactly when no slot
    flipped."""
    _, tt, sol, c = two_cluster
    rounds, batch, rec = (JOINT_RUN[k] for k in ("rounds", "batch", "rec"))
    want = refs["joint"]
    pre = []
    real_prune = teng.prune_rows

    def spy(w, live, eps):
        pre.append(torch.where(live, w, 0.0))
        return real_prune(w, live, eps)
    monkeypatch.setattr(teng, "prune_rows", spy)
    ts = convert.stream_from_arrays(want["stream"], CPU)
    got = run_scenario(ScenarioSpec(
        algo="joint", topology=tt, conditions=FAULTY, rounds=rounds,
        batch=batch, record_every=rec, theta_sol=sol, c=c, alpha=0.9,
        stream=ts, telemetry=ON, device=CPU, **LEARN_KW))
    near = torch.zeros_like(got.final_live)
    for w in pre:
        near |= (w - LEARN_KW["prune_eps"]).abs() <= 1e-5
    flipped = got.final_live.numpy() != want["final_live"]
    assert not (flipped & ~near.numpy()).any()
    f = got.telemetry
    assert_invariants(got)
    assert f.suppressed is not None and f.suppressed[-1] == got.suppressed
    assert got.suppressed > 0
    np.testing.assert_array_equal(f.updates + f.suppressed, f.delivered)
    if not flipped.any():
        assert_frames_match(f, frames(want["frames"]))
        np.testing.assert_array_equal(f.suppressed,
                                      want["frames"]["suppressed"])
    # voided deliveries leave agents staler than the stream says
    replay = tmet.stream_staleness_chunks(ts, tt.n, rounds // rec, rec)
    assert (f.staleness >= replay).all() and (f.staleness > replay).any()


# ---------------------------------------------------------------------------
# telemetry only observes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["mp-per-op", "mp-fused", "cl-exact",
                                  "cl-inexact", "joint"])
def test_telemetry_is_observation_only(problem, case):
    if case.startswith("mp"):
        base = mp_spec(problem, backend=None if case == "mp-per-op"
                       else dispatch.ReproBackend())
    elif case.startswith("cl"):
        base = cl_spec(problem, primal=None if case == "cl-exact"
                       else InexactPrimal(loss="quadratic", b_steps=3,
                                          lr=0.2))
    else:
        base = dataclasses.replace(mp_spec(problem), algo="joint",
                                   **LEARN_KW)
    runs = [run_scenario(dataclasses.replace(base, telemetry=t))
            for t in (None, OFF, ON)]
    assert runs[0].telemetry is None and runs[1].telemetry is None
    assert runs[2].telemetry is not None
    for r in runs[1:]:
        assert torch.equal(r.theta_hist, runs[0].theta_hist)
        assert (r.delivered, r.dropped, r.invalid) == \
            (runs[0].delivered, runs[0].dropped, runs[0].invalid)
    if case == "joint":
        assert torch.equal(runs[2].final_w, runs[0].final_w)
    assert runs[2].telemetry.objective.shape == (ROUNDS // RECORD, N)


def test_objective_falls_on_a_clean_run(problem):
    tr = run_scenario(dataclasses.replace(
        mp_spec(problem), conditions=NetworkConditions(), stream=None,
        rounds=90, record_every=30, seed=0, telemetry=ON))
    obj = tr.telemetry.objective.astype(np.float64).sum(axis=1)
    assert np.all(np.isfinite(obj)) and obj[-1] < obj[0]


# ---------------------------------------------------------------------------
# summaries, manifests and run directories
# ---------------------------------------------------------------------------


def test_summary_rows_equal_jax_on_identical_vectors(problem):
    tr = run_scenario(mp_spec(problem, telemetry=ON))
    f = tr.telemetry
    twin = jtel.TelemetryFrames(**{k: getattr(f, k) for k in (
        "rounds", "objective", "staleness") + COUNTERS})
    assert f.summarize() == twin.summarize()
    rows = ttel.trace_rows(tr)
    last = rows[-1]
    s = f.staleness[-1]
    assert last["staleness_p50"] == float(np.percentile(s, 50))
    assert last["delivered"] == tr.delivered
    plain = ttel.trace_rows(run_scenario(mp_spec(problem)))
    assert len(plain) == 1 and plain[0]["delivered"] == tr.delivered


def test_manifest_keys_and_hash():
    m = ttel.build_manifest(backend=dispatch.ReproBackend.using(
        mix="reference"), mesh_shape=(4,), seed=5,
        extra={"scenario": "clean"})
    jm = jtel.build_manifest(seed=5, extra={"scenario": "clean"})
    assert set(m) == (set(jm) - {"jax_version"}) | {
        "torch_version", "cuda_version", "device_name"}
    assert m["torch_version"] == torch.__version__
    assert m["device_count"] == torch.cuda.device_count()
    assert m["mesh_shape"] == [4] and len(m["backend_hash"]) == 12
    b1 = dispatch.ReproBackend.using(mix="reference")
    assert ttel.backend_config_hash(b1) == ttel.backend_config_hash(
        dispatch.ReproBackend.using(mix="reference"))
    assert ttel.backend_config_hash(b1) != ttel.backend_config_hash(
        dispatch.ReproBackend.using(mix="cuda"))
    assert ttel.backend_config_hash(None) == jtel.backend_config_hash(None)


def test_run_directories_cross_load(problem, tmp_path):
    tr = run_scenario(mp_spec(problem, telemetry=ON))
    manifest = ttel.build_manifest(seed=SEED, extra={"scenario": "faulty"})
    rows = ttel.trace_rows(tr)
    port_dir = ttel.write_run(str(tmp_path / "port"), manifest, rows)
    for load in (ttel.load_run, jtel.load_run):
        m2, rows2 = load(port_dir)
        assert m2 == json.loads(json.dumps(manifest))
        assert rows2 == json.loads(json.dumps(rows))
    with open(os.path.join(port_dir, "metrics.jsonl")) as f:
        assert len(f.readlines()) == tr.telemetry.n_records
    text = ttel.render_summary(*ttel.load_run(port_dir))
    assert "torch=" in text and "final:" in text and "staleness:" in text
    jax_dir = jtel.write_run(str(tmp_path / "jax"), jtel.build_manifest(
        seed=SEED), rows)
    m3, rows3 = ttel.load_run(jax_dir)
    assert rows3 == json.loads(json.dumps(rows))
    assert "jax=" in ttel.render_summary(m3, rows3)
    assert ttel.render_summary(m3, rows3).splitlines()[1:] == \
        jtel.render_summary(m3, rows3).splitlines()[1:]
