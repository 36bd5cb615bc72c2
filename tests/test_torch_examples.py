"""The port's examples (``examples/*_torch.py``: the simulator examples
and the two serving demos) run in process at their ``--smoke`` size on
the CPU, through their own ``main``:

* the figures that come from numpy seeds and deterministic code equal the
  JAX package's same functions at the same arguments within 1e-5: the
  quickstart's closed forms, solitary and consensus models,
  ``synchronous``, ``sync_admm`` and ``run_mp_sweep``'s mean L2 per
  alpha; federated_moons' coupling iterates and their gap to the closed
  form; network_sim_demo's theta* (``sparse_sync_mp``); joint_graph_demo's
  ``cluster_edge_recovery`` before learning; serve_demo's parameter
  count and every request's token count (the JAX demo's own run);
  collab_serve_demo's own scenario on the JAX package's event stream
  against JAX's ``run_scenario``: the service's counters and every served
  staleness exactly, ``theta_hist`` within 1e-5;
* the figures that depend on event draws (the port draws its own) hold
  the example's own property: its closing assertion, finite values, and
  a ``rel_err`` below 1; serve_demo's tokens (drawn at temperature 0.7)
  are the port's own;
* without ``--device`` on a host without CUDA each example raises;
* ``tools/trace_report_torch.py`` and the JAX package's
  ``tools/trace_report.py`` both render the run directories the two
  ``--out`` examples write (the layout is shared).

The JAX side of the figure tests runs in a subprocess of its own that
starts with the port's first test (``jax_references``;
tests/_port_session.py).
"""

import contextlib
import importlib.util
import io
import math
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import simulate as jsim  # noqa: E402
from repro import telemetry as jtel  # noqa: E402
from repro.core import closed_form as jclosed_form  # noqa: E402
from repro.core import confidences_from_counts as jconf  # noqa: E402
from repro.core import consensus_model as jconsensus  # noqa: E402
from repro.core import solitary_gd as jsolitary_gd  # noqa: E402
from repro.core import solitary_mean as jsolitary_mean  # noqa: E402
from repro.core import sync_admm as jsync_admm  # noqa: E402
from repro.core import synchronous as jsynchronous  # noqa: E402
from repro.core.graph_learning import \
    cluster_edge_recovery as jrecovery  # noqa: E402
from repro.coupling import CouplingConfig as JCC  # noqa: E402
from repro.coupling import dense_mix_tree as jdense_mix_tree  # noqa: E402
from repro.coupling import make_state as jmake_state  # noqa: E402
from repro.data import accuracy as jaccuracy  # noqa: E402
from repro.data import linear_classification_problem as jlin  # noqa: E402
from repro.data import mean_estimation_problem as jmean  # noqa: E402
from repro.data.synthetic import \
    two_cluster_mean_problem as jtwo_cluster  # noqa: E402
from repro.experiments import mean_estimation_trials as jtrials  # noqa: E402
from repro.experiments import run_mp_sweep as jrun_mp_sweep  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import ModelConfig as JModelConfig  # noqa: E402
from repro.simulate import cluster_topology as jcluster_topology  # noqa: E402
from repro.simulate import planted_partition_topology as jplanted  # noqa: E402
from repro.simulate import sparse_sync_mp as jsparse_sync_mp  # noqa: E402

import _port_session  # noqa: E402
from _port_session import as_numpy  # noqa: E402
from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from _port_session import port_background_jobs  # noqa: E402,F401
from repro_torch import convert  # noqa: E402
from repro_torch.simulate import run_scenario  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "federated_moons", "network_sim_demo",
            "joint_graph_demo", "nonlinear_agents_demo", "serve_demo",
            "collab_serve_demo")
WRITES_RUNS = ("network_sim_demo", "joint_graph_demo")
# collab_serve_demo's --smoke sizes: n, p, rounds, rate
COLLAB_SMOKE = (300, 16, 80, 10.0)
TOL = 1e-5


def load(path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example(name):
    return load(REPO / "examples" / f"{name}_torch.py")


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """Each example's ``main(["--smoke", "--device", "cpu"])``, run once:
    ``{name: (figures, stdout)}``; the two that write run directories
    write them under a temporary ``--out``."""
    out = {}
    for name in EXAMPLES:
        argv = ["--smoke", "--device", "cpu"]
        if name in WRITES_RUNS:
            argv += ["--out", str(tmp_path_factory.mktemp(name))]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            figures = example(name).main(argv)
        out[name] = figures, buf.getvalue()
    return out


def finite(tree):
    if isinstance(tree, dict):
        return all(finite(v) for v in tree.values())
    if isinstance(tree, (list, tuple, np.ndarray)):
        return bool(np.isfinite(np.asarray(tree, np.float64)).all())
    if isinstance(tree, str):
        return True
    return tree is None or math.isfinite(tree)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_smoke_on_the_cpu(smoke, name):
    """Finite figures, each printed as the JAX example prints it, and the
    event-drawn figures within the example's own bounds (its closing
    assertion held in ``main``)."""
    figures, text = smoke[name]
    assert finite(figures), figures
    if name == "quickstart":
        me, lc, be = (figures[k] for k in ("mean_estimation",
                                           "linear_classification",
                                           "backends"))
        assert f"MP async gossip        L2 = {me['async_gossip']:.4f} " \
            f"after {me['comms']} pairwise communications" in text
        # the gossip moves the solitary models toward the closed form
        assert me["closed_form"] < me["async_gossip"] < me["solitary"]
        assert f"CL (ADMM) acc = {lc['cl']:.3f}" in text
        assert be["cuda_vs_reference"] is None
        assert be["sweep_cuda_vs_reference"] is None
        assert "graph_mix kernel needs the CUDA card" in text
    elif name == "federated_moons":
        assert f"|coupling - closed_form|_max = {figures['gap']:.2e}" in text
        assert figures["gap"] < 1e-3
    elif name == "network_sim_demo":
        rel = figures["rel_err"]
        from repro_torch.simulate import list_scenarios
        assert sorted(rel) == sorted(list_scenarios())
        assert all(0.0 < v < 1.0 for v in rel.values()), rel
        for scenario, v in rel.items():
            assert f"{scenario:16s} rel_err={v:.3f}  round    120" in text
    elif name == "joint_graph_demo":
        assert figures["eta=0.3"]["intra_recovered"] >= 0.9
        # learning suppresses the planted inter-cluster mass
        assert figures["eta=0.3"]["inter_mass"] < \
            figures["eta=0"]["inter_mass"]
        assert "OK: learned graph recovers the planted clusters" in text
    elif name == "nonlinear_agents_demo":
        assert figures["p"] == 33
        assert figures["acc"] > figures["acc_solitary"]
        assert f"Eq.7 objective (telemetry):  " \
            f"{figures['objective_first']:.1f} -> " in text
    elif name == "serve_demo":
        assert not figures["exhausted"]
        assert figures["requests"] == 8
        assert f"model: {figures['params'] / 1e6:.2f}M params" in text
        assert "submitted 8 requests into 4 slots" in text
        for rid, count in figures["tokens_by_request"].items():
            assert f" req {rid}: {count} tokens -> [" in text
        assert figures["total_tokens"] == \
            sum(figures["tokens_by_request"].values())
        assert f"{figures['total_tokens']} tokens in " in text
        assert "tok/s, CPU, batched)" in text
    else:
        assert figures["identical"] is True
        assert (figures["n"], figures["rounds"]) == (300, 80)
        assert figures["requests"] == 800            # rate 10 x 80 rounds
        assert figures["hits"] + figures["misses"] == figures["requests"]
        assert f"served {figures['requests']} requests over 80 rounds " \
            f"(300 agents)" in text
        assert f"  cache: hit_rate={figures['hit_rate']:.2%} " \
            f"hits={figures['hits']} misses={figures['misses']} " \
            f"invalidations={figures['invalidations']}" in text
        assert f"  served staleness: p50={figures['staleness_p50']:.0f} " \
            f"p99={figures['staleness_p99']:.0f} rounds" in text
        assert "  last telemetry row: round     80 " in text
        assert "OK: gossip trajectory identical with and without serving" \
            in text


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_needs_a_card_unless_asked_for_the_cpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example(name).main(["--smoke"])


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=TOL,
                               rtol=0)


def jax_quickstart(size):
    """quickstart's figures that no event draw touches, from the JAX
    package's functions at the sizes ``size`` (``SIZES[True]``)."""
    g, data, targets, _ = jmean(n=100, eps=1.0, seed=0)
    sol = np.asarray(jsolitary_mean(data))
    conf = np.asarray(jconf(data.counts))

    def err(th):
        return float(np.mean((np.asarray(th)[:, 0] - targets) ** 2))
    me = {"solitary": err(sol),
          "closed_form": err(jclosed_form(g, sol, conf, alpha=0.99)),
          "closed_form_no_conf": err(jclosed_form(g, sol, np.ones(g.n),
                                                  alpha=0.99))}

    g, train, test, _ = jlin(n=60, p=30, seed=0)
    sol = np.asarray(jsolitary_gd(train, "hinge",
                                  steps=size["solitary_steps"]))
    conf = np.asarray(jconf(train.counts))

    def acc(th):
        return float(np.mean(jaccuracy(np.asarray(th), test)))
    lc = {"solitary": acc(sol),
          "consensus": acc(np.tile(np.asarray(jconsensus(
              train, "hinge", steps=size["consensus_steps"])), (g.n, 1))),
          "mp": acc(jclosed_form(g, sol, conf, alpha=0.99)),
          "cl": acc(jsync_admm(g, train, mu=0.05, rho=1.0, loss="hinge",
                               steps=size["admm_steps"], k_steps=12,
                               lr=0.05, theta_sol=sol).theta_hist[-1])}

    g, data, _, _ = jmean(n=60, eps=1.0, seed=0)
    sol = np.asarray(jsolitary_mean(data))
    conf = np.asarray(jconf(data.counts))
    be = {"synchronous": np.asarray(jsynchronous(
        g, sol, conf, alpha=0.9, steps=size["sync_steps"]))[:, 0]}
    trials = jtrials(seeds=range(4), alphas=[0.9, 0.99], n=60)
    res = jrun_mp_sweep(trials, sweeps=size["sweeps"])
    be["sweep"] = {a: float(res.err_hist[trials.alpha == np.float32(a),
                                         -1].mean()) for a in (0.9, 0.99)}
    return {"mean_estimation": me, "linear_classification": lc,
            "backends": be}


def jax_federated_moons(iterates):
    g, data, targets, _ = jmean(n=60, eps=1.0, seed=0)
    sol = np.asarray(jsolitary_mean(data))
    conf = np.asarray(jconf(data.counts))
    star = np.asarray(jclosed_form(g, sol, conf, 0.9))
    state = jmake_state(g, conf, 0.9)
    cfg = JCC(mode="mp", alpha=0.9)
    theta = {"t": jnp.asarray(sol, jnp.float32)}
    anchor = {"t": jnp.asarray(sol, jnp.float32)}
    for _ in range(iterates):
        theta = jdense_mix_tree(theta, anchor, state, cfg)

    def err(th):
        return float(np.mean((np.asarray(th)[:, 0] - targets) ** 2))
    return {"solitary": err(sol), "closed_form": err(star),
            "coupling": err(theta["t"]),
            "gap": float(np.abs(np.asarray(theta["t"]) - star).max())}


def jax_theta_star(n, p=16):
    """network_sim_demo's problem and theta* from the JAX package."""
    topo = jcluster_topology(n, n_clusters=8, k_intra=5, bridges=6, seed=0)
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((int(topo.groups.max()) + 1, p))
    theta_sol = (centers[topo.groups]
                 + 0.5 * rng.standard_normal((n, p))).astype(np.float32)
    c = rng.uniform(0.05, 1.0, n).astype(np.float32)
    return np.asarray(jsparse_sync_mp(topo, theta_sol, c, 0.9, sweeps=400))


def jax_serve_demo():
    """The JAX serve demo's own run (its printed lines: each request's
    token count) and the parameter count of the JAX ``Model`` of the
    port demo's config."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        load(REPO / "examples" / "serve_demo.py").main()
    text = buf.getvalue()
    counts = {int(rid): int(k) for rid, k in
              re.findall(r"^ req (\d+): (\d+) tokens -> ", text, re.M)}
    cfg = JModelConfig(**example("serve_demo").CONFIG)
    return {"params": JModel(cfg).param_count(), "tokens_by_request": counts,
            "model_line": text.splitlines()[0]}


def jax_collab_serve(n, p, rounds, rate, seed=0):
    """The JAX collab serve demo's scenario at these sizes through JAX's
    ``run_scenario`` (events drawn inline), and the same events drawn by
    ``precompute_event_stream`` for the port's spec to replay."""
    topo = jcluster_topology(n, n_clusters=8, k_intra=5, bridges=6,
                             seed=seed)
    rng = np.random.default_rng(seed)
    theta_sol = rng.standard_normal((n, p)).astype(np.float32)
    c = rng.uniform(0.05, 1.0, n).astype(np.float32)
    cond = jsim.NetworkConditions(drop_prob=0.15, churn_rate=0.005)
    batch = max(1, n // 10)
    tr = jsim.run_scenario(jsim.ScenarioSpec(
        algo="mp", topology=topo, theta_sol=theta_sol, c=c, alpha=0.9,
        conditions=cond, rounds=rounds, batch=batch, seed=seed,
        record_every=max(1, rounds // 8),
        telemetry=jtel.TelemetryConfig(enabled=True),
        serve=jsim.precompute_serve_stream(n, rounds, rate=rate, seed=seed),
        serve_batch=256))
    stream = jsim.precompute_event_stream(
        topo.device_tables(), jnp.asarray(topo.partition_halves()), cond,
        batch, seed, rounds)
    rep = tr.serve
    return as_numpy({
        "requests": rep.requests, "hits": rep.hits, "misses": rep.misses,
        "invalidations": rep.invalidations,
        "served_staleness": rep.served_staleness,
        "theta_hist": tr.theta_hist, "stream": stream})


def jax_references():
    """The JAX side of the figure tests (run in a subprocess of its own
    beside the tests before this module: tests/_port_session.py)."""
    return {"quickstart": jax_quickstart(example("quickstart").SIZES[True]),
            "federated_moons": jax_federated_moons(
                example("federated_moons").ITERATES),
            "theta_star": jax_theta_star(300),
            "serve_demo": jax_serve_demo(),
            "collab_serve": jax_collab_serve(*COLLAB_SMOKE)}


refs = _port_session.reference_fixture(__name__)


def test_quickstart_figures_match_jax(smoke, refs):
    """Every figure of quickstart's that no event draw touches, against
    the JAX package's functions at the --smoke sizes."""
    figures, _ = smoke["quickstart"]
    want = refs["quickstart"]
    for part, keys in (("mean_estimation", ("solitary", "closed_form",
                                            "closed_form_no_conf")),
                       ("linear_classification", ("solitary", "consensus",
                                                  "mp", "cl")),
                       ("backends", ("synchronous",))):
        for key in keys:
            close(figures[part][key], want[part][key])
    for a in (0.9, 0.99):
        close(figures["backends"]["sweep"][a], want["backends"]["sweep"][a])


def test_federated_moons_coupling_matches_jax(smoke, refs):
    figures, _ = smoke["federated_moons"]
    for key in ("solitary", "closed_form", "coupling", "gap"):
        close(figures[key], refs["federated_moons"][key])


def test_network_sim_theta_star_matches_jax(smoke, refs):
    figures, _ = smoke["network_sim_demo"]
    assert figures["n"] == 300
    close(figures["theta_star"], refs["theta_star"])


def test_joint_graph_recovery_before_learning_matches_jax(smoke):
    figures, _ = smoke["joint_graph_demo"]
    n = figures["n"]
    topo = jplanted(n, 2, k_intra=5, k_inter=2, seed=0)
    labels = jtwo_cluster(n, p=4, seed=0)[0]
    tabs = topo.tables
    want = jrecovery(tabs.nbr_idx, tabs.deg_count, tabs.nbr_p, labels)
    got = figures["before"]
    assert (got["n_intra"], got["n_inter"]) == (want.n_intra, want.n_inter)
    for key in ("intra_recovered", "inter_suppressed", "inter_mass"):
        close(got[key], getattr(want, key))


def test_serve_demo_counts_match_jax(smoke, refs):
    """The parameter count and every request's token count of the JAX
    demo's run (the tokens themselves are sampled: the port's own)."""
    figures, text = smoke["serve_demo"]
    want = refs["serve_demo"]
    assert figures["params"] == want["params"]
    assert text.splitlines()[0] == want["model_line"]
    assert figures["tokens_by_request"] == want["tokens_by_request"]


def test_collab_serve_demo_matches_jax_on_its_stream(refs):
    """The demo's own spec at its --smoke size, replaying the JAX
    package's event stream, against JAX's ``run_scenario`` of the JAX
    demo's spec: the service's counters and every served staleness
    exactly, ``theta_hist`` within 1e-5."""
    want = refs["collab_serve"]
    n, p, rounds, rate = COLLAB_SMOKE
    spec = example("collab_serve_demo").spec(
        n, p, rounds, rate, 0, "cpu",
        stream=convert.stream_from_arrays(want["stream"], "cpu"))
    tr = run_scenario(spec)
    for f in ("requests", "hits", "misses", "invalidations"):
        assert getattr(tr.serve, f) == want[f], f
    np.testing.assert_array_equal(tr.serve.served_staleness,
                                  want["served_staleness"])
    close(tr.theta_hist.numpy(), want["theta_hist"])


@pytest.mark.parametrize("name", WRITES_RUNS)
def test_trace_reports_render_the_run_directories(smoke, name, capsys):
    """Both tools render every run directory the example wrote."""
    runs = smoke[name][0]["runs"]
    assert len(runs) == (5 if name == "network_sim_demo" else 2)
    port = load(REPO / "tools" / "trace_report_torch.py")
    jax_tool = load(REPO / "tools" / "trace_report.py")
    for tool in (port, jax_tool):
        assert tool.main(list(runs.values())) == 0
        text = capsys.readouterr().out
        for d in runs.values():
            assert f"== {d} ==" in text
        assert text.count("convergence: objective") == len(runs)
