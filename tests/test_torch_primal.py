"""The nonlinear CL-ADMM agents in the port against the JAX package:
AdamW, the guarded losses, the flat-row agent models, the inexact primal,
and the CL engine running it.

Tolerances, and why:

* AdamW: parameters and float32 moments within 1e-6 over five steps (the
  same float32 arithmetic in the same order; ``b ** count`` and the
  square root may round an ulp apart), the global norm within 1e-6
  relative (its sum of squares adds in another order); bf16 moments are
  the float32 ones rounded, so they agree to one bf16 ulp (2^-8
  relative).
* Guarded losses: values and gradients within 1e-5 relative (float32
  sums of a few terms); the gradient at NaN pads is exactly 0.
* Agent models: flat rows equal exactly (same leaves, same order); their
  ``apply`` within 1e-6 (float32 matmul and tanh).
* ``inexact_primal`` with 4 AdamW steps, and the B -> inf quadratic
  anchor against the exact solve: within 1e-5 (float32 rounding; Adam's
  normalised steps pass a gradient's rounding on at the scale of lr).
* ``run_cl_scenario`` with MLP agents on the JAX run's stream: counters
  exactly, ``theta_hist`` within 1e-4 (30 rounds of 4 AdamW steps each
  through a tanh network: the rounding differences above, compounded).
* ``federated_moons_problem``: the arrays equal JAX's exactly (the same
  numpy draws).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import losses as jloss  # noqa: E402
from repro.core import primal as jprimal  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import flatten as jflat  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.simulate import engines as jeng  # noqa: E402
from repro.simulate import scheduler as jsched  # noqa: E402
from repro.simulate import topology as jtopo  # noqa: E402

import _port_session  # noqa: E402
from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from _port_session import port_background_jobs  # noqa: E402,F401
from _port_session import as_numpy  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.losses import guarded_loss, pad_datasets  # noqa: E402
from repro_torch.core.losses import solitary_mean  # noqa: E402
from repro_torch.core.primal import (ExactQuadraticPrimal,  # noqa: E402
                                     InexactPrimal, flat_predictor,
                                     solitary_adamw)
from repro_torch.data import (federated_moons_problem,  # noqa: E402
                              model_accuracy)
from repro_torch.kernels import dispatch, ref  # noqa: E402
from repro_torch.models import (LoRAAgent, MLPAgent,  # noqa: E402
                                ParamFlattener)
from repro_torch.models.flatten import _lora_base  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, cosine_schedule)
from repro_torch.simulate import (NetworkConditions,  # noqa: E402
                                  ScenarioSpec, random_geometric_topology,
                                  run_scenario)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

CPU = "cpu"


def to_torch(tree):
    return tree_map(lambda a: torch.tensor(np.array(a)), tree)


def close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(torch.as_tensor(got).float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


ADAMW = [("bfloat16", 1.0, 0.1, 1.0), ("float32", 0.0, 0.0, 1.0),
         ("float32", 0.5, 0.01, 0.5), ("bfloat16", 0.0, 0.1, 2.0)]


def adamw_case():
    """Nested-dict parameters and five steps' gradients, drawn in the
    order the update takes them (the JAX update unzips its outputs by
    tuple, so its parameter trees hold no tuples)."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32),
              "layer": {"a": rng.standard_normal(5).astype(np.float32),
                        "c": rng.standard_normal((2, 2)).astype(np.float32)}}
    grads = [tree_map(lambda a: (3 * rng.standard_normal(a.shape))
                      .astype(np.float32), params) for _ in range(5)]
    return params, grads


def jax_adamw(moments, clip, wd, lr_scale):
    """JAX's five AdamW steps on ``adamw_case``: the parameters' and
    moments' leaves, the step count and each step's gradient norm."""
    params, grads = adamw_case()
    jcfg = jadamw.AdamWConfig(moment_dtype=getattr(jnp, moments), lr=1e-2,
                              weight_decay=wd, grad_clip=clip)
    jp, js = params, jadamw.adamw_init(params, jcfg)
    norms = []
    for g in grads:
        jp, js, jgn = jadamw.adamw_update(g, js, jp, jcfg, lr_scale)
        norms.append(np.asarray(jgn))
    leaves = jax.tree_util.tree_leaves
    return {"params": [np.asarray(a) for a in leaves(jp)],
            "m": [np.asarray(a, np.float32) for a in leaves(js["m"])],
            "v": [np.asarray(a, np.float32) for a in leaves(js["v"])],
            "count": int(js["count"]), "norms": norms}


@pytest.mark.parametrize("moments,clip,wd,lr_scale", ADAMW)
def test_adamw_matches_jax(refs, moments, clip, wd, lr_scale):
    params, grads = adamw_case()
    want = refs["adamw"][moments, clip, wd, lr_scale]
    tcfg = AdamWConfig(moment_dtype=getattr(torch, moments), lr=1e-2,
                       weight_decay=wd, grad_clip=clip)
    tp = to_torch(params)
    ts = adamw_init(tp, tcfg)
    for g, jgn in zip(grads, want["norms"]):
        tp, ts, tgn = adamw_update(to_torch(g), ts, tp, tcfg, lr_scale)
        close(tgn, jgn, 0.0, rtol=1e-6)      # a float32 sum of squares
    assert int(ts["count"]) == want["count"] == 5
    for got, w in zip(tree_leaves(tp), want["params"]):
        close(got, w, 1e-6)
    for key in ("m", "v"):
        for got, w in zip(tree_leaves(ts[key]), want[key]):
            assert got.dtype == getattr(torch, moments)
            ulp = 2.0 ** -8 if moments == "bfloat16" else 1e-6
            close(got, w, 1e-30, rtol=ulp)


def test_cosine_schedule_matches_jax():
    for step in (0, 1, 50, 100, 101, 500, 999, 1000, 1200):
        close(cosine_schedule(step, 1000, warmup=100),
              jadamw.cosine_schedule(step, 1000, warmup=100), 1e-7)


# ---------------------------------------------------------------------------
# guarded losses
# ---------------------------------------------------------------------------


GUARDED = ["quadratic", "hinge", "logistic", "mlp-logistic"]


def loss_case(name, theta_mlp=None):
    """(loss, port predict_fn, theta, x, y, mask): six samples, the last
    two pads filled with NaN; for the MLP, ``theta_mlp`` (JAX's initial
    row) is theta."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 2)).astype(np.float32)
    y = np.sign(rng.standard_normal(6)).astype(np.float32)
    mask = np.array([1, 1, 1, 1, 0, 0], np.float32)
    x[4:] = np.nan
    y[4:] = np.nan
    if name == "mlp-logistic":
        return ("logistic", flat_predictor(MLPAgent(2, (4,))), theta_mlp,
                x, y, mask)
    theta = rng.standard_normal(2).astype(np.float32)
    return name, None, theta, x, y, mask


def jax_guarded(name):
    """JAX's guarded loss and its gradient at ``loss_case(name)``, and
    theta (JAX's MLP draws it)."""
    jpred, theta_mlp = None, None
    if name == "mlp-logistic":
        jm = jflat.MLPAgent(2, (4,))
        jpred = jprimal.flat_predictor(jm)
        theta_mlp = np.asarray(jm.flattener().flatten(jm.init(
            jax.random.PRNGKey(1))))
    loss, _, theta, x, y, mask = loss_case(name, theta_mlp)
    jval, jgrad = jax.value_and_grad(jloss.guarded_loss(loss, jpred))(
        theta, x, y, mask)
    return theta, np.asarray(jval), np.asarray(jgrad)


@pytest.mark.parametrize("name", GUARDED)
def test_guarded_loss_matches_jax_with_nan_pads(refs, name):
    theta_j, jval, jgrad = refs["guarded"][name]
    loss, tpred, theta, x, y, mask = loss_case(name, theta_j)
    np.testing.assert_array_equal(theta, theta_j)
    tfn = guarded_loss(loss, tpred)
    th = torch.tensor(theta, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    val = tfn(th, xt, torch.tensor(y), torch.tensor(mask))
    val.backward()
    assert torch.isfinite(val) and torch.isfinite(th.grad).all()
    close(val.detach(), jval, 0.0, rtol=1e-5)
    close(th.grad, jgrad, 1e-6, rtol=1e-5)
    assert (xt.grad[4:] == 0).all()              # pads: exactly zero
    # the pads contribute nothing: clean pads give the same value/gradient
    x0, y0 = np.nan_to_num(x), np.nan_to_num(y)
    th0 = torch.tensor(theta, requires_grad=True)
    val0 = tfn(th0, torch.tensor(x0), torch.tensor(y0), torch.tensor(mask))
    val0.backward()
    assert torch.equal(val0.detach(), val.detach())
    assert torch.equal(th0.grad, th.grad)


def test_guarded_loss_rejects_bad_configs():
    with pytest.raises(ValueError):
        guarded_loss("absolute")
    with pytest.raises(ValueError):
        guarded_loss("quadratic", lambda th, x: x @ th)


# ---------------------------------------------------------------------------
# flat-row agent models
# ---------------------------------------------------------------------------


def test_flattener_round_trip_and_jax_order():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": (rng.standard_normal(5).astype(np.float32),
                  np.float32(rng.standard_normal()))}
    flat = ParamFlattener.from_template(tree)
    jflatr = jflat.ParamFlattener.from_template(tree)
    assert flat.dim == jflatr.dim == 3 * 4 + 5 + 1
    assert flat.shapes == jflatr.shapes
    vec = flat.flatten(to_torch(tree))
    assert torch.equal(vec, torch.tensor(np.array(jflatr.flatten(tree))))
    back = flat.unflatten(vec)
    for a, b in zip(tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert torch.equal(flat.flatten(back), vec)


def jax_mlp_agent():
    """JAX's MLP agent (2 -> 8 -> 1): its parameters, their flat row, its
    output on seven points, and five agents' stacked parameters and rows."""
    jm = jflat.MLPAgent(in_dim=2, hidden=(8,))
    params = jm.init(jax.random.PRNGKey(0))
    x = np.random.default_rng(1).standard_normal((7, 2)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(2), 5)
    stacked = jax.vmap(lambda k: jm.init(k))(keys)
    return {"params": as_numpy(params),
            "row": np.asarray(jm.flattener().flatten(params)),
            "x": x, "apply": np.asarray(jm.apply(params, x)),
            "stacked": as_numpy(stacked),
            "rows": np.asarray(jax.vmap(jm.flattener().flatten)(stacked))}


def test_mlp_agent_layout_and_apply_match_jax(refs):
    """JAX flattens dicts in sorted key order, so an MLP layer {"w", "b"}
    lays out as b then w; the port's rows mean the same parameters."""
    jm, tm = jflat.MLPAgent(in_dim=2, hidden=(8,)), MLPAgent(2, (8,))
    assert tm.flattener().shapes == jm.flattener().shapes
    assert tm.flattener().dim == 33
    want = refs["mlp_agent"]
    params, row = want["params"], want["row"]
    assert np.array_equal(row[:8], np.asarray(params[0]["b"]))
    tparams = to_torch(params)
    assert torch.equal(tm.flattener().flatten(tparams), torch.tensor(row))
    x = want["x"]
    close(tm.apply(tparams, torch.tensor(x)), want["apply"], 1e-6)
    close(flat_predictor(tm)(torch.tensor(row), torch.tensor(x)),
          want["apply"], 1e-6)
    # agent-stacked trees carried across flatten in the same order
    rows = want["rows"]
    np.testing.assert_array_equal(
        convert.agent_rows_from_arrays(want["stacked"], CPU).numpy(), rows)
    np.testing.assert_array_equal(
        convert.agent_rows_from_arrays(rows, CPU).numpy(), rows)
    # the port's own init draws agent parameters of the right layout
    gen = torch.Generator().manual_seed(0)
    own = tm.init(gen)
    assert [tuple(a.shape) for a in tree_leaves(own)] == \
        [tuple(s) for s in tm.flattener().shapes]


def test_lora_agent_matches_jax():
    jm = jflat.LoRAAgent(in_dim=3, width=8, rank=2, base_seed=5)
    tm = LoRAAgent(in_dim=3, width=8, rank=2, base_seed=5)
    assert tm.flattener().dim == jm.flattener().dim == 2 * (3 + 8) + 8 + 1
    assert tm.flattener().shapes == jm.flattener().shapes
    for got, want in zip(_lora_base(3, 8, 5), jflat._lora_base(3, 8, 5)):
        np.testing.assert_array_equal(got, np.asarray(want))
    params = jm.init(jax.random.PRNGKey(0))
    params = dict(params, b=jax.random.normal(jax.random.PRNGKey(3),
                                              (2, 8)) * 0.1)
    x = np.random.default_rng(2).standard_normal((5, 3)).astype(np.float32)
    close(tm.apply(to_torch(params), torch.tensor(x)),
          jm.apply(params, x), 1e-6)
    row = np.asarray(jm.flattener().flatten(params))
    assert torch.equal(tm.flattener().flatten(to_torch(params)),
                       torch.tensor(row))


# ---------------------------------------------------------------------------
# the inexact primal
# ---------------------------------------------------------------------------


def primal_rows(rng, R, k, p, q, m=5):
    live = rng.uniform(size=(R, k)) < 0.8
    live[:, 0] = True
    w = (rng.uniform(0.2, 1.0, (R, k)) * live).astype(np.float32)
    zl = [rng.standard_normal((R, k, p)).astype(np.float32) * 0.5
          for _ in range(4)]
    D = w.sum(1).astype(np.float32)
    x = rng.standard_normal((R, m, q)).astype(np.float32)
    y = np.sign(rng.standard_normal((R, m))).astype(np.float32)
    mask = (rng.uniform(size=(R, m)) < 0.8).astype(np.float32)
    theta0 = rng.standard_normal((R, p)).astype(np.float32) * 0.5
    return [w, live, *zl, D, x, y, mask, theta0]


INEXACT = ["quadratic", "logistic", "mlp"]


def inexact_args(case):
    rng = np.random.default_rng(7)
    if case == "mlp":
        return primal_rows(rng, 12, 5, 17, 2)
    return primal_rows(rng, 12, 5, 3, 3)


def jax_inexact(case):
    if case == "mlp":
        jp = jprimal.InexactPrimal(loss="logistic",
                                   model=jflat.MLPAgent(2, (4,)), b_steps=4)
    else:
        jp = jprimal.InexactPrimal(loss=case, b_steps=4, lr=0.2)
    loss_fn, opt = jp.loss_fn(), jp.opt_config()

    def row(*a):
        return jref.inexact_primal(*a, 0.4, 1.0, loss_fn=loss_fn,
                                   b_steps=4, opt=opt)
    return [np.asarray(w) for w in jax.vmap(row)(
        *[jnp.asarray(a) for a in inexact_args(case)])]


@pytest.mark.parametrize("case", INEXACT)
def test_inexact_primal_matches_jax(refs, case):
    if case == "mlp":
        tp = InexactPrimal(loss="logistic", model=MLPAgent(2, (4,)),
                           b_steps=4)
    else:
        tp = InexactPrimal(loss=case, b_steps=4, lr=0.2)
    args = inexact_args(case)
    got = ref.inexact_primal(*[torch.tensor(a) for a in args], 0.4, 1.0,
                             loss_fn=tp.loss_fn(), b_steps=4,
                             opt=tp.opt_config())
    for g, w_ in zip(got, refs["inexact"][case]):
        close(g, w_, 1e-5)
    assert not np.allclose(got[0].numpy(), args[-1])     # it moved


def test_inexact_primal_config_and_registration():
    with pytest.raises(ValueError):
        InexactPrimal(loss="absolute")
    with pytest.raises(ValueError):
        InexactPrimal(loss="logistic", b_steps=None)
    with pytest.raises(ValueError):
        InexactPrimal(loss="quadratic", model=MLPAgent(in_dim=2))
    assert dispatch.implementations("admm_primal_inexact") == ("reference",)
    assert dispatch.resolve("admm_primal_inexact", None, "cuda") \
        is ref.inexact_primal
    assert InexactPrimal().needs_data and not ExactQuadraticPrimal.needs_data
    assert hash(InexactPrimal(model=MLPAgent(2))) == \
        hash(InexactPrimal(model=MLPAgent(2)))


def test_b_inf_quadratic_reproduces_exact():
    """The B -> inf fixed point of the reduced Lagrangian is the closed
    form, so the run matches the exact engine's (tests/test_primal.py's
    configuration), and finite B gets closer as B grows."""
    rng = np.random.default_rng(0)
    topo = random_geometric_topology(24, k=4, seed=0)
    xs = [rng.standard_normal((int(rng.integers(2, 9)), 3))
          for _ in range(24)]
    data = pad_datasets(xs, [np.zeros(len(x)) for x in xs], device=CPU)
    sol = solitary_mean(data)
    base = dict(algo="cl", topology=topo, data=data, mu=0.4, rho=1.0,
                conditions=NetworkConditions(drop_prob=0.1, stale_prob=0.2),
                rounds=30, batch=8, seed=3, record_every=10, theta_sol=sol,
                device=CPU)
    exact = run_scenario(ScenarioSpec(**base))
    inf = run_scenario(ScenarioSpec(**base, primal=InexactPrimal(
        loss="quadratic", b_steps=None)))
    assert (inf.delivered, inf.dropped, inf.invalid) == \
        (exact.delivered, exact.dropped, exact.invalid)
    close(inf.theta_hist, exact.theta_hist, 1e-5)
    errs = {}
    for b in (1, 8, 64):
        tr = run_scenario(ScenarioSpec(**base, primal=InexactPrimal(
            loss="quadratic", b_steps=b, lr=0.2)))
        errs[b] = (tr.theta_hist - exact.theta_hist).abs().max().item()
    assert errs[64] < errs[8] < errs[1] and errs[1] > 1e-2


# ---------------------------------------------------------------------------
# the nonlinear CL engine and the federated moons experiment
# ---------------------------------------------------------------------------


def test_federated_moons_problem_matches_jax():
    jt, jtrain, jtx, jty = jsyn.federated_moons_problem(n=12, n_test=32,
                                                        seed=1)
    tt, train, tx, ty = federated_moons_problem(n=12, n_test=32, seed=1,
                                                device=CPU)
    for f in jt.tables._fields:
        np.testing.assert_array_equal(getattr(tt.tables, f),
                                      getattr(jt.tables, f))
    np.testing.assert_array_equal(tt.groups, jt.groups)
    for f in ("x", "y", "mask"):
        np.testing.assert_array_equal(getattr(train, f).numpy(),
                                      np.asarray(getattr(jtrain, f)))
    np.testing.assert_array_equal(tx, jtx)
    np.testing.assert_array_equal(ty, jty)
    counts = train.counts.numpy()
    assert counts.min() >= 3 and counts.max() <= 8


def moons_run_kw(topo, data, sol, stream, primal, rounds, batch, rec,
                 mu, rho, cond):
    return ScenarioSpec(algo="cl", topology=topo, data=data, mu=mu, rho=rho,
                        conditions=cond, rounds=rounds, batch=batch,
                        record_every=rec, theta_sol=sol, stream=stream,
                        primal=primal, device=CPU)


def jax_stream(jt, cond, batch, seed, rounds):
    return jsched.precompute_event_stream(
        jt.device_tables(), jnp.asarray(jt.partition_halves()), cond, batch,
        seed, rounds)


def jax_mlp_agents():
    """JAX's warm start, stream and CL run with MLP agents (hidden 4)."""
    jm = jflat.MLPAgent(in_dim=2, hidden=(4,))
    jt, jtrain, _, _ = jsyn.federated_moons_problem(n=24, seed=0)
    sol = np.asarray(jprimal.solitary_adamw(jtrain, loss="logistic",
                                            model=jm, steps=50, seed=0))
    cond = jsched.NetworkConditions(drop_prob=0.1)
    js = jax_stream(jt, cond, 8, 1, 30)
    want = jeng.run_cl_scenario(
        jt, jtrain, 0.5, 0.5, cond, 30, 8, record_every=10, theta_sol=sol,
        stream=js, primal=jprimal.InexactPrimal(loss="logistic", model=jm,
                                                b_steps=4, lr=0.05))
    return {"sol": sol, "stream": as_numpy(js),
            "counts": (want.delivered, want.dropped, want.invalid,
                       want.rounds),
            "theta_hist": np.asarray(want.theta_hist)}


def jax_acceptance():
    """The acceptance configuration's JAX side: the agents' initial rows
    (``PRNGKey(0)``), 400 local AdamW steps from them, and the stream."""
    jm = jflat.MLPAgent(in_dim=2, hidden=(8,))
    jt, jtrain, _, _ = jsyn.federated_moons_problem(n=24, seed=0)
    keys = jax.random.split(jax.random.PRNGKey(0), 24)
    theta0 = jax.vmap(lambda k: jm.flattener().flatten(jm.init(k, 1.0)))(
        keys)
    jsol = jprimal.solitary_adamw(jtrain, loss="logistic", model=jm,
                                  steps=400, seed=0)
    js = jax_stream(jt, jsched.NetworkConditions(), 12, 0, 300)
    return as_numpy({"theta0": theta0, "sol": jsol, "stream": js})


def jax_references():
    """The JAX side of AdamW, the guarded losses, the MLP agent, the
    inexact primal and the two scenario tests (run in a subprocess of its
    own beside the tests before this module: tests/_port_session.py)."""
    return {"mlp_agents": jax_mlp_agents(), "acceptance": jax_acceptance(),
            "adamw": {case: jax_adamw(*case) for case in ADAMW},
            "guarded": {name: jax_guarded(name) for name in GUARDED},
            "mlp_agent": jax_mlp_agent(),
            "inexact": {case: jax_inexact(case) for case in INEXACT}}


refs = _port_session.reference_fixture(__name__)


def test_run_cl_scenario_mlp_agents_matches_jax(refs):
    _, jtrain, _, _ = jsyn.federated_moons_problem(n=24, seed=0)
    want = refs["mlp_agents"]
    sol = want["sol"]
    tt, _, _, _ = federated_moons_problem(n=24, seed=0, device=CPU)
    got = run_scenario(moons_run_kw(
        tt, convert.data_from_arrays(jtrain, CPU),
        convert.agent_rows_from_arrays(sol, CPU),
        convert.stream_from_arrays(want["stream"], CPU),
        InexactPrimal(loss="logistic", model=MLPAgent(2, (4,)), b_steps=4,
                      lr=0.05), 30, 8, 10, 0.5, 0.5,
        NetworkConditions(drop_prob=0.1)))
    assert (got.delivered, got.dropped, got.invalid, got.rounds) == \
        tuple(int(v) for v in want["counts"])
    close(got.theta_hist, want["theta_hist"], 1e-4)
    assert torch.isfinite(got.theta_hist).all()
    assert not np.allclose(got.theta_hist[-1].numpy(), sol)


def test_collaboration_beats_local_training_by_5_points(refs):
    """tests/test_primal.py's acceptance configuration on the JAX run's
    stream and JAX's initial parameter rows: collaborative CL-ADMM with
    MLP agents beats purely-local AdamW by at least 5 accuracy points."""
    tm = MLPAgent(2, (8,))
    tt, train, tx, ty = federated_moons_problem(n=24, seed=0, device=CPU)
    want = refs["acceptance"]
    sol = solitary_adamw(train, loss="logistic", model=tm, steps=400,
                         theta0=convert.agent_rows_from_arrays(
                             want["theta0"], CPU))
    # 400 local steps agree with JAX's to float32 rounding, compounded
    close(sol, want["sol"], 1e-4)
    pred = flat_predictor(tm)
    acc_sol = float(model_accuracy(sol, pred, tx, ty).mean())
    cond = NetworkConditions()
    tr = run_scenario(moons_run_kw(
        tt, train, sol, convert.stream_from_arrays(want["stream"], CPU),
        InexactPrimal(loss="logistic", model=tm, b_steps=10, lr=0.1), 300,
        12, 100, 0.5, 0.2, cond))
    acc = float(model_accuracy(tr.theta_hist[-1], pred, tx, ty).mean())
    assert acc - acc_sol >= 0.05, (acc, acc_sol)
