"""The port's personalized LM training on the CPU against the JAX package.

* ``Graph`` (``D``, ``laplacian``, ``neighbors``, ``edge_coloring``) and
  the LM token stream, exactly equal to JAX's;
* ``cross_entropy`` with ignored labels, and ``Model.loss`` of a tiny
  dense model (2 layers, d_model 32, vocab 64) with JAX's parameters
  carried across: 1e-5 in float32 (the same sums in another order), 1e-2
  relative with bf16 compute (bf16 rounds activations at other places);
* every coupling mode's ``make_coupling`` against JAX's within 1e-5, mp
  also with ``mix_dtype=bfloat16``; ``schedule="gossip"`` on a LocalMesh
  of the agents within 1e-5 of the dense schedule (the JAX bar,
  tests/test_coupling.py), and refused without a mesh;
* three ``make_train_step`` steps per coupling mode from JAX's state
  carried across (``convert.train_state_from_arrays``), in float32:
  loss and grad_norm within 1e-5 relative, params within 1e-5 with
  float32 moments, and within ``3 * lr * 2**-8`` with the default bf16
  moments (a float32 difference in the last bit of m or v can round
  the bf16 moment one ulp, 2^-8 relative, the other way, which moves
  that step's update by up to lr * 2^-8);
* checkpoints written by either package loading in the other, bit for
  bit, bf16 moments included.
"""

import dataclasses
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import random_geometric_graph as jrgg  # noqa: E402
from repro.coupling import CouplingConfig as JCC  # noqa: E402
from repro.coupling import make_coupling as jmake_coupling  # noqa: E402
from repro.coupling import make_state as jmake_state  # noqa: E402
from repro.data import PersonalizedLMConfig as JLMC  # noqa: E402
from repro.data import make_lm_batches as jbatches  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import ModelConfig as JModelConfig  # noqa: E402
from repro.models.common import cross_entropy as jce  # noqa: E402
from repro.optim import AdamWConfig as JAdam  # noqa: E402
from repro.train import TrainConfig as JTC  # noqa: E402
from repro.train import load_checkpoint as jload  # noqa: E402
from repro.train import make_train_step as jmake_step  # noqa: E402
from repro.train import save_checkpoint as jsave  # noqa: E402
from repro.train.trainer import init_train_state as jinit  # noqa: E402

import _port_session  # noqa: E402
from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from _port_session import port_background_jobs  # noqa: E402,F401
from _port_session import as_numpy  # noqa: E402
from repro_torch.convert import (tensor_from_array,  # noqa: E402
                                 train_state_from_arrays)
from repro_torch.core.graph import random_geometric_graph  # noqa: E402
from repro_torch.coupling import (CouplingConfig, gossip_mix_tree,  # noqa: E402
                                  make_coupling, make_state)
from repro_torch.data import PersonalizedLMConfig  # noqa: E402
from repro_torch.data import make_lm_batches  # noqa: E402
from repro_torch.models import Model, ModelConfig  # noqa: E402
from repro_torch.models.common import cross_entropy  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_update, adamw_update_)
from repro_torch.train import (TrainConfig, TrainState,  # noqa: E402
                               init_train_state, load_checkpoint,
                               make_train_step, save_checkpoint,
                               train_loop)
from repro_torch.tree import tree_leaves, tree_map, tree_paths  # noqa: E402

TINY = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=4,
            n_kv_heads=2, d_ff=64, vocab_size=64, attn_impl="ref",
            remat=False)


def models(compute="float32", **over):
    kw = dict(TINY, **over)
    return (JModel(JModelConfig(**kw, compute_dtype=getattr(jnp, compute))),
            Model(ModelConfig(**kw, compute_dtype=getattr(torch, compute)),
                  device="meta"))


def carry(tree):
    return tree_map(lambda a: tensor_from_array(a, "cpu"), tree)


def as_np(t):
    return t.detach().float().numpy()


def state_leaves(s):
    """A TrainState's leaves in the JAX package's order (fields in order)."""
    return tree_leaves((s.params, s.opt_state, s.solitary, s.step))


# ---------------------------------------------------------------------------
# graph and data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,k,seed", [(8, 2, 1), (16, 3, 0), (32, 3, 2),
                                      (30, 5, 3)])
def test_graph_operators_and_edge_coloring_match(n, k, seed):
    j, t = jrgg(n, k=k, seed=seed), random_geometric_graph(n, k=k, seed=seed)
    np.testing.assert_array_equal(t.D, j.D)
    np.testing.assert_array_equal(t.laplacian, j.laplacian)
    for i in (0, n // 2, n - 1):
        np.testing.assert_array_equal(t.neighbors(i), j.neighbors(i))
    assert t.edge_coloring() == j.edge_coloring()


def test_edge_coloring_heaviest_first_with_ties_in_edge_order():
    from repro.core.graph import Graph as JGraph
    from repro_torch.core.graph import Graph
    rng = np.random.default_rng(0)
    W = rng.integers(1, 4, (12, 12)).astype(float)
    W = np.triu(W, 1) * (rng.random((12, 12)) < 0.5)
    W = W + W.T
    assert Graph(W).edge_coloring() == JGraph(W).edge_coloring()


def test_lm_batches_match_token_for_token():
    g = random_geometric_graph(6, k=2, seed=0)
    kw = dict(vocab_size=40, n_agents=6, seq_len=12, batch_per_agent=3,
              seed=4)
    got = make_lm_batches(PersonalizedLMConfig(**kw), g, 3)
    want = jbatches(JLMC(**kw), jrgg(6, k=2, seed=0), 3)
    for a, b in zip(got, want):
        assert a.dtype == np.int32 and a.shape == (6, 3, 13)
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def ce_inputs():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 7)).astype(np.float32)
    labels = rng.integers(-1, 7, (2, 5)).astype(np.int32)
    mask = rng.random((2, 5)) < 0.7
    return logits, labels, mask


def jax_cross_entropy():
    """JAX's loss on ``ce_inputs`` without and with the mask."""
    logits, labels, mask = ce_inputs()
    return [float(jce(jnp.asarray(logits), jnp.asarray(labels),
                      None if m is None else jnp.asarray(m)))
            for m in (None, mask)]


def test_cross_entropy_ignores_negative_labels(refs):
    logits, labels, mask = ce_inputs()
    for m, want in zip((None, mask), refs["cross_entropy"]):
        got = cross_entropy(torch.as_tensor(logits), torch.as_tensor(labels),
                            None if m is None else torch.as_tensor(m))
        np.testing.assert_allclose(float(got), want, rtol=1e-6)
    none = torch.full((2, 5), -1)
    assert float(cross_entropy(torch.as_tensor(logits), none)) == 0.0


LOSS_CASES = [("float32", False, 1e-5), ("float32", True, 1e-5),
              ("bfloat16", True, 1e-2)]


def loss_batch():
    rng = np.random.default_rng(2)
    tok = rng.integers(0, 64, (3, 17)).astype(np.int32)
    labels = tok[:, 1:].copy()
    labels[0, :4] = -1
    return {"tokens": tok[:, :-1], "labels": labels}


def jax_loss(compute, remat):
    """JAX's parameters from ``PRNGKey(1)`` and its jitted ``loss`` of
    them on :func:`loss_batch`."""
    jm, _ = models(compute, remat=remat)
    params = jm.init(jax.random.PRNGKey(1))
    want, wm = jax.jit(jm.loss)(params, {k: jnp.asarray(v)
                                         for k, v in loss_batch().items()})
    return as_numpy({"params": params, "loss": want, "ce": wm["ce"]})


@pytest.mark.parametrize("compute,remat,rtol", LOSS_CASES)
def test_model_loss_matches_jax(refs, compute, remat, rtol):
    _, tm = models(compute, remat=remat)
    want = refs["loss"][compute, remat]
    got, gm = tm.loss(carry(want["params"]), {
        k: torch.as_tensor(v) for k, v in loss_batch().items()})
    np.testing.assert_allclose(float(got), float(want["loss"]), rtol=rtol)
    np.testing.assert_allclose(float(gm["ce"]), float(want["ce"]),
                               rtol=rtol)
    assert float(gm["aux"]) == 0.0


def test_param_tree_layout_and_init_rule(refs):
    _, tm = models()
    jp = refs["init"]                     # JAX's PRNGKey(0) parameters
    tp = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path) for path, _ in
              jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert [p for p, _ in tree_paths(tp)] == jpaths
    for (_, t), j in zip(tree_paths(tp), jax.tree_util.tree_leaves(jp)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
        if j.ndim in (1, 2) and not np.asarray(j).any():     # the norms
            assert not t.any()
    emb = tp["embed"]
    assert 0.015 < float(emb.std()) < 0.025


def test_flash_attention_route_does_not_train():
    """The kernel has no backward, so while autograd records the flash
    route trains through ``chunked_attention`` (as the JAX package does
    off the TPU): the same loss as ``attn_impl="chunked"``, and a
    gradient."""
    _, tm = models(attn_impl="flash", attn_chunk=4)
    _, tc = models(attn_impl="chunked", attn_chunk=4)
    params = tm.init_params(torch.Generator().manual_seed(0), device="cpu")
    tok = torch.as_tensor(np.random.default_rng(0).integers(0, 8, (1, 8)))
    leaves = [a.requires_grad_() for a in tree_leaves(params)]
    loss, _ = tm.loss(params, {"tokens": tok, "labels": tok})
    assert torch.equal(loss, tc.loss(params, {"tokens": tok,
                                              "labels": tok})[0])
    grads = torch.autograd.grad(loss, leaves)
    assert all(torch.isfinite(g).all() for g in grads)


# ---------------------------------------------------------------------------
# coupling
# ---------------------------------------------------------------------------


def stacked_tree(A, seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((A, 8, 16)).astype(np.float32),
            "b": rng.standard_normal((A, 5)).astype(np.float32),
            "g": [rng.standard_normal((A, 3, 4)).astype(np.float32)]}


COUPLINGS = [("none", "float32"), ("consensus", "float32"), ("mp", "float32"),
             ("mp", "bfloat16"), ("cl", "float32"), ("consensus", "bfloat16")]
COUPLING_A, COUPLING_KW = 7, dict(alpha=0.9, mu=0.03, every=3)


def jax_coupling(mode, mix_dtype):
    """JAX's coupling on ``stacked_tree``s at steps 0, 1 and 3 (each
    step's leaves), and its state's send_to."""
    A = COUPLING_A
    conf = np.linspace(0.2, 1.0, A)
    jstate = jmake_state(jrgg(A, k=3, seed=5), conf, 0.9)
    japply = jmake_coupling(JCC(mode=mode, **COUPLING_KW,
                                mix_dtype=getattr(jnp, mix_dtype)), jstate)
    params, sol = stacked_tree(A, 0), stacked_tree(A, 1)
    steps = [[np.asarray(b) for b in jax.tree_util.tree_leaves(japply(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, sol),
        jnp.asarray(step, jnp.int32)))] for step in (0, 1, 3)]
    return {"send_to": jstate.send_to, "steps": steps}


@pytest.mark.parametrize("mode,mix_dtype", COUPLINGS)
def test_make_coupling_matches_jax(refs, mode, mix_dtype):
    A = COUPLING_A
    tg = random_geometric_graph(A, k=3, seed=5)
    conf = np.linspace(0.2, 1.0, A)
    want = refs["coupling"][mode, mix_dtype]
    state = make_state(tg, conf, 0.9, device="cpu")
    assert state.send_to == want["send_to"]
    tapply = make_coupling(CouplingConfig(
        mode=mode, **COUPLING_KW, mix_dtype=getattr(torch, mix_dtype)),
        state)
    params, sol = stacked_tree(A, 0), stacked_tree(A, 1)
    for step, want_step in zip((0, 1, 3), want["steps"]):
        got = tapply(carry(params), carry(sol), torch.tensor(step))
        for a, b in zip(tree_leaves(got), want_step):
            np.testing.assert_allclose(as_np(a), b, atol=1e-5)
        if step % 3:
            for a, b in zip(tree_leaves(got), tree_leaves(params)):
                np.testing.assert_array_equal(as_np(a), b)


def test_gossip_schedule_waits_for_item_10():
    """The gossip schedule, which once waited for the multi-device slice:
    on a LocalMesh of the agents, one matching at a time, it equals the
    dense schedule within 1e-5 in float32 (with bf16 leaves within 2^-8
    of the leaves' largest value: as in JAX, the dense schedule rounds
    A_mix to bf16 and the gossip one keeps its float32 weights, and the
    rows of A_mix and the anchor sum to at most 1), through
    ``make_coupling`` and ``gossip_mix_tree``; without a mesh it is
    refused, as in JAX."""
    from repro_torch.launch import LocalMesh
    A = 7
    g = random_geometric_graph(A, k=3, seed=5)
    state = make_state(g, np.linspace(0.2, 1.0, A), 0.9, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        make_coupling(CouplingConfig(mode="mp", schedule="gossip"), state)
    mesh = LocalMesh(A, "cpu")
    params, sol = stacked_tree(A, 0), stacked_tree(A, 1)
    top = max(np.abs(a).max() for a in tree_leaves((params, sol)))
    for dtype, atol in ((torch.float32, 1e-5), (torch.bfloat16,
                                                2**-8 * top)):
        kw = dict(mode="mp", alpha=0.9, mix_dtype=dtype)
        dense = make_coupling(CouplingConfig(**kw), state)(
            carry(params), carry(sol), 0)
        gossip = make_coupling(CouplingConfig(**kw, schedule="gossip"),
                               state, mesh=mesh)(carry(params), carry(sol),
                                                 0)
        tree = gossip_mix_tree(carry(params), carry(sol), state,
                               CouplingConfig(**kw), mesh)
        for a, b, t in zip(tree_leaves(gossip), tree_leaves(dense),
                           tree_leaves(tree)):
            np.testing.assert_allclose(as_np(a), as_np(b), atol=atol,
                                       rtol=0)
            assert torch.equal(a, t)


# ---------------------------------------------------------------------------
# optimizer and train step
# ---------------------------------------------------------------------------


def test_in_place_adamw_equals_the_functional_one():
    rng = np.random.default_rng(0)
    params = {"a": torch.as_tensor(rng.standard_normal((3, 70)),
                                   dtype=torch.float32),
              "b": torch.as_tensor(rng.standard_normal((2, 5)),
                                   dtype=torch.float32)}
    cfg = AdamWConfig(lr=0.05)
    state = adamw_init(params, cfg)
    p2 = tree_map(torch.clone, params)
    m2, v2 = tree_map(torch.clone, state["m"]), tree_map(torch.clone,
                                                          state["v"])
    count = state["count"]
    for step in range(3):
        grads = tree_map(lambda p: torch.as_tensor(
            rng.standard_normal(p.shape) * 4, dtype=torch.float32), params)
        params, state, gn = adamw_update(grads, state, params, cfg, 0.7)
        count, gn2 = adamw_update_(
            tree_leaves(p2), tree_leaves(grads), tree_leaves(m2),
            tree_leaves(v2), count, cfg, 0.7)
        assert torch.equal(gn, gn2)
    assert int(count) == int(state["count"]) == 3
    for a, b in zip(tree_leaves((params, state["m"], state["v"])),
                    tree_leaves((p2, m2, v2))):
        assert torch.equal(a, b)


def test_in_place_adamw_slabs_keep_the_values(monkeypatch):
    import repro_torch.optim.adamw as ad
    rng = np.random.default_rng(1)
    p = torch.as_tensor(rng.standard_normal(1000), dtype=torch.float32)
    g = torch.as_tensor(rng.standard_normal(1000), dtype=torch.float32)
    cfg = AdamWConfig()
    outs = []
    for size in (ad.CHUNK, 64):
        monkeypatch.setattr(ad, "CHUNK", size)
        pp, st = p.clone(), adamw_init(p, cfg)
        m, v = st["m"], st["v"]
        ad.adamw_update_([pp], [g], [m], [v], st["count"], cfg)
        outs.append((pp, m, v))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


STEP_CASES = [("none", "float32"), ("consensus", "float32"),
              ("mp", "float32"), ("cl", "float32"), ("mp", "bfloat16")]
STEP_A, STEP_LR = 4, 1e-2


def step_configs(mode, moment, A=STEP_A, lr=STEP_LR):
    kw = dict(mode=mode, every=2, alpha=0.9, mu=0.05)
    jt = JTC(n_agents=A, steps=10, coupling=JCC(**kw),
             optimizer=JAdam(lr=lr, moment_dtype=getattr(jnp, moment)))
    tt = TrainConfig(n_agents=A, steps=10, coupling=CouplingConfig(**kw),
                     optimizer=AdamWConfig(lr=lr, moment_dtype=getattr(
                         torch, moment)))
    return jt, tt


def step_batches(A=STEP_A):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(3):
        tok = rng.integers(0, 64, (A * 2, 9)).astype(np.int32)
        out.append({"tokens": tok[:, :-1], "labels": tok[:, 1:]})
    return out


def jax_steps(mode, moment):
    """JAX's initial state (``PRNGKey(0)``, perturb 0.01) and three jitted
    ``make_train_step`` steps on :func:`step_batches`: each step's
    metrics, and the state after the last."""
    jm, _ = models()
    jt, _ = step_configs(mode, moment)
    js = jinit(jm, jt, jax.random.PRNGKey(0), perturb=0.01)
    jstep = jax.jit(jmake_step(jm, jt, jmake_state(jrgg(STEP_A, k=2,
                                                        seed=0), None, 0.9)))
    out = {"init": js, "metrics": []}
    for batch in step_batches():
        js, jmet = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        out["metrics"].append({k: jmet[k] for k in (
            "loss", "grad_norm", "ce", "loss_per_agent")})
    out["params"], out["solitary"], out["step"] = \
        js.params, js.solitary, js.step
    return as_numpy(out)


def jax_references():
    """The JAX side of the loss, parameter-tree, coupling, train-step and
    checkpoint tests (run in a subprocess of its own beside the tests
    before this module: tests/_port_session.py)."""
    return {"loss": {(c, r): jax_loss(c, r) for c, r, _ in LOSS_CASES},
            "steps": {case: jax_steps(*case) for case in STEP_CASES},
            "cross_entropy": jax_cross_entropy(),
            "init": as_numpy(models()[0].init(jax.random.PRNGKey(0))),
            "coupling": {case: jax_coupling(*case) for case in COUPLINGS},
            "checkpoint": jax_checkpoint_state()}


refs = _port_session.reference_fixture(__name__)


@pytest.mark.parametrize("mode,moment", STEP_CASES)
def test_three_train_steps_match_jax(refs, mode, moment):
    _, tm = models()
    _, tt = step_configs(mode, moment)
    want = refs["steps"][mode, moment]
    ts = train_state_from_arrays(want["init"], device="cpu")
    tstep = make_train_step(tm, tt, make_state(
        random_geometric_graph(STEP_A, k=2, seed=0), None, 0.9,
        device="cpu"))
    for batch, jmet in zip(step_batches(), want["metrics"]):
        ts, tmet = tstep(ts, batch)
        for key in ("loss", "grad_norm", "ce"):
            np.testing.assert_allclose(float(tmet[key]), float(jmet[key]),
                                       rtol=1e-5)
        np.testing.assert_allclose(as_np(tmet["loss_per_agent"]),
                                   np.asarray(jmet["loss_per_agent"]),
                                   rtol=1e-5)
    atol = 1e-5 if moment == "float32" else 3 * STEP_LR * 2 ** -8
    assert int(ts.step) == int(want["step"]) == 3
    for a, b in zip(tree_leaves((ts.params, ts.solitary)),
                    jax.tree_util.tree_leaves((want["params"],
                                               want["solitary"]))):
        np.testing.assert_allclose(as_np(a), np.asarray(b), atol=atol)


def test_consensus_leaves_agents_equal_and_loop_logs():
    _, tm = models()
    A = 3
    tt = TrainConfig(n_agents=A, steps=4, log_every=2,
                     coupling=CouplingConfig(mode="consensus"))
    state = init_train_state(tm, tt, torch.Generator().manual_seed(0),
                             perturb=0.05, device="cpu")
    batches = [{"tokens": b[..., :-1].reshape(A * 2, 8),
                "labels": b[..., 1:].reshape(A * 2, 8)}
               for b in make_lm_batches(PersonalizedLMConfig(
                   vocab_size=64, n_agents=A, seq_len=8, batch_per_agent=2),
                   random_geometric_graph(A, k=2, seed=0), 5)]
    lines = []
    state, hist = train_loop(tm, tt, make_state(
        random_geometric_graph(A, k=2, seed=0), device="cpu"), batches,
        state=state, log=lines.append)
    assert [h["step"] for h in hist] == [0, 2, 3] and len(lines) == 3
    assert int(state.step) == 4
    for leaf in tree_leaves(state.params):
        assert torch.equal(leaf[0], leaf[1]) and torch.equal(leaf[0], leaf[2])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def jax_checkpoint_state():
    """JAX's two-agent train state from ``PRNGKey(0)``, its moments
    redrawn in bf16 and its step at 4 (numpy leaves)."""
    jm, _ = models()
    js = jinit(jm, JTC(n_agents=2, steps=1), jax.random.PRNGKey(0),
               perturb=0.1)
    rng = np.random.default_rng(0)
    moments = {k: jax.tree_util.tree_map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape), jnp.bfloat16), js.opt_state[k])
        for k in ("m", "v")}
    js = dataclasses.replace(js, opt_state=dict(
        js.opt_state, **moments, count=jnp.asarray(4, jnp.int32)),
        step=jnp.asarray(4, jnp.int32))
    return as_numpy(js)


def test_checkpoints_cross_load_both_ways(refs):
    js = jax.tree_util.tree_map(jnp.asarray, refs["checkpoint"])
    ts = train_state_from_arrays(js, device="cpu")
    assert ts.opt_state["m"]["embed"].dtype == torch.bfloat16
    with tempfile.TemporaryDirectory() as d:
        jsave(js, d, step=3)
        got, step = load_checkpoint(ts, d)
        assert step == 3 and isinstance(got, TrainState)
        for a, b in zip(state_leaves(got), jax.tree_util.tree_leaves(js)):
            assert a.dtype == tensor_from_array(b, "cpu").dtype
            np.testing.assert_array_equal(as_np(a), np.asarray(b, np.float32))
    with tempfile.TemporaryDirectory() as d:
        path = save_checkpoint(ts, d, step=5)
        assert path.endswith("step_00000005")
        got, step = jload(js, d)
        assert step == 5
        for a, b, like in zip(jax.tree_util.tree_leaves(got),
                              state_leaves(ts),
                              jax.tree_util.tree_leaves(js)):
            assert a.dtype == like.dtype
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          as_np(b))
        with pytest.raises(KeyError, match="missing leaf"):
            load_checkpoint({"nope": torch.zeros(1)}, d)
    with tempfile.TemporaryDirectory() as d:
        with pytest.raises(FileNotFoundError):
            load_checkpoint(ts, d)
