"""The port's model families on the CPU against the JAX package: MoE
(olmoe-1b-7b and phi3.5-moe, both ``moe_impl`` forms), RG-LRU with local
attention (recurrentgemma-2b), xLSTM (xlstm-1.3b, both ``mlstm_impl``
forms), the VLM (qwen2-vl-7b, M-RoPE and patch embeddings) and audio
(musicgen-medium, codebook embeddings and heads).

Each case is the arch's REDUCED config in float32 with
``attn_impl="chunked"`` and ``attn_chunk=8``, the JAX weights carried
across by ``convert.model_params_from_arrays``, on the same numpy inputs
from a seed: ``forward`` logits and aux, ``loss`` (total, ce and aux), a
prefill into a ring cache (12 slots for 16 positions; every cache leaf),
and three ring decode steps (logits and every cache leaf after them).
The JAX side runs under ``jax.jit``, once per arch, in a subprocess of
its own that starts with the port's first test (``jax_references``;
tests/_port_session.py), in the arch's default forms: the port's ``gather`` MoE and ``parallel``
mLSTM are held against it too (the JAX package holds its own two forms
equal, tests/test_parallel_forms.py), and the JAX forms themselves at the
block level (``moe_apply`` in both forms, ``_mlstm_parallel``).
Tolerance: the dense tests' ``ATOL`` of 5e-5 absolute
(tests/test_torch_lm.py) everywhere; the RG-LRU's log-depth scan sums in
another order than ``associative_scan`` and still meets it (measured
differences ~7e-6).

Also: ``moe_apply`` alone in both forms on inputs whose gates have no
ties and whose routing overflows the capacity; the parallel mLSTM with its
final state; the two MoE forms' logits bit for bit in the port; ``loss``'s gradient for olmoe; the training route
of ``attn_impl="flash"`` (``chunked_attention`` while autograd records,
as the JAX package off the TPU) with its gradient; ``chip_smoke.py``
6e's float32 RecurrentGemma cut, at a small width, through the flash
route against ``attn_impl="ref"``; ``apply_mrope``,
``delay_pattern`` / ``undelay_pattern``, the trainer's ``positions3``
split and the plain ``flash_attention`` at head dim 256 against JAX's;
every arch's parameter shapes.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import common as jcommon  # noqa: E402

import repro_torch.configs as tconfigs  # noqa: E402
import _port_session  # noqa: E402
from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from _port_session import port_background_jobs  # noqa: E402,F401
from _port_session import as_numpy  # noqa: E402
from repro_torch.convert import model_params_from_arrays  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.train.trainer import _split_batch  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ATOL = 5e-5
S, CACHE = 16, 12          # sequence (prefix included) and ring cache
CASES = {
    "olmoe": ("olmoe-1b-7b", {}),                         # scatter
    "olmoe-gather": ("olmoe-1b-7b", {"moe_impl": "gather"}),
    "phi3.5-moe": ("phi3.5-moe", {}),
    "recurrentgemma": ("recurrentgemma-2b", {}),
    "xlstm-scan": ("xlstm-1.3b", {}),
    "xlstm-parallel": ("xlstm-1.3b", {"mlstm_impl": "parallel"}),
    "qwen2-vl": ("qwen2-vl-7b", {}),
    "musicgen": ("musicgen-medium", {}),
}


def configs(arch, **kw):
    kw = dict(attn_impl="chunked", attn_chunk=8, **kw)
    return (dataclasses.replace(jconfigs.get_config(arch, "reduced"),
                                compute_dtype=jnp.float32, **kw),
            dataclasses.replace(tconfigs.get_config(arch, "reduced"),
                                compute_dtype=torch.float32, **kw))


def family_batch(cfg, seed, B=2):
    """The family's inputs for S positions in all: text tokens, or a
    VLM's patches on a 2 x 4 grid (t = 0) and text ids after them, or
    audio's conditioning and (B, K, S - n_cond) codes."""
    rng = np.random.default_rng(seed)
    d, V = cfg.d_model, cfg.vocab_size
    if cfg.family == "audio":
        n = cfg.n_cond_tokens
        tok = rng.integers(0, V, (B, cfg.n_codebooks, S - n)).astype(np.int32)
        return {"tokens": tok, "labels": np.roll(tok, -1, axis=-1),
                "cond_embeds": rng.standard_normal((B, n, d))
                .astype(np.float32)}
    if cfg.family == "vlm":
        n = cfg.n_media_tokens
        tok = rng.integers(0, V, (B, S - n)).astype(np.int32)
        p3 = np.zeros((3, B, S), np.int32)
        p3[1, :, :n] = np.arange(n) // 4
        p3[2, :, :n] = np.arange(n) % 4
        p3[:, :, n:] = np.arange(S - n) + 4
        return {"tokens": tok, "labels": np.roll(tok, -1, axis=-1),
                "patch_embeds": rng.standard_normal((B, n, d))
                .astype(np.float32), "positions3": p3}
    tok = rng.integers(0, V, (B, S)).astype(np.int32)
    return {"tokens": tok, "labels": np.roll(tok, -1, axis=-1)}


def decode_tokens(cfg, seed, steps=3, B=2):
    rng = np.random.default_rng(seed)
    shape = (B, cfg.n_codebooks) if cfg.family == "audio" else (B,)
    return [rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
            for _ in range(steps)]


def to_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def tparams_of(params):
    return jax.tree_util.tree_map(
        lambda a: torch.as_tensor(np.array(a, np.float32)), params)


def layer_slots(cfg):
    """(group, repetition, position in unit) of each layer, in order."""
    return [(g, r, i) for g, (unit, reps) in enumerate(cfg.scan_groups())
            for r in range(reps) for i in range(len(unit))]


def jax_run(arch):
    """The JAX side of one arch, in its default forms, jitted: the
    parameters (``init`` from ``PRNGKey(0)``), then ``forward``, ``loss``,
    a prefill into the ring cache and three ring decode steps on the
    family's inputs, as numpy."""
    jc, _ = configs(arch)
    jm = JModel(jc)
    params = jm.init(jax.random.PRNGKey(0))
    b = to_j(family_batch(jc, 1))
    out = {"params": params,
           "fwd": jax.jit(jm.forward)(params, b),
           "loss": jax.jit(jm.loss)(params, b),
           "prefill": jax.jit(lambda p, b: jm.prefill(p, b, CACHE))(
               params, b)}
    dec = jax.jit(lambda p, c, t: jm.decode_step(p, c, {"token": t},
                                                 ring=True))
    cache, out["decoded"] = out["prefill"][1], []
    for tok in decode_tokens(jc, 5):
        logits, cache = dec(params, cache, jnp.asarray(tok))
        out["decoded"].append(logits)
    out["dec_cache"] = cache
    return as_numpy(out)


def jax_references():
    """:func:`jax_run` of every arch of ``CASES``, olmoe's loss gradient
    and the flash route's training (run in a subprocess of its own beside
    the tests before this module: tests/_port_session.py)."""
    out = {"runs": {arch: jax_run(arch) for arch in dict.fromkeys(
        arch for arch, _ in CASES.values())}}
    out["olmoe_grad"] = jax_olmoe_gradient(
        out["runs"]["olmoe-1b-7b"]["params"])
    out["flash_training"] = jax_flash_training()
    return out


refs = _port_session.reference_fixture(__name__, first=True)


class Run:
    """One case: both models with the same weights, and the JAX side's
    outputs (jitted, :func:`jax_run`) for the arch's default forms."""

    def __init__(self, arch, kw, ref):
        self.jc, self.tc = configs(arch)
        self.tc = dataclasses.replace(self.tc, **kw)
        self.params = ref["params"]
        self.tm = TModel(self.tc, device="cpu")
        self.tm.load_state_dict(model_params_from_arrays(
            self.tc, self.params, device="cpu"))
        assert self.tm.param_count() == JModel(self.jc).param_count()
        self.batch = family_batch(self.tc, 1)
        self.tokens = decode_tokens(self.tc, 5)
        self.fwd, self.loss, self.prefill = (ref[k] for k in (
            "fwd", "loss", "prefill"))
        self.decoded, self.dec_cache = ref["decoded"], ref["dec_cache"]


@pytest.fixture(scope="module")
def runs(refs):
    made = {}

    def get(case):
        arch, kw = CASES[case]
        if arch not in made:
            made[arch] = Run(arch, {}, refs["runs"][arch])
        if case not in made:
            base = made[arch]
            run = made[case] = Run.__new__(Run)
            run.__dict__.update(base.__dict__)
            run.tc = dataclasses.replace(base.tc, **kw)
            run.tm = TModel(run.tc, device="cpu")
            run.tm.load_state_dict(base.tm.state_dict())
        return made[case]
    return get


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t, np.float32) if not isinstance(
        t, torch.Tensor) else t.detach().float().numpy(),
        np.asarray(j, np.float32), atol=atol, rtol=0)


def close_caches(cfg, tcache, jcache):
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for layer, (g, r, i) in zip(tcache["layers"], layer_slots(cfg)):
        want = jcache["layers"][g][f"b{i}"]
        assert sorted(layer) == sorted(want)
        for name, leaf in layer.items():
            assert leaf.dtype == torch.float32
            close(leaf, want[name][r])


# ---------------------------------------------------------------------------
# the families against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_jax(runs, case):
    run = runs(case)
    got = run.tm.forward(to_t(run.batch))
    want, _ = run.fwd
    assert got.shape == want.shape          # the prefix's logits dropped
    close(got, want)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_matches_jax(runs, case):
    """Through the training path (``Model.loss`` over the parameter tree):
    ce + router_aux_weight * aux, aux the MoE router loss summed over the
    layers (0 without experts), equal to forward's aux."""
    run = runs(case)
    total, metrics = run.tm.loss(tparams_of(run.params), to_t(run.batch))
    jtotal, jmetrics = run.loss
    close(total, jtotal)
    close(metrics["ce"], jmetrics["ce"])
    close(metrics["aux"], jmetrics["aux"])
    close(metrics["aux"], run.fwd[1])
    assert (float(jmetrics["aux"]) > 0) == (run.tc.n_experts > 0)


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_cache_matches_jax(runs, case):
    """A ring of 12 slots for 16 positions: attention layers keep the last
    12 tokens' k and v; recurrent layers their state after the last."""
    run = runs(case)
    logits, cache = run.tm.prefill(to_t(run.batch), cache_len=CACHE)
    jlogits, jcache = run.prefill
    assert logits.shape == jlogits.shape
    close(logits, jlogits)
    close_caches(run.tc, cache, jcache)


@pytest.mark.parametrize("case", list(CASES))
def test_decode_steps_match_jax(runs, case):
    run = runs(case)
    _, cache = run.tm.prefill(to_t(run.batch), cache_len=CACHE)
    for tok, want in zip(run.tokens, run.decoded):
        logits, cache = run.tm.decode_step(cache, {"token": torch.as_tensor(
            tok)}, ring=True)
        assert logits.shape == want.shape
        close(logits, want)
    close_caches(run.tc, cache, run.dec_cache)


def test_moe_forms_give_the_same_logits_bit_for_bit(runs):
    a, b = runs("olmoe"), runs("olmoe-gather")
    assert a.tc.moe_impl == "scatter" and b.tc.moe_impl == "gather"
    assert torch.equal(a.tm.forward(to_t(a.batch)),
                       b.tm.forward(to_t(b.batch)))


@pytest.mark.parametrize("impl", ["scatter", "gather"])
def test_moe_apply_matches_jax_with_drops(impl):
    """64 tokens, 4 experts, top 2, capacity factor 1 (32 slots an
    expert): some experts overflow and drop choices.  The gates of every
    token are distinct (no ties for top-k to break)."""
    jc, tc = configs("olmoe-1b-7b", moe_impl=impl, capacity_factor=1.0)
    rng = np.random.default_rng(11)
    d, f, E = tc.d_model, tc.d_ff, tc.n_experts
    w = {"router": rng.standard_normal((d, E)) * 0.2,
         "w_gate": rng.standard_normal((E, d, f)) / 16,
         "w_up": rng.standard_normal((E, d, f)) / 16,
         "w_down": rng.standard_normal((E, f, d)) / 12}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.standard_normal((2, 32, d)).astype(np.float32)
    gates = np.asarray(jax.nn.softmax(x.reshape(-1, d) @ w["router"]))
    assert all(len(np.unique(g)) == E for g in gates)
    top = np.argsort(-gates, axis=1)[:, :tc.top_k]
    C = int(np.ceil(64 * tc.top_k / E * tc.capacity_factor))
    assert np.bincount(top.ravel(), minlength=E).max() > C   # drops
    y, aux = tblocks.moe_apply(tc, as_params(w), torch.as_tensor(x))
    jy, jaux = jblocks.moe_apply(jc, w, jnp.asarray(x))
    close(y, jy)
    close(aux, jaux)


def test_mlstm_parallel_matches_jax():
    """The quadratic form with its cummax stabilizer and final-state
    handoff, on gates whose running max moves (large input gates)."""
    rng = np.random.default_rng(13)
    B, Sq, H, hd = 2, 12, 3, 8
    q, k, v = (rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
               for _ in range(3))
    ig = (3 * rng.standard_normal((B, Sq, H))).astype(np.float32)
    fg = np.asarray(jax.nn.log_sigmoid(rng.standard_normal((B, Sq, H))
                                       .astype(np.float32)))
    h, state = tblocks._mlstm_parallel(*map(torch.as_tensor,
                                            (q, k, v, ig, fg)))
    jh, jstate = jblocks._mlstm_parallel(*map(jnp.asarray,
                                              (q, k, v, ig, fg)))
    close(h, jh)
    for t, j in zip(state, jstate):
        close(t, j)


def as_params(w):
    from repro_torch.models.model import _as_block
    return _as_block({k: torch.as_tensor(v) for k, v in w.items()})


def jax_olmoe_gradient(params):
    """JAX's gradient of olmoe's loss at ``params`` on its inputs."""
    jc, _ = configs("olmoe-1b-7b")
    jm = JModel(jc)
    return as_numpy(jax.jit(jax.grad(lambda p, b: jm.loss(p, b)[0]))(
        params, to_j(family_batch(jc, 1))))


def test_olmoe_loss_gradient_matches_jax(runs, refs):
    run = runs("olmoe")
    jgrad = refs["olmoe_grad"]
    tp = tree_map(lambda a: a.requires_grad_(), tparams_of(run.params))
    loss, _ = run.tm.loss(tp, to_t(run.batch))
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    jleaves = jax.tree_util.tree_leaves(jgrad)
    assert len(grads) == len(jleaves)
    for g, j in zip(grads, jleaves):
        close(g, j, atol=1e-5)


def jax_flash_training():
    """JAX's parameters (``PRNGKey(3)``), loss and gradient of reduced
    llama3-8b with ``attn_impl="flash"`` off the TPU (interpret mode not
    asked for), on its inputs."""
    import os
    os.environ.pop("REPRO_PALLAS_INTERPRET", None)
    jc = dataclasses.replace(jconfigs.get_config("llama3-8b", "reduced"),
                             compute_dtype=jnp.float32, attn_impl="flash",
                             attn_chunk=8)
    jm = JModel(jc)
    params = jm.init(jax.random.PRNGKey(3))
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b)[0]))(params, to_j(family_batch(jc, 4)))
    return as_numpy({"params": params, "loss": jloss, "grad": jgrad})


def test_flash_trains_through_chunked_attention(refs):
    """``attn_impl="flash"`` while autograd records: ``chunked_attention``
    (the kernel has no backward), as the JAX package off the TPU; loss and
    gradient against JAX's with the same config."""
    tc = dataclasses.replace(tconfigs.get_config("llama3-8b", "reduced"),
                             compute_dtype=torch.float32, attn_impl="flash",
                             attn_chunk=8)
    want = refs["flash_training"]
    params, jloss, jgrad = want["params"], want["loss"], want["grad"]
    batch = family_batch(tc, 4)
    tm = TModel(tc, device="meta")
    tp = tree_map(lambda a: a.requires_grad_(), tparams_of(params))
    loss, _ = tm.loss(tp, to_t(batch))
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    close(loss, jloss)
    for g, j in zip(grads, jax.tree_util.tree_leaves(jgrad)):
        close(g, j, atol=1e-5)


def test_f32_prefill_6e_takes_the_flash_route(monkeypatch):
    """``chip_smoke.py`` 6e's model as 6e builds it (``f32_prefill_config``:
    RecurrentGemma-2B cut to 6 layers, its pattern to its first six
    entries, float32, ``attn_impl="flash"``), at a small width (d_model
    256, two heads of 256 on one kv head, a window of 200): a 512-token
    prefill through the ``attention`` op (on the CPU the plain
    ``flash_attention``, once an attention layer) equals the same weights'
    prefill through ``attn_impl="ref"`` within 1e-5."""
    import importlib.util
    import pathlib

    from repro_torch.kernels import dispatch

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    _, arch, layers, _ = next(c for c in cs.F32_PREFILLS if c[0] == "6e")
    cfg = cs.f32_prefill_config(torch, arch, layers)
    assert cfg.n_layers == 6 and cfg.hd == 256
    assert cfg.pattern == tconfigs.get_config(arch).pattern[:6]
    assert cfg.compute_dtype == torch.float32 and cfg.attn_impl == "flash"
    n_attn = sum(kind.startswith("attn") for kind in cfg.layer_kinds)
    assert n_attn == 2
    small = dataclasses.replace(cfg, d_model=256, n_heads=2, head_dim=256,
                                d_ff=512, lru_dim=256, vocab_size=512,
                                local_window=200)
    plain = dispatch._REGISTRY["attention"]["reference"]
    calls = []

    def counted(*args, **kw):
        calls.append(kw.get("window"))
        return plain(*args, **kw)

    monkeypatch.setitem(dispatch._REGISTRY["attention"], "reference",
                        counted)
    tok = torch.as_tensor(np.random.default_rng(6).integers(0, 512,
                                                             (1, 512)))
    out = {}
    for impl in ("flash", "ref"):
        model = TModel(dataclasses.replace(small, attn_impl=impl),
                       device="cpu").init(torch.Generator().manual_seed(0))
        out[impl], _ = model.prefill({"tokens": tok}, cache_len=512)
    assert calls == [200] * n_attn
    assert torch.isfinite(out["flash"]).all()
    torch.testing.assert_close(out["flash"], out["ref"], atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


def test_apply_mrope_matches_jax():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 9, 3, 64)).astype(np.float32)
    p3 = rng.integers(0, 500, (3, 2, 9)).astype(np.int32)
    got = tcommon.apply_mrope(torch.as_tensor(x), torch.as_tensor(p3), 1e6,
                              (8, 12, 12))
    want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(p3), 1e6,
                               (8, 12, 12))
    close(got, want, atol=2e-5)
    same = np.broadcast_to(p3[:1], p3.shape)       # text: plain RoPE
    close(tcommon.apply_mrope(torch.as_tensor(x), torch.as_tensor(same),
                              1e6, (8, 12, 12)),
          tcommon.apply_rope(torch.as_tensor(x), torch.as_tensor(same[0]),
                             1e6), atol=0)


def test_delay_pattern_matches_jax():
    tok = np.random.default_rng(2).integers(0, 2048, (2, 4, 7)) \
        .astype(np.int32)
    got = tsyn.delay_pattern(tok, pad_id=2048)
    np.testing.assert_array_equal(got, jsyn.delay_pattern(tok, 2048))
    assert got.shape == (2, 4, 10) and got.dtype == tok.dtype
    np.testing.assert_array_equal(tsyn.undelay_pattern(got), tok)
    np.testing.assert_array_equal(tsyn.undelay_pattern(got),
                                  jsyn.undelay_pattern(got))


@pytest.mark.parametrize("A", [2, 3])
def test_split_batch_moves_positions3_as_jax(A):
    """(3, B, S) -> (A, 3, B/A, S), the reference trainer's own expression
    (``src/repro/train/trainer.py``, ``split_batch``); other leaves split
    on axis 0."""
    B = 6
    p3 = np.arange(3 * B * 5, dtype=np.int32).reshape(3, B, 5)
    tok = np.arange(B * 5, dtype=np.int32).reshape(B, 5)
    got = _split_batch({"positions3": p3, "tokens": tok}, A, "cpu")
    moved = jnp.moveaxis(jnp.asarray(p3), 0, 1)
    want = jnp.moveaxis(moved.reshape((A, B // A) + moved.shape[1:]), 2, 1)
    np.testing.assert_array_equal(got["positions3"].numpy(),
                                  np.asarray(want))
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  tok.reshape(A, B // A, 5))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_attention_hd256_matches_pallas(dtype):
    """RecurrentGemma's attention shape cut down: head dim 256, MQA,
    window 16, against the Pallas kernel in interpret mode (blocks of 32);
    the JAX package's tolerances (tests/test_kernels.py)."""
    B, Sq, H, K, hd = 1, 128, 2, 1, 256
    rng = np.random.default_rng(256)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sq, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sq, K, hd)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else \
        (jnp.bfloat16, torch.bfloat16)
    got = tfa.flash_attention(*(torch.as_tensor(a).to(tdt)
                                for a in (q, k, v)), window=16)
    want = jops.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                window=16, block_q=32, block_k=32)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    tfa._check(*(torch.zeros((B, Sq, h, hd), dtype=tdt)
                 for h in (H, K, K)), 16)        # inside the kernel's contract


def test_linear_scan_matches_the_recurrence():
    rng = np.random.default_rng(9)
    a = torch.as_tensor(rng.uniform(0.5, 1.0, (2, 37, 5)))
    b = torch.as_tensor(rng.standard_normal((2, 37, 5)))
    h, want = torch.zeros(2, 5, dtype=torch.float64), []
    for t in range(37):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(tblocks.linear_scan(a, b),
                               torch.stack(want, 1), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_parameter_tree_matches_jax(arch):
    """Every arch's FULL parameter tree, leaf by leaf, against the JAX
    package's (shapes only: no weights are drawn)."""
    cfg = tconfigs.get_config(arch)
    want = JModel(jconfigs.get_config(arch)).abstract_params()
    got = TModel(cfg, device="meta").abstract_params()
    wl, wt = jax.tree_util.tree_flatten(want)
    assert [tuple(a.shape) for a in tree_leaves(got)] == \
        [tuple(a.shape) for a in wl]


def test_init_follows_the_jax_rule():
    """recurrentgemma's lam: sigmoid(lam) in [0.9, 0.999]; the router and
    the mLSTM gates drawn at 0.02; norms zero."""
    cfg = tconfigs.get_config("recurrentgemma-2b", "reduced")
    p = TModel(cfg, device="meta").init_params(
        torch.Generator().manual_seed(0), "cpu")
    lam = p["groups"][0]["b0"]["mixer"]["lam"]
    a = torch.sigmoid(lam)
    assert float(a.min()) >= 0.9 - 1e-6 and float(a.max()) <= 0.999 + 1e-6
    assert float(p["groups"][0]["b0"]["norm1"].abs().max()) == 0.0
    moe = TModel(tconfigs.get_config("olmoe-1b-7b", "reduced"),
                 device="cpu").init(torch.Generator().manual_seed(0))
    assert abs(float(moe.layers[0].ffn.router.float().std()) - 0.02) < 3e-3
    x = TModel(tconfigs.get_config("xlstm-1.3b", "reduced"),
               device="cpu").init(torch.Generator().manual_seed(0))
    assert abs(float(x.layers[0].mixer.w_igate.float().std()) - 0.02) < 4e-3
    assert float(x.layers[0].mixer.skip_gamma.abs().max()) == 0.0
