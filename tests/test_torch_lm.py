"""The port's LM serving path on the CPU against the JAX package.

* the config copies, field by field, and the basic layers;
* ``Model.forward``, ``prefill`` (with a ring cache) and ``decode_step``
  (per request and lockstep, ring and not, past the end of a cache) of
  REDUCED llama3-8b (GQA) and REDUCED starcoder2-15b (window 16, GELU)
  with ``compute_dtype=float32``, the weights carried across by
  ``convert.model_params_from_arrays``, over all three attention routes
  (``attn_chunk=8``; the ``flash`` route runs the Pallas kernel in
  interpret mode on the JAX side and the kernel's plain version here).
  Tolerance 5e-5 on logits of magnitude ~5 (measured differences ~6e-6:
  float32 sums in another order);
* greedy ``Engine.run`` against JAX ``Engine.run``, token for token, on
  the cases of tests/test_serve_engine.py: slot recycling, EOS mid-budget
  and on the first decoded token, the tick budget running out.  The model
  is that file's, in float32 so that equal greedy tokens are expected.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.models import ModelConfig as JModelConfig  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402

import repro_torch.configs as tconfigs  # noqa: E402
from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from repro_torch.convert import model_params_from_arrays  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.models import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.serve import Engine as TEngine  # noqa: E402
from repro_torch.serve import ServeConfig as TServeConfig  # noqa: E402
from repro_torch.serve import sample_token  # noqa: E402

ATOL = 5e-5


def fields_of(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if f.name in ("param_dtype", "compute_dtype"):     # by name
            v = str(v).removeprefix("torch.") \
                if isinstance(v, torch.dtype) else jnp.dtype(v).name
        out[f.name] = v
    return out


# ---------------------------------------------------------------------------
# configs and layers
# ---------------------------------------------------------------------------


def test_config_fields_and_defaults_match():
    assert [f.name for f in dataclasses.fields(TModelConfig)] == \
        [f.name for f in dataclasses.fields(JModelConfig)]
    kw = dict(name="x", family="dense", n_layers=1, d_model=8, n_heads=2,
              n_kv_heads=1, d_ff=16, vocab_size=10)
    assert fields_of(TModelConfig(**kw)) == fields_of(JModelConfig(**kw))


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
@pytest.mark.parametrize("variant", ["full", "reduced"])
def test_config_copies_match(arch, variant):
    t = tconfigs.get_config(arch, variant)
    j = jconfigs.get_config(arch, variant)
    assert fields_of(t) == fields_of(j)
    assert t.hd == j.hd and t.scan_groups() == j.scan_groups()


def test_aliases_and_unported_archs():
    """Every arch of the JAX package is ported: the same list in the same
    order, and every alias resolves to the same config as JAX's."""
    assert tconfigs.ALIASES == jconfigs.ALIASES
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert tconfigs.get_config("llama3-8b") == \
        tconfigs.get_config("llama3_8b")
    for alias in jconfigs.ALIASES:
        assert fields_of(tconfigs.get_config(alias)) == \
            fields_of(jconfigs.get_config(alias))
    with pytest.raises(KeyError):
        tconfigs.get_config("gpt-2")


def test_basic_layers_match():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    g = rng.standard_normal(16).astype(np.float32)
    pos = rng.integers(0, 300, (2, 5))
    np.testing.assert_allclose(
        tcommon.rms_norm(torch.as_tensor(x), torch.as_tensor(g)).numpy(),
        np.asarray(jcommon.rms_norm(x, g)), atol=1e-5)
    np.testing.assert_allclose(
        tcommon.apply_rope(torch.as_tensor(x), torch.as_tensor(pos),
                           10000.0).numpy(),
        np.asarray(jcommon.apply_rope(x, jnp.asarray(pos), 10000.0)),
        atol=2e-5)
    h = rng.standard_normal((4, 8)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32) / 3
         for s in ((8, 12), (8, 12), (12, 8))]
    for tf, jf in ((tcommon.swiglu, jcommon.swiglu),
                   (tcommon.gelu_glu, jcommon.gelu_glu)):
        np.testing.assert_allclose(
            tf(torch.as_tensor(h), *map(torch.as_tensor, w)).numpy(),
            np.asarray(jf(h, *w)), atol=1e-5)


# ---------------------------------------------------------------------------
# Model against JAX
# ---------------------------------------------------------------------------


def pair(arch, impl, monkeypatch):
    """The same REDUCED model in both frameworks, float32, chunk 8."""
    if impl == "flash":       # the JAX side runs the Pallas kernel
        monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
    jc = dataclasses.replace(jconfigs.get_config(arch, "reduced"),
                             compute_dtype=jnp.float32, attn_impl=impl,
                             attn_chunk=8)
    tc = dataclasses.replace(tconfigs.get_config(arch, "reduced"),
                             compute_dtype=torch.float32, attn_impl=impl,
                             attn_chunk=8)
    jm = JModel(jc)
    params = jm.init(jax.random.PRNGKey(0))
    tm = TModel(tc, device="cpu")
    tm.load_state_dict(model_params_from_arrays(tc, params, device="cpu"))
    assert tm.param_count() == jm.param_count()
    return jm, params, tm


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol)


ROUTES = [(a, i) for a in ("llama3-8b", "starcoder2-15b")
          for i in ("ref", "chunked", "flash")]


@pytest.mark.parametrize("arch,impl", ROUTES)
def test_forward_and_prefill_match_jax(arch, impl, monkeypatch):
    jm, params, tm = pair(arch, impl, monkeypatch)
    toks = np.random.default_rng(1).integers(0, 512, (2, 32)).astype(np.int32)
    dispatch.reset_launch_counts()
    close(tm.forward({"tokens": torch.as_tensor(toks)}),
          jm.forward(params, {"tokens": jnp.asarray(toks)})[0])
    for cache_len in (40, 24):               # 24 < 32: a ring cache
        tl, tcache = tm.prefill({"tokens": torch.as_tensor(toks)},
                                cache_len=cache_len)
        jl, jcache = jm.prefill(params, {"tokens": jnp.asarray(toks)},
                                cache_len=cache_len)
        close(tl, jl)
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
        for layer, c in enumerate(tcache["layers"]):
            for name in ("k", "v"):
                close(c[name], jcache["layers"][0]["b0"][name][layer])
    assert dispatch.launch_counts()["flash_attention"] == 0   # CPU


@pytest.mark.parametrize("arch", ["llama3-8b", "starcoder2-15b"])
@pytest.mark.parametrize("ring", [False, True])
def test_decode_step_matches_jax(arch, ring, monkeypatch):
    """Per-request positions (different per row) and lockstep; a non-ring
    cache one slot longer than the prompt, so that later tokens fall past
    its end (dropped per request, clamped in lockstep, as in JAX).  Decode
    takes no attention route, so one prefill route does."""
    jm, params, tm = pair(arch, "ref", monkeypatch)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 512, (2, 24)).astype(np.int32)
    cache_len = 16 if ring else 25
    for lockstep in (False, True):
        _, tcache = tm.prefill({"tokens": torch.as_tensor(toks)},
                               cache_len=cache_len)
        _, jcache = jm.prefill(params, {"tokens": jnp.asarray(toks)},
                               cache_len=cache_len)
        if not lockstep:                     # rows at different positions
            tcache["pos"] = torch.tensor([24, 21], dtype=torch.int32)
            jcache["pos"] = jnp.asarray([24, 21], jnp.int32)
        for step in range(3):
            tok = rng.integers(0, 512, (2,)).astype(np.int32)
            tl, tcache = tm.decode_step(tcache, {"token": torch.as_tensor(
                tok)}, ring=ring, lockstep=lockstep)
            jl, jcache = jm.decode_step(params, jcache,
                                        {"token": jnp.asarray(tok)},
                                        ring=ring, lockstep=lockstep)
            close(tl, jl)
        for layer, c in enumerate(tcache["layers"]):
            close(c["k"], jcache["layers"][0]["b0"]["k"][layer])


def test_init_draws_and_norms():
    cfg = tconfigs.get_config("starcoder2-15b", "reduced")
    m = TModel(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert not hasattr(m.layers[0].ffn, "w_gate")       # gelu FFN
    assert float(m.final_norm.abs().max()) == 0.0
    assert float(m.layers[1].norm2.abs().max()) == 0.0
    assert abs(float(m.embed.std()) - 0.02) < 2e-3
    assert abs(float(m.layers[0].mixer.wq.std()) - 256 ** -0.5) < 3e-3
    assert m.embed.dtype == torch.bfloat16               # compute_dtype
    same = TModel(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert torch.equal(m.unembed, same.unembed)


def test_unported_blocks_raise():
    """MoE and hybrid configs, once refused, construct and run: a MoE FFN
    in every attention block, an RG-LRU block with its own cache."""
    moe = dataclasses.replace(tconfigs.get_config("llama3-8b", "reduced"),
                              n_experts=4, top_k=2)
    hybrid = dataclasses.replace(tconfigs.get_config("llama3-8b", "reduced"),
                                 pattern=("rglru", "attn"))
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, 512, (2, 8)))
    for cfg in (moe, hybrid):
        m = TModel(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        logits = m.forward({"tokens": toks})
        assert logits.shape == (2, 8, 512) and torch.isfinite(logits).all()
        _, cache = m.prefill({"tokens": toks}, cache_len=8)
        logits, _ = m.decode_step(cache, {"token": toks[:, -1]})
        assert torch.isfinite(logits).all()
    assert type(TModel(moe, device="meta").layers[0].ffn).__name__ == "MoE"
    assert sorted(cache["layers"][0]) == ["conv", "h"]


# ---------------------------------------------------------------------------
# Engine against JAX (the cases of tests/test_serve_engine.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines_pair():
    kw = dict(name="serve-test", family="dense", n_layers=2, d_model=64,
              n_heads=2, n_kv_heads=2, d_ff=128, vocab_size=128,
              attn_impl="ref", remat=False)
    jm = JModel(JModelConfig(**kw, compute_dtype=jnp.float32))
    params = jm.init(jax.random.PRNGKey(0))
    tcfg = TModelConfig(**kw, compute_dtype=torch.float32)
    tm = TModel(tcfg, device="cpu")
    tm.load_state_dict(model_params_from_arrays(tcfg, params, device="cpu"))
    return jm, params, tm


def prompts(k, lens=(7, 11, 5, 9)):
    rng = np.random.default_rng(42)
    return [rng.integers(0, 128, (lens[i % len(lens)],)) for i in range(k)]


def both(engines_pair, ps, max_ticks=10_000, **cfg):
    jm, params, tm = engines_pair
    je = JEngine(jm, params, JServeConfig(**cfg))
    te = TEngine(tm, TServeConfig(**cfg))
    jr = [je.submit(p) for p in ps]
    tr = [te.submit(p) for p in ps]
    assert jr == tr
    jout, tout = je.run(max_ticks), te.run(max_ticks)
    assert je.exhausted == te.exhausted
    return jout, tout, te


def free_run(engines_pair, p, eos_pick):
    """Greedy run of one prompt (8 tokens) and the EOS id picked from it."""
    jout, tout, _ = both(engines_pair, [p], batch_size=1, cache_len=64,
                         max_new_tokens=8, temperature=0.0)
    assert jout == tout
    return int(jout[0][eos_pick])


@pytest.mark.parametrize("case", ["recycle", "eos_mid", "eos_first",
                                  "exhausted"])
def test_engine_greedy_matches_jax(engines_pair, case):
    if case == "recycle":          # 3 requests through 2 slots
        jout, tout, te = both(engines_pair, prompts(3), batch_size=2,
                              cache_len=64, max_new_tokens=6,
                              temperature=0.0)
        assert all(len(v) == 6 for v in tout.values())
    elif case in ("eos_mid", "eos_first"):
        ps = prompts(2)
        eos = free_run(engines_pair, ps[0], 2 if case == "eos_mid" else 1)
        jout, tout, te = both(engines_pair, ps, batch_size=1, cache_len=64,
                              max_new_tokens=8, temperature=0.0, eos_id=eos)
        assert tout[0][-1] == eos and len(tout[0]) < 8
    else:                          # tick budget runs out, then resumes
        ps = prompts(2)
        jout, tout, te = both(engines_pair, ps, max_ticks=3, batch_size=1,
                              cache_len=64, max_new_tokens=8,
                              temperature=0.0)
        assert te.exhausted and tout == {}
        tout = te.run()
        assert not te.exhausted and len(tout) == 2
        return
    assert tout == jout
    assert not any(s.active for s in te.slots) and not te._pending


def test_sampling_draws_from_the_generator():
    logits = torch.tensor([[0.0, 5.0, 1.0], [2.0, 2.0, -1.0]])
    assert sample_token(logits, None, 0.0).tolist() == [1, 0]  # first max
    a = sample_token(logits, torch.Generator().manual_seed(3), 1.0)
    b = sample_token(logits, torch.Generator().manual_seed(3), 1.0)
    assert torch.equal(a, b) and a.dtype == torch.int32
