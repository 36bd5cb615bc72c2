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
import _port_session  # noqa: E402
from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from _port_session import port_background_jobs  # noqa: E402,F401
from _port_session import as_numpy  # noqa: E402
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


def configs(arch, impl):
    """The same REDUCED config in both frameworks, float32, chunk 8."""
    kw = dict(attn_impl=impl, attn_chunk=8)
    return (dataclasses.replace(jconfigs.get_config(arch, "reduced"),
                                compute_dtype=jnp.float32, **kw),
            dataclasses.replace(tconfigs.get_config(arch, "reduced"),
                                compute_dtype=torch.float32, **kw))


def port_model(tc, params):
    tm = TModel(tc, device="cpu")
    tm.load_state_dict(model_params_from_arrays(tc, params, device="cpu"))
    return tm


def close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol)


ROUTES = [(a, i) for a in ("llama3-8b", "starcoder2-15b")
          for i in ("ref", "chunked", "flash")]
DECODES = [(a, r) for a in ("llama3-8b", "starcoder2-15b")
           for r in (False, True)]


def forward_tokens():
    return np.random.default_rng(1).integers(0, 512, (2, 32)) \
        .astype(np.int32)


def jax_forward_and_prefill(arch, impl):
    """The JAX side of a route: parameters from ``PRNGKey(0)``, the
    forward logits, and a prefill into a cache of 40 and a ring of 24
    (the ``flash`` route runs the Pallas kernel in interpret mode)."""
    import os
    jc, _ = configs(arch, impl)
    jm = JModel(jc)
    params = jm.init(jax.random.PRNGKey(0))
    toks = jnp.asarray(forward_tokens())
    old = os.environ.get("REPRO_PALLAS_INTERPRET")
    if impl == "flash":
        os.environ["REPRO_PALLAS_INTERPRET"] = "1"
    try:
        out = {"params": params,
               "forward": jm.forward(params, {"tokens": toks})[0],
               "prefill": {n: jm.prefill(params, {"tokens": toks},
                                         cache_len=n) for n in (40, 24)}}
    finally:
        if old is None:
            os.environ.pop("REPRO_PALLAS_INTERPRET", None)
        else:
            os.environ["REPRO_PALLAS_INTERPRET"] = old
    return out


def decode_inputs(ring):
    """The prompt, the cache length and the decode tokens' generator."""
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 512, (2, 24)).astype(np.int32)
    return toks, (16 if ring else 25), rng


def jax_decode(arch, ring, params):
    """The JAX side of a decode case on the ``ref`` route: per request
    (rows at positions 24 and 21) and lockstep, three decode steps' logits
    and the k caches after them."""
    jc, _ = configs(arch, "ref")
    jm = JModel(jc)
    toks, cache_len, rng = decode_inputs(ring)
    out = {}
    for lockstep in (False, True):
        _, jcache = jm.prefill(params, {"tokens": jnp.asarray(toks)},
                               cache_len=cache_len)
        if not lockstep:                     # rows at different positions
            jcache["pos"] = jnp.asarray([24, 21], jnp.int32)
        logits = []
        for step in range(3):
            tok = rng.integers(0, 512, (2,)).astype(np.int32)
            jl, jcache = jm.decode_step(params, jcache,
                                        {"token": jnp.asarray(tok)},
                                        ring=ring, lockstep=lockstep)
            logits.append(jl)
        out[lockstep] = {"logits": logits,
                         "k": jcache["layers"][0]["b0"]["k"]}
    return out


def jax_references():
    """The JAX side of the route, decode and engine tests (run in a
    subprocess of its own beside the tests before this module:
    tests/_port_session.py)."""
    routes = {case: jax_forward_and_prefill(*case) for case in ROUTES}
    decodes = {(arch, ring): jax_decode(arch, ring,
                                        routes[arch, "ref"]["params"])
               for arch, ring in DECODES}
    return {"routes": as_numpy(routes), "decodes": as_numpy(decodes),
            "engines": jax_engines()}


refs = _port_session.reference_fixture(__name__)


@pytest.mark.parametrize("arch,impl", ROUTES)
def test_forward_and_prefill_match_jax(refs, arch, impl):
    want = refs["routes"][arch, impl]
    jc, tc = configs(arch, impl)
    tm = port_model(tc, want["params"])
    assert tm.param_count() == JModel(jc).param_count()
    toks = forward_tokens()
    dispatch.reset_launch_counts()
    close(tm.forward({"tokens": torch.as_tensor(toks)}), want["forward"])
    for cache_len in (40, 24):               # 24 < 32: a ring cache
        tl, tcache = tm.prefill({"tokens": torch.as_tensor(toks)},
                                cache_len=cache_len)
        jl, jcache = want["prefill"][cache_len]
        close(tl, jl)
        np.testing.assert_array_equal(tcache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
        for layer, c in enumerate(tcache["layers"]):
            for name in ("k", "v"):
                close(c[name], jcache["layers"][0]["b0"][name][layer])
    assert dispatch.launch_counts()["flash_attention"] == 0   # CPU


@pytest.mark.parametrize("arch", ["llama3-8b", "starcoder2-15b"])
@pytest.mark.parametrize("ring", [False, True])
def test_decode_step_matches_jax(refs, arch, ring):
    """Per-request positions (different per row) and lockstep; a non-ring
    cache one slot longer than the prompt, so that later tokens fall past
    its end (dropped per request, clamped in lockstep, as in JAX).  Decode
    takes no attention route, so one prefill route does."""
    _, tc = configs(arch, "ref")
    tm = port_model(tc, refs["routes"][arch, "ref"]["params"])
    want = refs["decodes"][arch, ring]
    toks, cache_len, rng = decode_inputs(ring)
    for lockstep in (False, True):
        _, tcache = tm.prefill({"tokens": torch.as_tensor(toks)},
                               cache_len=cache_len)
        if not lockstep:                     # rows at different positions
            tcache["pos"] = torch.tensor([24, 21], dtype=torch.int32)
        for step in range(3):
            tok = rng.integers(0, 512, (2,)).astype(np.int32)
            tl, tcache = tm.decode_step(tcache, {"token": torch.as_tensor(
                tok)}, ring=ring, lockstep=lockstep)
            close(tl, want[lockstep]["logits"][step])
        for layer, c in enumerate(tcache["layers"]):
            close(c["k"], want[lockstep]["k"][layer])


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


ENGINE_KW = dict(name="serve-test", family="dense", n_layers=2, d_model=64,
                 n_heads=2, n_kv_heads=2, d_ff=128, vocab_size=128,
                 attn_impl="ref", remat=False)
ENGINE_CASES = ("recycle", "eos_mid", "eos_first", "exhausted")


def prompts(k, lens=(7, 11, 5, 9)):
    rng = np.random.default_rng(42)
    return [rng.integers(0, 128, (lens[i % len(lens)],)) for i in range(k)]


def engine_runs(case):
    """The case's engine runs, in order: ``(prompts, max_ticks, config,
    eos_pick)``; ``eos_pick`` names the run and position whose token the
    next run takes as its EOS id (the free run's)."""
    if case == "recycle":          # 3 requests through 2 slots
        return [(prompts(3), 10_000, dict(batch_size=2, cache_len=64,
                                          max_new_tokens=6,
                                          temperature=0.0), None)]
    ps = prompts(2)
    cfg = dict(batch_size=1, cache_len=64, max_new_tokens=8,
               temperature=0.0)
    if case in ("eos_mid", "eos_first"):
        # a free run of the first prompt picks the EOS id
        return [([ps[0]], 10_000, cfg, 2 if case == "eos_mid" else 1),
                (ps, 10_000, cfg, None)]
    return [(ps, 3, cfg, None)]    # the tick budget runs out


def jax_engines():
    """The JAX engine's ids, outputs and ``exhausted`` for every run of
    every engine case, with the model's parameters."""
    jm = JModel(JModelConfig(**ENGINE_KW, compute_dtype=jnp.float32))
    params = jm.init(jax.random.PRNGKey(0))
    out = {"params": as_numpy(params)}
    for case in ENGINE_CASES:
        eos, runs = None, []
        for ps, max_ticks, cfg, eos_pick in engine_runs(case):
            je = JEngine(jm, params, JServeConfig(
                **cfg, **({} if eos is None else {"eos_id": eos})))
            ids = [je.submit(p) for p in ps]
            jout = je.run(max_ticks)
            runs.append({"ids": [int(i) for i in ids],
                         "out": {int(k): [int(t) for t in v]
                                 for k, v in jout.items()},
                         "exhausted": bool(je.exhausted), "eos": eos})
            if eos_pick is not None:
                eos = int(jout[0][eos_pick])
        out[case] = runs
    return out


@pytest.fixture(scope="module")
def engine_model(refs):
    tcfg = TModelConfig(**ENGINE_KW, compute_dtype=torch.float32)
    return port_model(tcfg, refs["engines"]["params"])


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_engine_greedy_matches_jax(refs, engine_model, case):
    """The port's engine against the JAX engine's runs of the case: the
    same request ids, the same greedy tokens and the same ``exhausted``,
    run after run (an EOS id picked from the free run)."""
    for (ps, max_ticks, cfg, _), want in zip(engine_runs(case),
                                             refs["engines"][case]):
        eos = want["eos"]
        te = TEngine(engine_model, TServeConfig(
            **cfg, **({} if eos is None else {"eos_id": eos})))
        assert [te.submit(p) for p in ps] == want["ids"]
        tout = te.run(max_ticks)
        assert te.exhausted == want["exhausted"]
        assert tout == want["out"]
    if case == "recycle":
        assert all(len(v) == 6 for v in tout.values())
    elif case in ("eos_mid", "eos_first"):
        assert tout[0][-1] == eos and len(tout[0]) < 8
    else:                          # the budget ran out; the engine resumes
        assert te.exhausted and tout == {}
        tout = te.run()
        assert not te.exhausted and len(tout) == 2
        return
    assert not any(s.active for s in te.slots) and not te._pending


def test_sampling_draws_from_the_generator():
    logits = torch.tensor([[0.0, 5.0, 1.0], [2.0, 2.0, -1.0]])
    assert sample_token(logits, None, 0.0).tolist() == [1, 0]  # first max
    a = sample_token(logits, torch.Generator().manual_seed(3), 1.0)
    b = sample_token(logits, torch.Generator().manual_seed(3), 1.0)
    assert torch.equal(a, b) and a.dtype == torch.int32
