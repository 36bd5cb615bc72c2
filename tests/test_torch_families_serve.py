"""The port's ``Engine`` serving the model families on the CPU against the
JAX package's ``Engine``: greedy decoding token for token for one MoE
(olmoe-1b-7b), one RG-LRU hybrid (recurrentgemma-2b, local attention)
and one xLSTM (xlstm-1.3b) REDUCED config in float32, three prompts
through two slots, so that a finished slot is refilled and its cache
entry (kv, or the recurrent state) spliced over the old one.  The JAX
engines run in a subprocess of their own that starts with the port's first
test (``jax_references``; tests/_port_session.py).  The prompts
share one length, so the JAX engine compiles one prefill.  The VLM and
audio families need inputs beside the prompt's tokens, which neither
engine passes to prefill; they are served by ``prefill`` and
``decode_step`` (tests/test_torch_families.py).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import Model as JModel  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402

import repro_torch.configs as tconfigs  # noqa: E402
import _port_session  # noqa: E402
from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from _port_session import port_background_jobs  # noqa: E402,F401
from repro_torch.convert import model_params_from_arrays  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.serve import Engine as TEngine  # noqa: E402
from repro_torch.serve import ServeConfig as TServeConfig  # noqa: E402

SERVE = dict(batch_size=2, cache_len=32, max_new_tokens=5, temperature=0.0)


ARCHS = ("olmoe-1b-7b", "recurrentgemma-2b", "xlstm-1.3b")


def configs(arch):
    return (dataclasses.replace(jconfigs.get_config(arch, "reduced"),
                                compute_dtype=jnp.float32),
            dataclasses.replace(tconfigs.get_config(arch, "reduced"),
                                compute_dtype=torch.float32))


def engine_prompts(cfg):
    rng = np.random.default_rng(21)
    return [rng.integers(0, cfg.vocab_size, n) for n in (9, 9, 9)]


def jax_engine(arch):
    """The JAX engine's run of the arch: its parameters (``PRNGKey(1)``),
    request ids, outputs, ``exhausted`` and first layer's cache keys."""
    jc, _ = configs(arch)
    jm = JModel(jc)
    params = jm.init(jax.random.PRNGKey(1))
    je = JEngine(jm, params, JServeConfig(**SERVE))
    ids = [int(je.submit(p)) for p in engine_prompts(jc)]
    jout = je.run()
    return {"params": jax.tree_util.tree_map(np.asarray, params),
            "ids": ids, "exhausted": bool(je.exhausted),
            "out": {int(k): [int(t) for t in v] for k, v in jout.items()},
            "cache_keys": sorted(je.cache["layers"][0]["b0"])}


def jax_references():
    """:func:`jax_engine` of every arch (run in a subprocess of its own
    beside the tests before this module: tests/_port_session.py)."""
    return {arch: jax_engine(arch) for arch in ARCHS}


refs = _port_session.reference_fixture(__name__)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_matches_jax(arch, refs):
    want = refs[arch]
    _, tc = configs(arch)
    tm = TModel(tc, device="cpu")
    tm.load_state_dict(model_params_from_arrays(tc, want["params"],
                                                device="cpu"))
    te = TEngine(tm, TServeConfig(**SERVE))
    assert [te.submit(p) for p in engine_prompts(tm.cfg)] == want["ids"]
    tout = te.run()
    assert not te.exhausted and not want["exhausted"]
    assert tout == want["out"]
    assert all(len(v) == SERVE["max_new_tokens"] for v in tout.values())
    assert sorted(te.cache["layers"][0]) == want["cache_keys"]


def test_engine_token_shape_per_family():
    """Audio decodes (B, K) tokens, as the JAX engine lays them out."""
    for arch in ("musicgen-medium", "olmoe-1b-7b"):
        cfg = tconfigs.get_config(arch, "reduced")
        te = TEngine(TModel(cfg, device="cpu"), TServeConfig(batch_size=3))
        want = (3, cfg.n_codebooks) if cfg.family == "audio" else (3,)
        assert te._last_tok.shape == want
        assert te.cache["pos"].shape == (3,)
