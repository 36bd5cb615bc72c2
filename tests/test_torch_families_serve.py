"""The port's ``Engine`` serving the model families on the CPU against the
JAX package's ``Engine``: greedy decoding token for token for one MoE
(olmoe-1b-7b), one RG-LRU hybrid (recurrentgemma-2b, local attention)
and one xLSTM (xlstm-1.3b) REDUCED config in float32, three prompts
through two slots, so that a finished slot is refilled and its cache
entry (kv, or the recurrent state) spliced over the old one.  The prompts
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
from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from repro_torch.convert import model_params_from_arrays  # noqa: E402
from repro_torch.models import Model as TModel  # noqa: E402
from repro_torch.serve import Engine as TEngine  # noqa: E402
from repro_torch.serve import ServeConfig as TServeConfig  # noqa: E402

SERVE = dict(batch_size=2, cache_len=32, max_new_tokens=5, temperature=0.0)


def pair(arch):
    jc = dataclasses.replace(jconfigs.get_config(arch, "reduced"),
                             compute_dtype=jnp.float32)
    tc = dataclasses.replace(tconfigs.get_config(arch, "reduced"),
                             compute_dtype=torch.float32)
    jm = JModel(jc)
    params = jm.init(jax.random.PRNGKey(1))
    tm = TModel(tc, device="cpu")
    tm.load_state_dict(model_params_from_arrays(tc, params, device="cpu"))
    return jm, params, tm


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "recurrentgemma-2b",
                                  "xlstm-1.3b"])
def test_engine_greedy_matches_jax(arch):
    jm, params, tm = pair(arch)
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, tm.cfg.vocab_size, n) for n in (9, 9, 9)]
    je = JEngine(jm, params, JServeConfig(**SERVE))
    te = TEngine(tm, TServeConfig(**SERVE))
    assert [je.submit(p) for p in prompts] == \
        [te.submit(p) for p in prompts]
    jout, tout = je.run(), te.run()
    assert not te.exhausted and not je.exhausted
    assert tout == jout
    assert all(len(v) == SERVE["max_new_tokens"] for v in tout.values())
    assert sorted(te.cache["layers"][0]) == \
        sorted(je.cache["layers"][0]["b0"])


def test_engine_token_shape_per_family():
    """Audio decodes (B, K) tokens, as the JAX engine lays them out."""
    for arch in ("musicgen-medium", "olmoe-1b-7b"):
        cfg = tconfigs.get_config(arch, "reduced")
        te = TEngine(TModel(cfg, device="cpu"), TServeConfig(batch_size=3))
        want = (3, cfg.n_codebooks) if cfg.family == "audio" else (3,)
        assert te._last_tok.shape == want
        assert te.cache["pos"].shape == (3,)
