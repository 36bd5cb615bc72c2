"""The port's attention on the CPU against the JAX package, on the same
numpy inputs from a seed.

* ``kernels.ref.flash_attention`` (the plain version of the CUDA
  ``flash_attention`` kernel, and the ``attention`` op's reference) against
  the Pallas kernel in interpret mode (``repro.kernels.ops``) and against
  ``repro.kernels.ref.flash_attention``, with the JAX package's own
  tolerances (tests/test_kernels.py: 1e-5 in float32, 2e-2 in bf16; the
  JAX oracle rounds the weights to bf16 before P @ V, the Pallas kernel
  and the port keep them in float32);
* ``models.attention``'s ``ref_attention``, ``chunked_attention`` and
  ``decode_attention`` (ring and window) against their JAX namesakes
  (float32, atol 1e-5);
* the ``attention`` op's registration and the kernel wrapper's contract.

The kernel itself runs only on the card (tests/test_torch_cuda.py).  The
JAX side of every comparison runs in a subprocess of its own beside the
tests before this module (``jax_references``; tests/_port_session.py), on
inputs made there from the same seeds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402

import _port_session  # noqa: E402
from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from _port_session import port_background_jobs  # noqa: E402,F401
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" else \
        dict(atol=1e-5, rtol=1e-5)


def qkv(seed, B, S, H, K, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, S, K, hd)).astype(np.float32),
            rng.standard_normal((B, S, K, hd)).astype(np.float32))


def as_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not \
        isinstance(x, torch.Tensor) else x.float().numpy()


FLASH = [(dtype, window, H, K) for H, K in ((4, 4), (4, 2))
         for window in (None, 64) for dtype in ("float32", "bfloat16")]
FLASH_SHAPE = (2, 128, 64)                  # B, S, hd


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("H,K", [(4, 4), (4, 2)])
def test_plain_flash_attention_matches_pallas_and_oracle(refs, dtype, window,
                                                         H, K):
    """Blocks of 32 over S = 128: with window 64 the Pallas kernel skips
    whole kv blocks, the plain version masks them."""
    B, S, hd = FLASH_SHAPE
    q, k, v = qkv(7 + H + K, B, S, H, K, hd)
    tdt = DT[dtype][1]
    got = tref.flash_attention(*(torch.as_tensor(a).to(tdt)
                                 for a in (q, k, v)), window=window)
    assert got.dtype == tdt and got.shape == (B, S, H, hd)
    pallas, oracle = refs["flash"][dtype, window, H, K]
    np.testing.assert_allclose(as_np(got), pallas, **tol(dtype))
    np.testing.assert_allclose(as_np(got), oracle, **tol(dtype))


def test_kernel_wrapper_takes_plain_version_on_cpu():
    q, k, v = (torch.as_tensor(a) for a in qkv(3, 1, 64, 4, 2, 64))
    before = tfa.launches
    got = tfa.flash_attention(q, k, v, window=16)
    assert tfa.launches == before            # no kernel on the CPU
    assert torch.equal(got, tfa.flash_attention_plain(q, k, v, window=16))


def test_attention_op_registration():
    assert dispatch.implementations("attention") == ("reference", "cuda")
    assert dispatch.resolve("attention", None, "cpu") is tref.flash_attention
    assert dispatch.resolve("attention", None, "cuda") is tfa.flash_attention
    with pytest.raises(dispatch.BackendUnavailable):
        dispatch.resolve("attention",
                         dispatch.ReproBackend.using(attention="cuda"), "cpu")


@pytest.mark.parametrize("bad,err", [
    (dict(hd=96), ValueError),            # head dim outside {64, 128}
    (dict(S=100), ValueError),            # S not a multiple of 64
    (dict(K=3), ValueError),              # kv heads do not divide H
    (dict(window=0), ValueError),
    (dict(k_dtype=torch.bfloat16), TypeError),
    (dict(dtype=torch.float16), TypeError),
])
def test_kernel_contract_checks(bad, err):
    B, S, H, K, hd = 1, bad.get("S", 64), 8, bad.get("K", 2), \
        bad.get("hd", 64)
    dt = bad.get("dtype", torch.float32)
    q = torch.zeros(B, S, H, hd, dtype=dt)
    k = torch.zeros(B, S, K, hd, dtype=bad.get("k_dtype", dt))
    v = torch.zeros(B, S, K, hd, dtype=bad.get("k_dtype", dt))
    with pytest.raises(err):
        tfa._check(q, k, v, bad.get("window"))


def test_kernel_contract_accepts_main_path_shape():
    q = torch.zeros(1, 128, 32, 128, dtype=torch.bfloat16)
    k = torch.zeros(1, 128, 8, 128, dtype=torch.bfloat16)
    tfa._check(q, k, k.clone(), 4096)


# ---------------------------------------------------------------------------
# models.attention
# ---------------------------------------------------------------------------


REF_CHUNKED = [(window, K) for K in (4, 2) for window in (None, 5)]
CHUNKS = (8, 24, 7)                     # 7: falls back to the dense form


def ref_inputs(K):
    return qkv(11 + K, 2, 24, 4, K, 16)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("K", [4, 2])
def test_ref_and_chunked_attention_match_jax(refs, window, K):
    t = [torch.as_tensor(a) for a in ref_inputs(K)]
    want, want_chunked = refs["ref_chunked"][window, K]
    np.testing.assert_allclose(
        tattn.ref_attention(*t, window=window).numpy(), want, atol=1e-5)
    for chunk in CHUNKS:
        got_c = tattn.chunked_attention(*t, window=window, chunk=chunk)
        np.testing.assert_allclose(got_c.numpy(), want_chunked[chunk],
                                   atol=1e-5)


def positions_inputs():
    B, Sq, Sk, H, hd = 1, 6, 10, 2, 8
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, H, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, H, hd)).astype(np.float32)
    qp, kp = np.arange(4, 10), np.arange(Sk)
    return (q, k, v), (dict(q_pos=qp, k_pos=kp, window=3),
                       dict(q_pos=qp, k_pos=kp, window=4, causal=False))


def test_ref_attention_positions_and_non_causal_window(refs):
    (q, k, v), kws = positions_inputs()
    for kw, want in zip(kws, refs["positions"]):
        tkw = dict(kw, q_pos=torch.as_tensor(kw["q_pos"]),
                   k_pos=torch.as_tensor(kw["k_pos"]))
        got = tattn.ref_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                                  **tkw)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


DECODE = [(False, None, [9, 3]), (False, 4, [9, 3]), (True, None, [13, 2]),
          (True, 5, [21, 7]), (False, None, 6), (True, 3, 17)]


def decode_inputs():
    B, Sc, H, K, hd = 2, 12, 8, 2, 16
    rng = np.random.default_rng(17)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, Sc, K, hd)).astype(np.float32)
    vc = rng.standard_normal((B, Sc, K, hd)).astype(np.float32)
    return q, kc, vc


@pytest.mark.parametrize("ring,window,pos", DECODE)
def test_decode_attention_matches_jax(refs, ring, window, pos):
    q, kc, vc = decode_inputs()
    p = np.asarray(pos, np.int32)
    want = refs["decode"][DECODE.index((ring, window, pos))]
    got = tattn.decode_attention(torch.as_tensor(q), torch.as_tensor(kc),
                                 torch.as_tensor(vc), torch.as_tensor(p),
                                 window=window, ring=ring)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# ---------------------------------------------------------------------------
# the JAX side, in a subprocess of its own
# ---------------------------------------------------------------------------


def jax_references():
    """JAX's results for every comparison of this module, on inputs made
    from the same seeds as the tests make them."""
    flash = {}
    B, S, hd = FLASH_SHAPE
    for dtype, window, H, K in FLASH:
        jdt = DT[dtype][0]
        jq, jk, jv = (jnp.asarray(a, jdt)
                      for a in qkv(7 + H + K, B, S, H, K, hd))
        pallas = jops.flash_attention(jq, jk, jv, window=window, block_q=32,
                                      block_k=32)
        oracle = jref.flash_attention(jq, jnp.repeat(jk, H // K, axis=2),
                                      jnp.repeat(jv, H // K, axis=2),
                                      window=window)
        flash[dtype, window, H, K] = (as_np(pallas), as_np(oracle))
    ref_chunked = {}
    for window, K in REF_CHUNKED:
        q, k, v = ref_inputs(K)
        ref_chunked[window, K] = (
            np.asarray(jattn.ref_attention(q, k, v, window=window)),
            {chunk: np.asarray(jattn.chunked_attention(
                q, k, v, window=window, chunk=chunk)) for chunk in CHUNKS})
    (q, k, v), kws = positions_inputs()
    positions = [np.asarray(jattn.ref_attention(q, k, v, **kw))
                 for kw in kws]
    q, kc, vc = decode_inputs()
    decode = [np.asarray(jattn.decode_attention(
        q, kc, vc, jnp.asarray(np.asarray(pos, np.int32)), window=window,
        ring=ring)) for ring, window, pos in DECODE]
    return {"flash": flash, "ref_chunked": ref_chunked,
            "positions": positions, "decode": decode}


refs = _port_session.reference_fixture(__name__)
