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

The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402

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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("H,K", [(4, 4), (4, 2)])
def test_plain_flash_attention_matches_pallas_and_oracle(dtype, window, H, K):
    """Blocks of 32 over S = 128: with window 64 the Pallas kernel skips
    whole kv blocks, the plain version masks them."""
    B, S, hd = 2, 128, 64
    q, k, v = qkv(7 + H + K, B, S, H, K, hd)
    jdt, tdt = DT[dtype]
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    got = tref.flash_attention(*(torch.as_tensor(a).to(tdt)
                                 for a in (q, k, v)), window=window)
    assert got.dtype == tdt and got.shape == (B, S, H, hd)
    pallas = jops.flash_attention(jq, jk, jv, window=window, block_q=32,
                                  block_k=32)
    np.testing.assert_allclose(as_np(got), as_np(pallas), **tol(dtype))
    ke = jnp.repeat(jk, H // K, axis=2)
    ve = jnp.repeat(jv, H // K, axis=2)
    oracle = jref.flash_attention(jq, ke, ve, window=window)
    np.testing.assert_allclose(as_np(got), as_np(oracle), **tol(dtype))


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


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("K", [4, 2])
def test_ref_and_chunked_attention_match_jax(window, K):
    B, S, H, hd = 2, 24, 4, 16
    q, k, v = qkv(11 + K, B, S, H, K, hd)
    t = [torch.as_tensor(a) for a in (q, k, v)]
    want = jattn.ref_attention(q, k, v, window=window)
    np.testing.assert_allclose(
        tattn.ref_attention(*t, window=window).numpy(), np.asarray(want),
        atol=1e-5)
    for chunk in (8, 24, 7):                 # 7: falls back to the dense form
        want_c = jattn.chunked_attention(q, k, v, window=window, chunk=chunk)
        got_c = tattn.chunked_attention(*t, window=window, chunk=chunk)
        np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                                   atol=1e-5)


def test_ref_attention_positions_and_non_causal_window():
    B, Sq, Sk, H, hd = 1, 6, 10, 2, 8
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Sk, H, hd)).astype(np.float32)
    v = rng.standard_normal((B, Sk, H, hd)).astype(np.float32)
    qp, kp = np.arange(4, 10), np.arange(Sk)
    for kw in (dict(q_pos=qp, k_pos=kp, window=3),
               dict(q_pos=qp, k_pos=kp, window=4, causal=False)):
        want = jattn.ref_attention(q, k, v, **kw)
        tkw = dict(kw, q_pos=torch.as_tensor(qp), k_pos=torch.as_tensor(kp))
        got = tattn.ref_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                                  **tkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("ring,window,pos", [
    (False, None, [9, 3]), (False, 4, [9, 3]), (True, None, [13, 2]),
    (True, 5, [21, 7]), (False, None, 6), (True, 3, 17)])
def test_decode_attention_matches_jax(ring, window, pos):
    B, Sc, H, K, hd = 2, 12, 8, 2, 16
    rng = np.random.default_rng(17)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    kc = rng.standard_normal((B, Sc, K, hd)).astype(np.float32)
    vc = rng.standard_normal((B, Sc, K, hd)).astype(np.float32)
    p = np.asarray(pos, np.int32)
    want = jattn.decode_attention(q, kc, vc, jnp.asarray(p), window=window,
                                  ring=ring)
    got = tattn.decode_attention(torch.as_tensor(q), torch.as_tensor(kc),
                                 torch.as_tensor(vc), torch.as_tensor(p),
                                 window=window, ring=ring)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
