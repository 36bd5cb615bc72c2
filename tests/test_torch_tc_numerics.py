"""The tensor-core kernels' rounding, emulated on the CPU and held against
the JAX package before any card runs them.

* ``graph_mix`` runs 3xTF32 on the tensor cores: each operand is split
  into a round-to-nearest TF32 ``hi`` and ``lo = x - hi``, which the
  tensor core reads as TF32 (its low 13 bits dropped), and
  ``a . b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi``, each 8-deep step's
  partial sums started from zero and added to a float32 accumulator.
  The emulation (TF32 rounding by integer masking, as the kernel rounds)
  stays within 1e-5 of ``repro.kernels.ref.graph_mix`` for one step
  and over 100 ``synchronous`` steps; one TF32 pass does not, which is why
  the kernel takes three.
* ``graph_mix``'s rows kernel (D <= 8) sums in FFMA in an order of its
  own: a row's 4-float chunks dealt to 16 lanes, each lane's products in
  chunk and element order, then a butterfly over the lanes.  Its replay
  here stays within 1e-5 of ``repro.kernels.ref.graph_mix`` and of the
  port's plain version, and gives the same bits whatever the number of
  trials and whether A is read in 16- or 4-byte loads.
* ``flash_attention`` in bf16 rounds the softmax weights to bf16 once per
  kv tile (128 keys at head dim 128, 80 at 256, 64 at 64) against the
  running max before P @ V (wgmma's A operand in bf16); at head dim 64
  the block's kv tiles are split between two partial softmax states,
  merged at the end.  The emulation of that tile-wise online softmax stays within the
  1e-2 abs/rel bar of the port's plain version (float32 weights) and of
  ``repro.kernels.ref.flash_attention`` (weights rounded to v's dtype).

The emulations live here, not in the package: the package's CPU path is
the plain version.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import graph as jgraph  # noqa: E402
from repro.core import model_propagation as jmp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from _port_session import port_background_jobs  # noqa: E402,F401
from repro_torch.kernels import ref as tref  # noqa: E402

# --------------------------------------------------------------------------
# graph_mix: 3xTF32
# --------------------------------------------------------------------------


def tf32(x):
    """float32 -> nearest TF32 (10-bit mantissa), ties away from zero: add
    half of the 13 dropped bits to the magnitude, then clear them (what
    the kernel does to make hi)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_read(x):
    """A float32 register read as a TF32 operand: the tensor core uses its
    top 19 bits (the low 13 are dropped, not rounded)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    """The kernel's split: hi = tf32(x); lo = x - hi (exact in float32),
    passed to the tensor core as it is."""
    hi = tf32(x)
    return hi, tf32_read(x - hi)


def mix_3xtf32(theta, sol, A, b):
    """The kernel's arithmetic: for each 8-deep step of the reduction,
    a_hi b_hi and the two small products (a_lo b_hi + a_hi b_lo) each
    summed from zero, their sum added to the float32 accumulator; then the
    anchor.  (The tensor core truncates inside a step; numpy rounds.  The
    kernel's IEEE adds across steps are what this follows.)"""
    n, D = theta.shape
    pad = -n % 8                         # the kernel's zero fill
    a_hi, a_lo = (np.pad(m, ((0, 0), (0, pad))) for m in split(A))
    t_hi, t_lo = (np.pad(m, ((0, pad), (0, 0))) for m in split(theta))
    steps = (n + pad) // 8

    def by_step(a, t):                   # (steps, n, D) partial products
        return a.reshape(n, steps, 8).transpose(1, 0, 2) @ \
            t.reshape(steps, 8, D)
    hh = by_step(a_hi, t_hi)
    sm = by_step(a_lo, t_hi)
    sm += by_step(a_hi, t_lo)
    acc = np.zeros((n, D), np.float32)
    for k in range(steps):
        acc += hh[k] + sm[k]
    return acc + b[:, None] * sol


def mix_1xtf32(theta, sol, A, b):
    return tf32(A) @ tf32(theta) + b[:, None] * sol


def mp_problem(n, D, seed=0, k=8, alpha=0.9):
    """chip_smoke.py phase 4c's operator at a smaller n: a random
    geometric graph, c ~ U(0.05, 1), standard-normal sol."""
    g = jgraph.random_geometric_graph(n, k=k, seed=seed)
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.05, 1.0, n).astype(np.float32)
    sol = rng.standard_normal((n, D)).astype(np.float32)
    A, b = jmp.mp_mix_operator(jnp.asarray(g.P, jnp.float32),
                               jnp.asarray(c), alpha)
    return sol, np.asarray(A, np.float32), np.asarray(b, np.float32)


def test_tf32_rounding_matches_round_to_nearest():
    x = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11,
                  -(1.0 + 2.0 ** -11), 3.0e-5, 0.0], np.float32)
    got = tf32(x)
    # ties away from zero; a result with more than 10 mantissa bits is
    # not TF32
    np.testing.assert_array_equal(
        got, np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                       -(1.0 + 2.0 ** -10), got[4], 0.0], np.float32))
    assert (got.view(np.uint32) & np.uint32(0x1FFF) == 0).all()
    assert abs(got[4] - 3.0e-5) <= 3.0e-5 * 2.0 ** -11
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    hi, lo = split(x)
    assert (np.abs(lo) <= np.abs(hi) * 2.0 ** -11).all()
    assert (np.abs(hi + lo - x) <= np.abs(x) * 2.0 ** -21).all()


@pytest.mark.parametrize("n,D", [(2048, 64), (129, 300)])
def test_3xtf32_graph_mix_one_step(n, D):
    rng = np.random.default_rng(n + D)
    theta = rng.standard_normal((n, D)).astype(np.float32)
    sol = rng.standard_normal((n, D)).astype(np.float32)
    A = (rng.uniform(size=(n, n)) / n).astype(np.float32)
    b = rng.uniform(size=n).astype(np.float32)
    want = np.asarray(jref.graph_mix(jnp.asarray(theta), jnp.asarray(sol),
                                     jnp.asarray(A), jnp.asarray(b)))
    assert np.abs(mix_3xtf32(theta, sol, A, b) - want).max() <= 1e-5
    assert np.abs(mix_1xtf32(theta, sol, A, b) - want).max() > 1e-5


def test_3xtf32_graph_mix_100_synchronous_steps():
    """The 1e-5 bar of chip_smoke.py's 4c, on a 512-agent graph."""
    sol, A, b = mp_problem(512, 256)
    step = jax.jit(jref.graph_mix)
    jA, jb, jsol = jnp.asarray(A), jnp.asarray(b), jnp.asarray(sol)
    want = jsol
    three = one = sol
    for _ in range(100):
        want = step(want, jsol, jA, jb)
        three = mix_3xtf32(three, sol, A, b)
        one = mix_1xtf32(one, sol, A, b)
    want = np.asarray(want)
    assert np.abs(three - want).max() <= 1e-5
    assert np.abs(one - want).max() > 1e-5      # one TF32 pass misses


# --------------------------------------------------------------------------
# graph_mix's rows kernel: FFMA in a fixed lane order
# --------------------------------------------------------------------------

ROW_LANES = 16


def fma(a, x, acc):
    """fmaf on float32 tensors: the product exact in float64, one add, then
    float32 (a double rounding can differ from the card's in the last bit,
    rarely; the replay is held to tolerances, and to itself bit for bit)."""
    return (a.double() * x.double() + acc.double()).float()


def mix_rows(theta, sol, A, b, *, vec):
    """The rows kernel on (T, n, D) float32 tensors, every row of every
    trial at once: A read from its flat buffer as the card reads it, in
    4-float chunks (``vec``: one 16-byte load a chunk, which needs n % 4 ==
    0) or element by element (4-byte loads, masked past the row's end);
    chunk c to lane c % 16, each lane's FMAs in chunk and element order, a
    butterfly (xor 8, 4, 2, 1) over the lanes, then the anchor by FMA."""
    T, n, D = theta.shape
    nc = (n + 3) // 4
    flat = A.reshape(-1)
    base = torch.arange(T * n) * n                  # each row's offset
    x = theta.reshape(T, n, D)
    acc = torch.zeros(T * n, ROW_LANES, D)
    for q in range(-(-nc // ROW_LANES)):            # a lane's q-th chunk
        c = torch.arange(ROW_LANES) + ROW_LANES * q
        if vec:
            assert n % 4 == 0
            quads = flat.view(-1, 4)[(base[:, None] // 4 + c).clamp(
                max=flat.numel() // 4 - 1)]         # (rows, lanes, 4)
        for e in range(4):
            k = 4 * c + e                            # (lanes,)
            live = (c < nc) & (k < n)
            if vec:
                a = quads[..., e]
            else:
                a = flat[(base[:, None] + k).clamp(max=flat.numel() - 1)]
            xk = x[torch.arange(T).repeat_interleave(n)[:, None],
                   k.clamp(max=n - 1)]              # (rows, lanes, D)
            acc = torch.where(live[None, :, None],
                              fma(a[..., None], xk, acc), acc)
    lane = torch.arange(ROW_LANES)
    for off in (8, 4, 2, 1):
        acc = acc + acc[:, lane ^ off]
    assert (acc == acc[:, :1]).all()                # every lane alike
    out = fma(b.reshape(-1, 1), sol.reshape(-1, D), acc[:, 0])
    return out.reshape(T, n, D)


def rows_inputs(T, n, D, seed):
    rng = np.random.default_rng(seed)
    theta, sol = (rng.standard_normal((T, n, D)).astype(np.float32)
                  for _ in range(2))
    A = (rng.uniform(size=(T, n, n)) / n).astype(np.float32)
    b = rng.uniform(size=(T, n)).astype(np.float32)
    return theta, sol, A, b


@pytest.mark.parametrize("T,n,D", [(3, 1, 1), (2, 31, 5), (3, 300, 1),
                                   (2, 257, 2), (2, 300, 8),
                                   (1, 4099, 1)])
def test_rows_kernel_order_within_bar(T, n, D):
    args = rows_inputs(T, n, D, T * n + D)
    tt = [torch.as_tensor(a) for a in args]
    got = mix_rows(*tt, vec=n % 4 == 0).numpy()
    plain = tref.graph_mix(*tt).numpy()
    oracle = np.asarray(jax.vmap(jref.graph_mix)(*map(jnp.asarray, args)))
    assert np.abs(got - plain).max() <= 1e-5
    assert np.abs(got - oracle).max() <= 1e-5


@pytest.mark.parametrize("n,D", [(300, 1), (300, 5), (32, 2), (4, 8)])
def test_rows_kernel_order_ignores_trials_and_load_width(n, D):
    """Bit for bit: 16- and 4-byte loads of A, and each trial alone or in
    a batch of 5."""
    tt = [torch.as_tensor(a) for a in rows_inputs(5, n, D, n + D)]
    batched = mix_rows(*tt, vec=True)
    assert torch.equal(batched, mix_rows(*tt, vec=False))
    for t in range(5):
        alone = [a[t:t + 1].contiguous() for a in tt]
        assert torch.equal(batched[t:t + 1], mix_rows(*alone, vec=True))
        assert torch.equal(batched[t:t + 1], mix_rows(*alone, vec=False))


# --------------------------------------------------------------------------
# flash_attention: P in bf16 per kv tile
# --------------------------------------------------------------------------

#: (queries a block, keys a kv tile, kv split) of the bf16 kernel at each
#: head dim: ``flash_fwd_wgmma`` at 128, the warp-specialised
#: ``flash_fwd_ws`` at 256 (two consumer warpgroups on 64 rows each,
#: 80-key tiles) and at 64 (two consumer warpgroups on the same 64 rows,
#: the block's kv tiles dealt to them in turn, each with its own m, l and
#: O, merged at the end)
TILES = {64: (64, 64, 2), 128: (128, 128, 1), 256: (128, 80, 1)}
NEG_INF = -1e30


def flash_bf16_p(q, k, v, window=None):
    """The bf16 kernel's arithmetic at q's head dim (``TILES``): per query
    tile, kv tiles from the window's first to the causal limit (dealt in
    turn to ``split`` partial states); logits in float32 in the log2
    domain, -1e30 where masked; online softmax with m and l in float32 (l
    from the unrounded weights); P rounded to bf16 before P @ V; float32
    accumulator; the partial states merged (m = max, l and acc scaled by
    2^(m_part - m) and summed); output acc / max(l, 1e-20) rounded to
    bf16."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    BQ, BK, split = TILES[hd]
    f = torch.float32
    qf = q.to(f).transpose(1, 2)                       # (B, H, S, hd)
    kf = k.to(f).repeat_interleave(H // K, 2).transpose(1, 2)
    vf = v.to(f).repeat_interleave(H // K, 2).transpose(1, 2)
    c = hd ** -0.5 * 1.4426950408889634
    out = torch.empty(B, H, S, hd, dtype=f)
    pos = torch.arange(S + BK)
    for q0 in range(0, S, BQ):
        rows = pos[q0:min(q0 + BQ, S)]
        kt_begin = 0
        if window is not None and q0 - window + 1 > 0:
            kt_begin = (q0 - window + 1) // BK
        kts = range(kt_begin, (q0 + BQ - 1) // BK + 1)
        parts = []
        for part in range(split):
            m = torch.full((B, H, len(rows), 1), NEG_INF)
            l = torch.zeros(B, H, len(rows), 1)
            acc = torch.zeros(B, H, len(rows), hd)
            for kt in kts[part::split]:
                keys = pos[kt * BK:(kt + 1) * BK]
                keys = keys[keys < S]     # past S: zero-filled and masked
                if not len(keys):
                    continue
                s = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2) * c
                live = keys[None, :] <= rows[:, None]
                if window is not None:
                    live &= keys[None, :] > rows[:, None] - window
                s = torch.where(live, s, torch.tensor(NEG_INF))
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha \
                    + p.to(torch.bfloat16).to(f) @ vf[:, :, keys]
                m = m_new
            parts.append((m, l, acc))
        m = torch.stack([pm for pm, _, _ in parts]).amax(0)
        l = sum(pl * torch.exp2(pm - m) for pm, pl, _ in parts)
        acc = sum(pa * torch.exp2(pm - m) for pm, _, pa in parts)
        out[:, :, rows] = acc / torch.clamp(l, min=1e-20)
    return out.transpose(1, 2).to(torch.bfloat16)


@pytest.mark.parametrize("hd,S,H,K,window", [
    pytest.param(64, 320, 8, 2, None, id="None"),      # GQA 4:1, hd 64
    pytest.param(64, 320, 8, 2, 1, id="1"),
    pytest.param(64, 320, 8, 2, 63, id="63"),
    pytest.param(64, 320, 8, 2, 200, id="200"),
    # hd 256 (RecurrentGemma's MQA heads, 80-key tiles, which straddle S
    # and the query tiles); S = 320 leaves the last 128-query tile half
    # full
    pytest.param(256, 320, 10, 1, 1, id="hd256-mqa-w1"),
    pytest.param(256, 320, 10, 1, 100, id="hd256-mqa-w100"),
    pytest.param(256, 320, 10, 1, 128, id="hd256-mqa-w128"),
    pytest.param(256, 320, 10, 1, None, id="hd256-mqa-causal"),
    # hd 64's 64-query tiles with their kv tiles split in two: windows
    # across the tile edges (two or three tiles a block)
    pytest.param(64, 320, 8, 2, 65, id="hd64-w65"),
    pytest.param(64, 320, 8, 2, 129, id="hd64-w129")])
def test_bf16_p_attention_within_bar(hd, S, H, K, window):
    """The bf16 kernel's arithmetic at its tiles against the plain version
    (float32 weights) and the JAX oracle (weights rounded to v's dtype),
    1e-2 abs and rel."""
    B = 1
    rng = np.random.default_rng(S + (window or 0))
    q, k, v = (torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
               .to(torch.bfloat16)
               for shape in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd)))
    got = flash_bf16_p(q, k, v, window=window).float()
    plain = tref.flash_attention(q, k, v, window=window).float()
    torch.testing.assert_close(got, plain, atol=1e-2, rtol=1e-2)
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (q, k, v))
    oracle = jref.flash_attention(jq, jnp.repeat(jk, H // K, axis=2),
                                  jnp.repeat(jv, H // K, axis=2),
                                  window=window)
    oracle = torch.as_tensor(np.array(oracle.astype(jnp.float32)))
    torch.testing.assert_close(got, oracle, atol=1e-2, rtol=1e-2)
