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
* ``flash_attention`` in float32 runs 3xTF32 on the tensor cores at every
  head dim (64, 128, 256): Q, K, V and the softmax weights split like
  ``graph_mix``'s operands, each kv tile's hi and small products chained
  from zero (the tensor core truncating its adds), added in IEEE float32,
  and O = fma(alpha, O, P V) per tile; V^T's keys in the order that lets
  S's accumulator serve as P's fragment.  The emulation stays within the
  1e-5 abs/rel bar of the port's plain version and of
  ``repro.kernels.ref.flash_attention``; one TF32 pass does not.
* ``flash_attention`` in bf16 rounds the softmax weights to bf16 once per
  kv tile (128 keys at head dim 128, 80 at 256, 64 at 64) against the
  running max before P @ V (wgmma's A operand in bf16); at head dim 64
  the block's kv tiles are split between two partial softmax states,
  merged at the end.  The emulation of that tile-wise online softmax stays within the
  1e-2 abs/rel bar of the port's plain version (float32 weights) and of
  ``repro.kernels.ref.flash_attention`` (weights rounded to v's dtype).

The emulations live here, not in the package: the package's CPU path is
the plain version.  The JAX side of every comparison runs in a subprocess
of its own beside the tests before this module (``jax_references``;
tests/_port_session.py), on inputs made there from the same seeds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import graph as jgraph  # noqa: E402
from repro.core import model_propagation as jmp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402

import _port_session  # noqa: E402
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


def mix_3xtf32_operator(A, b):
    """The kernel's arithmetic as a function of (theta, sol) for a fixed
    A and b: for each 8-deep step of the reduction, a_hi b_hi and the two
    small products (a_lo b_hi + a_hi b_lo) each summed from zero, their
    sum added to the float32 accumulator; then the anchor.  (The tensor
    core truncates inside a step; numpy rounds.  The kernel's IEEE adds
    across steps are what this follows.)  A's split is laid out by step
    once."""
    n = A.shape[0]
    pad = -n % 8                         # the kernel's zero fill
    steps = (n + pad) // 8
    a_hi, a_lo = (np.ascontiguousarray(
        np.pad(m, ((0, 0), (0, pad))).reshape(n, steps, 8)
        .transpose(1, 0, 2)) for m in split(A))

    def apply(theta, sol):
        D = theta.shape[1]
        t_hi, t_lo = (np.pad(m, ((0, pad), (0, 0))).reshape(steps, 8, D)
                      for m in split(theta))
        acc = np.zeros((n, D), np.float32)
        for k in range(steps):           # step k's partial products
            hh = a_hi[k] @ t_hi[k]
            sm = a_lo[k] @ t_hi[k]
            sm += a_hi[k] @ t_lo[k]
            acc += hh + sm
        return acc + b[:, None] * sol
    return apply


def mix_3xtf32(theta, sol, A, b):
    return mix_3xtf32_operator(A, b)(theta, sol)


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


ONE_STEP = [(2048, 64), (129, 300)]


def one_step_inputs(n, D):
    rng = np.random.default_rng(n + D)
    theta = rng.standard_normal((n, D)).astype(np.float32)
    sol = rng.standard_normal((n, D)).astype(np.float32)
    A = (rng.uniform(size=(n, n)) / n).astype(np.float32)
    b = rng.uniform(size=n).astype(np.float32)
    return theta, sol, A, b


@pytest.mark.parametrize("n,D", ONE_STEP)
def test_3xtf32_graph_mix_one_step(refs, n, D):
    theta, sol, A, b = one_step_inputs(n, D)
    want = refs["one_step"][n, D]
    assert np.abs(mix_3xtf32(theta, sol, A, b) - want).max() <= 1e-5
    assert np.abs(mix_1xtf32(theta, sol, A, b) - want).max() > 1e-5


def test_3xtf32_graph_mix_100_synchronous_steps(refs):
    """The 1e-5 bar of chip_smoke.py's 4c, on a 512-agent graph (the
    operator and JAX's 100 steps from ``jax_references``)."""
    sync = refs["synchronous"]
    sol, A, b = sync["sol"], sync["A"], sync["b"]
    three = one = sol
    mix = mix_3xtf32_operator(A, b)
    for _ in range(100):
        three = mix(three, sol)
        one = mix_1xtf32(one, sol, A, b)
    want = sync["want"]
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


ROWS = [(3, 1, 1), (2, 31, 5), (3, 300, 1), (2, 257, 2), (2, 300, 8),
        (1, 4099, 1)]


@pytest.mark.parametrize("T,n,D", ROWS)
def test_rows_kernel_order_within_bar(refs, T, n, D):
    args = rows_inputs(T, n, D, T * n + D)
    tt = [torch.as_tensor(a) for a in args]
    got = mix_rows(*tt, vec=n % 4 == 0).numpy()
    plain = tref.graph_mix(*tt).numpy()
    oracle = refs["rows"][T, n, D]
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


BF16_CASES = [
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
    pytest.param(64, 320, 8, 2, 129, id="hd64-w129")]


def bf16_inputs(hd, S, H, K, window):
    rng = np.random.default_rng(S + (window or 0))
    return tuple(torch.as_tensor(rng.standard_normal(shape),
                                 dtype=torch.float32).to(torch.bfloat16)
                 for shape in ((1, S, H, hd), (1, S, K, hd), (1, S, K, hd)))


@pytest.mark.parametrize("hd,S,H,K,window", BF16_CASES)
def test_bf16_p_attention_within_bar(refs, hd, S, H, K, window):
    """The bf16 kernel's arithmetic at its tiles against the plain version
    (float32 weights) and the JAX oracle (weights rounded to v's dtype),
    1e-2 abs and rel."""
    q, k, v = bf16_inputs(hd, S, H, K, window)
    got = flash_bf16_p(q, k, v, window=window).float()
    plain = tref.flash_attention(q, k, v, window=window).float()
    torch.testing.assert_close(got, plain, atol=1e-2, rtol=1e-2)
    oracle = torch.as_tensor(refs["bf16"][hd, S, H, K, window])
    torch.testing.assert_close(got, oracle, atol=1e-2, rtol=1e-2)


# --------------------------------------------------------------------------
# flash_attention in float32: 3xTF32 on wgmma
# --------------------------------------------------------------------------

#: (queries a block, keys a kv tile) of the float32 kernels at each head
#: dim: one consumer warpgroup on 64 queries, 64-key tiles
#: (``flash_fwd_3xtf32`` at hd 64 and 128, where Q, K and V^T, each hi and
#: lo, take 64 KB apiece at hd 128; ``flash_fwd_3xtf32_pieces`` at hd 256,
#: which streams K and V^T in 32-hd pieces and chains S's 32 steps in hd
#: order, as one accumulator over the pieces)
TF32_TILES = {64: (64, 64), 128: (64, 64), 256: (64, 64)}


def pv_slot_keys(bk):
    """The key of each k-slot of P as wgmma's A operand, read off the
    fragment layouts: a thread holds S's accumulator columns 8 j + 2 t + v
    (t = lane % 4, v = 0, 1), and A's fragment slot t + 4 v of step j;
    the kernel passes the first as the second without a shuffle."""
    keys = np.empty(bk, np.int64)
    for j in range(bk // 8):
        for t in range(4):
            for v in range(2):
                keys[8 * j + t + 4 * v] = 8 * j + 2 * t + v
    return keys


def vt_slot_keys(bk):
    """The key the producer stores in each slot of a V^T row: key quad kq
    (keys 8 (kq // 2) + 2 i + kq % 2, i = 0..3) in slots 4 kq .. 4 kq + 3."""
    keys = np.empty(bk, np.int64)
    for kq in range(bk // 4):
        for i in range(4):
            keys[4 * kq + i] = 8 * (kq // 2) + 2 * i + kq % 2
    return keys


def trunc_f32(x):
    """float64 -> float32 rounded toward zero (the tensor core's adds into
    its float32 accumulator): the low 29 of float64's 52 mantissa bits
    cleared, which leaves a float32's 23 (exact in float32 for the normal
    range these sums stay in)."""
    u = np.ascontiguousarray(x, np.float64).view(np.uint64)
    return (u & np.uint64(~((1 << 29) - 1) & (2 ** 64 - 1))) \
        .view(np.float64).astype(np.float32)


def tc_chain(*pairs):
    """One wgmma accumulator from zero over 8-deep steps: ``pairs`` of a
    (..., M, D) and b (..., N, D) TF32 values, D a multiple of 8, issued
    step by step in turn (step 0 of each pair, then step 1, ...); each
    step's products summed exactly, then added to the accumulator with
    truncation."""
    parts = [np.matmul(
        a.astype(np.float64).reshape(*a.shape[:-1], -1, 8).swapaxes(-2, -3),
        b.astype(np.float64).reshape(*b.shape[:-1], -1, 8)
        .swapaxes(-2, -3).swapaxes(-1, -2)) for a, b in pairs]
    acc = np.float64(0)
    for step in range(parts[0].shape[-3]):
        for part in parts:
            acc = trunc_f32(acc + part[..., step, :, :])
    return acc


def flash_3xtf32(q, k, v, window=None, passes=3):
    """The float32 kernel's arithmetic on numpy float32 (B, S, H, hd) q
    and (B, S, K, hd) k, v, at its tiles (``TF32_TILES``): per query tile,
    kv tiles from the window's first to the causal limit, in order;
    S = Q_hi K_hi^T and Q_lo K_hi^T + Q_hi K_lo^T (per 8-deep step, as the
    kernel issues them) each chained from zero, added in IEEE float32;
    the online softmax in the log2 domain in float32 (-1e30 where masked);
    P split like the operands; (P V)_tile = P_hi V_hi + (P_lo V_hi + P_hi
    V_lo) over V^T's key slots (``vt_slot_keys``), each from zero; then
    O = fma(alpha, O, hh + sm) and O / max(l, 1e-20).  ``passes=1`` keeps
    the hi products alone (one TF32 pass)."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    BQ, BK = TF32_TILES[hd]
    order = vt_slot_keys(BK)
    assert (order == pv_slot_keys(BK)).all()    # P and V^T agree
    rep = H // K
    qs = q.transpose(0, 2, 1, 3)                       # (B, H, S, hd)
    ks = np.repeat(k, rep, 2).transpose(0, 2, 1, 3)
    vs = np.repeat(v, rep, 2).transpose(0, 2, 1, 3)
    qh, ql = split(qs)
    kh, kl = split(ks)
    vh, vl = split(vs)
    c = np.float32(np.float32(hd ** -0.5) * np.float32(1.4426950408889634))
    nq = S // BQ
    # all query tiles at once: (B, H, nq, BQ, ...); the tiles whose range
    # holds kv tile kt take it, so each tile sees its own in order
    rows = np.arange(S).reshape(nq, BQ)
    q0 = rows[:, 0]
    kt_end = (q0 + BQ - 1) // BK
    kt_begin = np.zeros(nq, np.int64)
    if window is not None:
        kt_begin = np.maximum(q0 - window + 1, 0) // BK
    tile = (B, H, nq, BQ)
    qh, ql = (x.reshape(*tile, hd) for x in (qh, ql))
    m = np.full((*tile, 1), np.float32(NEG_INF), np.float32)
    l = np.zeros((*tile, 1), np.float32)
    o = np.zeros((*tile, hd), np.float32)
    for kt in range(S // BK):
        keys = np.arange(kt * BK, (kt + 1) * BK)
        take = np.nonzero((kt >= kt_begin) & (kt <= kt_end))[0]
        if not len(take):
            continue
        kth, ktl = (x[:, :, None, keys] for x in (kh, kl))
        tq_h, tq_l = qh[:, :, take], ql[:, :, take]
        s = tc_chain((tq_h, kth))
        if passes == 3:
            s = s + tc_chain((tq_l, kth), (tq_h, ktl))
        x = s * c
        r = rows[take]
        live = keys[None, None, :] <= r[:, :, None]
        if window is not None:
            live &= keys[None, None, :] > r[:, :, None] - window
        x = np.where(live, x, np.float32(NEG_INF))
        m_t, l_t, o_t = m[:, :, take], l[:, :, take], o[:, :, take]
        m_new = np.maximum(m_t, x.max(-1, keepdims=True))
        alpha = np.exp2(m_t - m_new)
        p = np.exp2(x - m_new)
        l[:, :, take] = l_t * alpha + p.sum(-1, keepdims=True,
                                           dtype=np.float32)
        m[:, :, take] = m_new
        ph, pl = split(p[..., order])                  # A's k-slots
        vth, vtl = (np.swapaxes(x[:, :, None, kt * BK + order], -1, -2)
                    for x in (vh, vl))                 # V^T (hd, slots)
        pv = tc_chain((ph, vth))
        if passes == 3:
            pv = pv + tc_chain((pl, vth), (ph, vtl))
        o[:, :, take] = (alpha.astype(np.float64) * o_t + pv) \
            .astype(np.float32)
    inv = np.float32(1) / np.maximum(l, np.float32(1e-20))
    out = (o * inv).reshape(B, H, S, hd)
    return out.transpose(0, 2, 1, 3)


def test_vt_key_order_is_the_fragments():
    """Within each 8-key step V^T holds keys 0, 2, 4, 6, 1, 3, 5, 7."""
    for bk in (32, 64):
        want = np.tile([0, 2, 4, 6, 1, 3, 5, 7], bk // 8) \
            + np.repeat(np.arange(0, bk, 8), 8)
        np.testing.assert_array_equal(vt_slot_keys(bk), want)
        np.testing.assert_array_equal(pv_slot_keys(bk), want)


TF32_CASES = [
    pytest.param(64, 512, 4, 1, None, id="hd64-gqa4-causal"),
    pytest.param(64, 320, 8, 1, 1, id="hd64-gqa8-w1"),
    pytest.param(64, 256, 4, 4, 63, id="hd64-mha-w63"),
    pytest.param(64, 320, 8, 2, 65, id="hd64-gqa4-w65"),
    pytest.param(128, 512, 4, 1, None, id="hd128-gqa4-causal"),
    pytest.param(128, 320, 8, 1, 200, id="hd128-gqa8-w200"),
    pytest.param(128, 256, 4, 4, 65, id="hd128-mha-w65"),
    pytest.param(128, 192, 8, 1, 63, id="hd128-gqa8-w63"),
    pytest.param(128, 128, 2, 2, 1, id="hd128-mha-w1"),
    pytest.param(256, 320, 10, 1, 100, id="hd256-mqa10-w100"),
    pytest.param(256, 256, 4, 2, None, id="hd256-gqa2-causal"),
    pytest.param(256, 128, 2, 1, 1, id="hd256-gqa2-w1")]


def tf32_inputs(hd, S, H, K, window):
    rng = np.random.default_rng(hd + S + H + K + (window or 0))
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((1, S, H, hd), (1, S, K, hd), (1, S, K, hd)))


@pytest.mark.parametrize("hd,S,H,K,window", TF32_CASES)
def test_3xtf32_flash_attention_within_bar(refs, hd, S, H, K, window):
    """The float32 kernel's arithmetic at its tiles against the plain
    version and the JAX oracle, 1e-5 abs and rel (chip_smoke.py's bar);
    one TF32 pass on the same inputs misses it (causal cases)."""
    q, k, v = tf32_inputs(hd, S, H, K, window)
    got = torch.as_tensor(flash_3xtf32(q, k, v, window=window))
    plain = tref.flash_attention(*map(torch.as_tensor, (q, k, v)),
                                 window=window)
    torch.testing.assert_close(got, plain, atol=1e-5, rtol=1e-5)
    oracle = torch.as_tensor(refs["tf32"][hd, S, H, K, window])
    torch.testing.assert_close(got, oracle, atol=1e-5, rtol=1e-5)
    if window is None:
        one = torch.as_tensor(flash_3xtf32(q, k, v, window=window, passes=1))
        err = ((one - plain).abs() - 1e-5 * plain.abs()).max().item()
        assert err > 1e-5


# --------------------------------------------------------------------------
# the JAX side, in a subprocess of its own
# --------------------------------------------------------------------------


def jax_references():
    """JAX's results for every comparison of this module, on inputs made
    from the same seeds as the tests make them."""
    out = {"one_step": {}, "rows": {}, "bf16": {}, "tf32": {}}
    for n, D in ONE_STEP:
        out["one_step"][n, D] = np.asarray(jref.graph_mix(
            *map(jnp.asarray, one_step_inputs(n, D))))
    sol, A, b = mp_problem(512, 256)
    step = jax.jit(jref.graph_mix)
    jA, jb, jsol = jnp.asarray(A), jnp.asarray(b), jnp.asarray(sol)
    want = jsol
    for _ in range(100):
        want = step(want, jsol, jA, jb)
    out["synchronous"] = dict(sol=sol, A=A, b=b, want=np.asarray(want))
    for T, n, D in ROWS:
        out["rows"][T, n, D] = np.asarray(jax.vmap(jref.graph_mix)(
            *map(jnp.asarray, rows_inputs(T, n, D, T * n + D))))
    for case in BF16_CASES:
        hd, S, H, K, window = case.values
        jq, jk, jv = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                      for x in bf16_inputs(*case.values))
        oracle = jref.flash_attention(jq, jnp.repeat(jk, H // K, axis=2),
                                      jnp.repeat(jv, H // K, axis=2),
                                      window=window)
        out["bf16"][case.values] = np.array(oracle.astype(jnp.float32))
    for case in TF32_CASES:
        hd, S, H, K, window = case.values
        jq, jk, jv = map(jnp.asarray, tf32_inputs(*case.values))
        out["tf32"][case.values] = np.array(jref.flash_attention(
            jq, jnp.repeat(jk, H // K, axis=2),
            jnp.repeat(jv, H // K, axis=2), window=window))
    return out


refs = _port_session.reference_fixture(__name__)
