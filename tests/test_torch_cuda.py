"""The port's CUDA kernels on the card, each held against its plain
PyTorch version on the same inputs (the tolerances of
tests/test_torch_kernels.py; ``sparse_gather_mix`` bit for bit in any row
order; ``round_step`` bit for bit in its fixed and generic kernels, over
20 consecutive calls on one election buffer that no call refills or
reallocates; ``cl_edge_step`` and ``admm_edge_update`` bit for bit, repeated
targets included, and ``cl_edge_step`` on rounds built for each case of
its edge election, with its election words zero after every call;
``flash_attention`` 1e-2 abs and rel in bf16, 1e-5 in float32, head dims
64, 128 and 256), a small model's prefill through the ``flash_attention``
kernel against the reference attention, each model family's REDUCED
config on the card against the CPU, and the paths without kernels of
their own:
``edge_reweight`` on the card against the CPU, sparse against dense async
gossip and joint learning at rate 0 against per-op MP bit for bit, and
the inexact primal with MLP agents (p = 33) through ``cl_edge_step``
against the reference backend; ``graph_mix``'s agent-axis form (n <= 32,
D > 8, float32 within 1e-5 and bf16 within ``gm.bf16_tolerance``, a replay
and a slice of D bit for bit) and one personalized training step of a
small LM on the card against the same step on the CPU; ``graph_mix`` over
a trial axis (one launch
for all trials, each trial equal to its own launch bit for bit, whatever
the load width) and the MP sweep through it, and its tile kernel over
3000 ``synchronous`` steps; and telemetry on the card (theta bit-identical with it
on, the kernels' launches unchanged, the frames' counters equal to the
stream's); and the partitioned simulator on a LocalMesh of the card (MP
bit for bit with the per-op run and within 1e-5 of the fused one, CL bit
for bit with the ``cl_edge_step`` run, joint learning with halo
re-compaction bit for bit, ``cuda_sharded`` bit for bit with
``reference_sharded`` and the single-device kernel sweep); and the dry
run's predicted peak memory of a one-agent training step against the
card's; and ``examples/quickstart_torch.py``'s backend part (the
``graph_mix`` kernel against its plain version within 1e-5, rows form
and trial axis); and the two serving demos at ``--smoke``.  The kernels
have no CPU mode: on a host without a CUDA card every test here skips.

Run on the card with ``python -m pytest -q tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _cl_rounds import CASES, election_round  # noqa: E402
from repro_torch.kernels import admm_update as au  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import graph_mix as gm  # noqa: E402
from repro_torch.kernels import round_fuse as rf  # noqa: E402
from repro_torch.kernels import sparse_mix as sm  # noqa: E402
from repro_torch.simulate import random_geometric_topology  # noqa: E402
from repro_torch.simulate import sparse_sync_mp, topology  # noqa: E402

pytestmark = pytest.mark.cuda

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def on(dev, *arrays, dtype=torch.float32):
    return [torch.as_tensor(a, dtype=dtype, device=dev) for a in arrays]


@pytest.mark.parametrize("n,D", [(1, 1), (129, 300), (256, 512),
                                 (257, 301),        # 4-byte copies
                                 (2048, 4096)])     # chip_smoke's 4c
def test_graph_mix_kernel(cuda, n, D):
    """3xTF32 on the tensor cores against the float32 plain version."""
    rng = np.random.default_rng(n + D)
    args = on(cuda, rng.standard_normal((n, D)), rng.standard_normal((n, D)),
              rng.uniform(size=(n, n)) / n, rng.uniform(size=n))
    before = gm.launches
    got = gm.graph_mix(*args)
    assert gm.launches == before + 1
    assert (got - gm.graph_mix_plain(*args)).abs().max().item() <= 1e-5


def test_graph_mix_kernel_replay_is_bit_identical(cuda):
    rng = np.random.default_rng(5)
    n, D = 300, 301
    args = on(cuda, rng.standard_normal((n, D)), rng.standard_normal((n, D)),
              rng.uniform(size=(n, n)) / n, rng.uniform(size=n))
    assert torch.equal(gm.graph_mix(*args), gm.graph_mix(*args))


@pytest.mark.parametrize("N,n,k,p", [(300, 200, 7, 40), (64, 64, 3, 32),
                                     (50, 10, 1, 5), (90, 70, 32, 32),
                                     (120, 60, 37, 33)])   # k > 32: chunks
def test_sparse_gather_mix_kernel(cuda, N, n, k, p):
    rng = np.random.default_rng(N + n + k + p)
    table, w, b, sol = on(cuda, rng.standard_normal((N, p)),
                          rng.uniform(size=(n, k)), rng.uniform(size=n),
                          rng.standard_normal((n, p)))
    (idx,) = on(cuda, rng.integers(0, N, (n, k)), dtype=torch.int32)
    want = sm.sparse_gather_mix_plain(table, idx, w, b, sol)
    perm = torch.as_tensor(rng.permutation(n), dtype=torch.int32,
                           device=cuda)
    for order in (None, perm):
        before = sm.launches
        got = sm.sparse_gather_mix(table, idx, w, b, sol, order=order)
        assert sm.launches == before + 1
        assert torch.equal(got, want)   # same slot-order arithmetic


def rcm_mix_inputs(dev, topo, p, seed):
    """sparse_sync_mp's operands on ``topo``: the table is a random model
    (a steady-state sweep's), the rows in the topology's RCM order."""
    from repro_torch.core.model_propagation import mp_mix_operator
    n = topo.n
    rng = np.random.default_rng(seed)
    tabs = topo.device_tables(dev)
    table, sol, c = on(dev, rng.standard_normal((n, p)),
                       rng.standard_normal((n, p)), rng.uniform(0.1, 1, n))
    w, b = mp_mix_operator(tabs.nbr_p, c, 0.9)
    order = torch.as_tensor(topo.locality_order, device=dev)
    return table, tabs.nbr_idx, w.contiguous(), b.contiguous(), sol, order


def pairs_topology(n):
    """n/2 disjoint edges: every agent has one neighbor (k = 1)."""
    i = np.arange(0, n, 2)
    return topology._from_pairs(n, i, i + 1, np.zeros(n, np.int32))


@pytest.mark.parametrize("make,p", [
    (lambda: random_geometric_topology(3000, k=8, seed=1), 40),
    (lambda: random_geometric_topology(2000, k=8, seed=2), 32),
    (lambda: pairs_topology(500), 7)])
def test_sparse_gather_mix_kernel_rcm_order(cuda, make, p):
    table, idx, w, b, sol, order = rcm_mix_inputs(cuda, make(), p, p)
    want = sm.sparse_gather_mix_plain(table, idx, w, b, sol)
    got = sm.sparse_gather_mix(table, idx, w, b, sol, order=order)
    assert torch.equal(got, want)
    assert torch.equal(sm.sparse_gather_mix(table, idx, w, b, sol,
                                            order=order), got)   # replay


def test_sparse_sync_mp_launches_with_the_order(cuda):
    topo = random_geometric_topology(1000, k=6, seed=3)
    rng = np.random.default_rng(3)
    sol = rng.standard_normal((1000, 8)).astype(np.float32)
    c = rng.uniform(0.1, 1.0, 1000).astype(np.float32)
    dispatch.reset_launch_counts()
    got = sparse_sync_mp(topo, sol, c, 0.9, 4, device=cuda)
    assert sm.launches == sm.ordered_launches == 4
    want = sparse_sync_mp(topo, sol, c, 0.9, 4, device=cuda,
                          backend=dispatch.ReproBackend(default="reference"))
    assert torch.equal(got, want)


def make_round(dev, n, k, p, m, seed, deliver_frac=0.7, seen_frac=0.5):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, n * k, m)            # duplicate targets
    deliver = rng.uniform(size=m) < deliver_frac
    Ke = np.concatenate([rng.standard_normal((n * k, p)),
                         rng.integers(-1, 50, (n * k, 1))], axis=1)
    f = on(dev, rng.standard_normal((n, p)), Ke,
           rng.standard_normal((m, p)), rng.standard_normal((m, p)),
           rng.standard_normal((n, p)), rng.uniform(0.1, 1.0, n * k))
    i = on(dev, np.where(deliver, codes // k, n), np.where(deliver, codes,
                                                           n * k),
           dtype=torch.int32)
    (got_ever,) = on(dev, rng.uniform(size=n) < seen_frac, dtype=torch.bool)
    return dict(theta=f[0], Ke=f[1], got_ever=got_ever, msg=f[2],
                tgt_row=i[0], enc=i[1], k_old=f[3], theta_base=f[4],
                a_w=f[5])


@pytest.mark.parametrize("case", [dict(n=41, k=6, p=9, m=120, seed=1),
                                  dict(n=11, k=3, p=4, m=40, seed=2),
                                  dict(n=23, k=4, p=33, m=13, seed=3),
                                  dict(n=500, k=8, p=32, m=2000, seed=4,
                                       seen_frac=0.0),
                                  dict(n=17, k=3, p=4, m=10, seed=5,
                                       deliver_frac=0.0),
                                  # the fixed (k <= 32, p = 32) kernels
                                  dict(n=2000, k=18, p=32, m=4000, seed=6),
                                  dict(n=60, k=32, p=32, m=900, seed=7),
                                  dict(n=300, k=1, p=32, m=400, seed=8),
                                  # the generic kernel: k > 32, p != 32
                                  dict(n=30, k=40, p=9, m=700, seed=9),
                                  dict(n=30, k=40, p=32, m=700, seed=10),
                                  dict(n=30, k=40, p=33, m=700, seed=11)])
def test_round_step_kernel(cuda, case):
    args = make_round(cuda, **case)
    clone = lambda: {k: v.clone() for k, v in args.items()}  # noqa: E731
    got = rf.round_step(*clone().values())
    want = rf.round_step_plain(*clone().values())
    assert torch.equal(got[3], want[3])           # keep
    assert torch.equal(got[2], want[2])           # got_ever
    assert torch.equal(got[1], want[1])           # Ke
    assert torch.equal(got[0], want[0])           # theta: same sum order


def test_round_step_replay_is_bit_identical(cuda):
    a = make_round(cuda, 300, 6, 32, 900, seed=7)
    b = {k: v.clone() for k, v in a.items()}
    for _ in range(3):
        ra = rf.round_step(*a.values())
        rb = rf.round_step(*b.values())
    assert all(torch.equal(x, y) for x, y in zip(ra, rb))


def next_events(dev, n, k, p, m, seed):
    """A fresh round's events (msg, tgt_row, enc, k_old) on a fixed state."""
    ev = make_round(dev, n, k, p, m, seed)
    return [ev[f] for f in ("msg", "tgt_row", "enc", "k_old")]


@pytest.mark.parametrize("k,p", [(18, 32), (40, 9)])
def test_round_step_consecutive_calls_on_one_buffer(cuda, k, p):
    """20 rounds chained through one state and one election buffer, each
    bit for bit with the plain version on the same round-start state: the
    words earlier rounds left behind never count."""
    n, m = 200, 600
    args = make_round(cuda, n, k, p, m, seed=20)
    state = [args["theta"], args["Ke"], args["got_ever"]]
    fixed = (args["theta_base"], args["a_w"])
    words = rf.round_words(n * k, cuda)
    for t in range(20):
        ev = next_events(cuda, n, k, p, m, seed=100 + t)
        want = rf.round_step_plain(*(x.clone() for x in state), *ev, *fixed)
        got = rf.round_step(*state, *ev, *fixed)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), t
        state = list(got[:3])
    assert rf.round_words(n * k, cuda) is words
    assert words[n * k].item() == words[n * k + 1].item() >= 20   # tags


def test_round_step_buffers_kept_apart_by_size(cuda):
    """Two (n*k) sizes get two buffers, each reused by its own calls, and
    interleaved calls of the two stay bit for bit."""
    a = make_round(cuda, 50, 6, 32, 300, seed=30)
    b = make_round(cuda, 70, 6, 32, 300, seed=31)
    for r in range(3):
        for args in (a, b):
            want = rf.round_step_plain(*(v.clone() for v in args.values()))
            got = rf.round_step(*args.values())
            assert all(torch.equal(g, w) for g, w in zip(got, want)), r
    wa, wb = rf.round_words(300, cuda), rf.round_words(420, cuda)
    assert wa.data_ptr() != wb.data_ptr()
    assert wa.shape == (302,) and wb.shape == (422,)


def test_round_step_allocates_only_keep(cuda):
    """After its buffer exists, a call allocates nothing of size n*k: the
    buffer stays where it was and the device's allocated bytes grow by
    keep's m bytes at most."""
    n, k, p, m = 4000, 18, 32, 2048            # m a multiple of 512 B
    args = make_round(cuda, n, k, p, m, seed=40)
    rf.round_step(*args.values())
    ptr = rf.round_words(n * k, cuda).data_ptr()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = rf.round_step(*args.values())
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    assert rf.round_words(n * k, cuda).data_ptr() == ptr
    assert grown <= m, grown
    assert out[3].numel() == m


@pytest.mark.parametrize("E,p,rho", [(1, 1, 1.0), (1000, 32, 0.7),
                                     (333, 45, 2.5)])
def test_admm_edge_kernel(cuda, E, p, rho):
    rng = np.random.default_rng(E + p)
    args = on(cuda, *(rng.standard_normal((E, p)) for _ in range(8)))
    before = au.launches
    got = au.admm_edge_update(*args, rho=rho)
    assert au.launches == before + 1
    want = au.admm_edge_update_plain(*args, rho)
    assert all(torch.equal(g, w) for g, w in zip(got, want))  # bit for bit


def make_cl_edge(dev, n, B, p, seed, rho=1.0):
    """One CL-ADMM edge phase from the port's own scheduler: a small
    topology and B wake-ups with dropped and stale sides (B >= n makes
    repeated (agent, slot) targets certain), a random state, and the stale
    payload gathered from a random previous-round snapshot, as the engine
    gathers it (so repeated targets carry identical values)."""
    from repro_torch.simulate import (NetworkConditions,
                                      precompute_event_stream,
                                      random_geometric_topology)
    from repro_torch.simulate.engines import _event_sides
    topo = random_geometric_topology(n, k=4, seed=seed)
    tabs = topo.device_tables(dev)
    cond = NetworkConditions(drop_prob=0.3, stale_prob=0.3)
    stream = precompute_event_stream(
        tabs, torch.as_tensor(topo.partition_halves()), cond, B, seed, 1,
        device=dev)
    sides = _event_sides(stream.batch_at(0))
    k = topo.k_max
    rng = np.random.default_rng(seed)
    f = on(dev, rng.standard_normal((n, p)), *(rng.standard_normal(
        (n, k, p)) for _ in range(5)))
    snap = on(dev, rng.standard_normal((n, p)), *(rng.standard_normal(
        (n, k, p)) for _ in range(3)))
    pay = rf.cl_stale_prefetch(*snap, sides[2], sides[3])
    return f + list(pay), sides, rho


def cl_edge_run(fn, f, sides, rho):
    state = [t.clone() for t in f]
    return fn(*state, *sides, rho=rho)


@pytest.mark.parametrize("n,B,p,seed,rho", [(50, 200, 32, 1, 1.0),
                                            (300, 300, 9, 2, 0.7),
                                            (40, 80, 40, 3, 1.5)])
def test_cl_edge_step_kernel(cuda, n, B, p, seed, rho):
    f, sides, rho = make_cl_edge(cuda, n, B, p, seed, rho)
    upd, own_s, _, _, stale, got = sides
    tgt = upd.long() * f[1].shape[1] + own_s.long()
    landed_tgt = tgt[got]
    assert landed_tgt.unique().numel() < landed_tgt.numel()   # duplicates
    assert (stale & got).any()
    before = rf.cl_edge_launches
    out = cl_edge_run(rf.cl_edge_step, f, sides, rho)
    assert rf.cl_edge_launches == before + 1
    want = cl_edge_run(rf.cl_edge_step_plain, f, sides, rho)
    assert all(torch.equal(g, w) for g, w in zip(out, want))  # bit for bit


def test_cl_edge_step_nothing_got_is_identity(cuda):
    f, sides, rho = make_cl_edge(cuda, 30, 40, 8, 4)
    sides = sides[:5] + (torch.zeros_like(sides[5]),)
    out = cl_edge_run(rf.cl_edge_step, f, sides, rho)
    assert all(torch.equal(g, w) for g, w in zip(out, f[2:6]))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("p", [9, 32, 40])
def test_cl_edge_step_election_cases(cuda, case, p):
    """Rounds built for each election case (tests/_cl_rounds.py): bit for
    bit the plain version, election words zero after each call, and a
    second call on the first's output (a replay of the kernel on two
    copies) bit-identical too."""
    f, sides, rho, k = election_round(case, cuda, p=p)
    n = f[1].shape[0]
    flags = rf.cl_edge_flags(n * k, cuda)
    assert flags is rf.cl_edge_flags(n * k, f[0].device)  # the wrapper's
    a, b, plain = ([t.clone() for t in f] for _ in range(3))
    for _ in range(2):
        out_a = rf.cl_edge_step(*a, *sides, rho=rho)
        assert not flags.any()
        out_b = rf.cl_edge_step(*b, *sides, rho=rho)
        assert not flags.any()
        want = rf.cl_edge_step_plain(*plain, *sides, rho=rho)
        assert all(torch.equal(x, w) for x, w in zip(out_a, want))
        assert all(torch.equal(x, y) for x, y in zip(out_a, out_b))


def test_cl_edge_step_flags_are_zero_after_engine_rounds(cuda):
    f, sides, rho = make_cl_edge(cuda, 200, 400, 32, 6)
    flags = rf.cl_edge_flags(f[1].shape[0] * f[1].shape[1], f[0].device)
    cl_edge_run(rf.cl_edge_step, f, sides, rho)
    torch.cuda.synchronize()
    assert not flags.any()


def test_dispatch_auto_picks_kernels(cuda):
    for op in ("mix", "sparse_mix", "round_step", "admm_edge",
               "cl_edge_step", "attention"):
        assert dispatch.resolve(op, None, cuda) \
            is dispatch._REGISTRY[op]["cuda"]


def randn(dev, shape, dtype, g):
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("dtype,B,S,H,K,hd,window", [
    (torch.bfloat16, 1, 256, 8, 2, 128, None),
    (torch.bfloat16, 2, 192, 4, 4, 64, 100),    # a half-full query tile
    (torch.bfloat16, 1, 512, 4, 2, 128, 1),     # only the diagonal key
    (torch.bfloat16, 1, 64, 8, 2, 128, None),   # less than one query tile
    (torch.bfloat16, 2, 64, 4, 4, 64, None),
    (torch.bfloat16, 2, 320, 8, 1, 64, 63),     # GQA 8:1
    (torch.bfloat16, 1, 448, 16, 2, 128, 200),  # windows not a multiple
    (torch.bfloat16, 2, 384, 8, 2, 64, 200),    # of the 128-key tile
    (torch.bfloat16, 1, 384, 8, 1, 128, 63),
    (torch.float32, 1, 128, 4, 1, 64, None),
    (torch.float32, 2, 256, 6, 3, 128, 64),
    (torch.float32, 1, 320, 2, 2, 64, 1000),    # window beyond S
    # head dim 256 (RecurrentGemma: MQA, 80-key tiles in bf16)
    (torch.bfloat16, 1, 512, 10, 1, 256, 128),
    (torch.bfloat16, 1, 256, 4, 2, 256, None),
    (torch.bfloat16, 2, 192, 2, 1, 256, 100),   # half-full query tile
    (torch.bfloat16, 1, 64, 2, 2, 256, None),
    (torch.bfloat16, 1, 384, 4, 1, 256, 1),     # only the diagonal key
    (torch.float32, 1, 256, 4, 1, 256, None),
    (torch.float32, 1, 320, 4, 2, 256, 64),
    # the warp-specialised kernel's edges: hd 64 in 64-query blocks and
    # 64-key tiles split between two warpgroups, hd 256 in 128-query blocks
    # and 80-key tiles
    (torch.bfloat16, 1, 64, 2, 1, 64, 1),       # one block, diagonal only
    (torch.bfloat16, 1, 192, 6, 3, 64, 65),     # windows not a multiple
    (torch.bfloat16, 2, 320, 4, 2, 64, 130),    # of the 64-key tile
    (torch.bfloat16, 1, 320, 24, 24, 64, None),     # MHA, many blocks
    (torch.bfloat16, 2, 320, 10, 1, 256, 100),  # MQA 10:1, B = 2, the
    (torch.bfloat16, 2, 256, 10, 1, 256, None),     # last tile half full
    (torch.bfloat16, 1, 448, 4, 2, 256, 65),
    (torch.bfloat16, 1, 384, 2, 1, 256, 1000),   # window beyond S
    # the float32 3xTF32 kernel's edges: 64-query blocks, 64-key tiles
    # through K and V rings of one stage (hd 128) or two (hd 64)
    (torch.float32, 1, 320, 8, 2, 128, 33),     # windows not a multiple
    (torch.float32, 2, 256, 4, 2, 64, 65),      # of the key tile
    (torch.float32, 1, 384, 4, 1, 128, 100),
    (torch.float32, 1, 128, 2, 2, 128, 1),      # only the diagonal key
    (torch.float32, 1, 256, 8, 1, 64, None),    # GQA 8:1
    (torch.float32, 2, 192, 8, 1, 128, 63),
    (torch.float32, 1, 512, 24, 24, 64, None),  # MHA, many blocks
    (torch.float32, 2, 320, 16, 16, 128, None),
    (torch.float32, 1, 64, 2, 1, 64, None),     # S = 64: one block a head
    (torch.float32, 2, 64, 4, 2, 128, 1),
    (torch.float32, 1, 4096, 8, 2, 128, None),      # 128 kv tiles a row
    # the float32 hd-256 kernel's edges: 64-query blocks, 64-key tiles,
    # K and V^T streamed through one ring in 32-hd pieces
    (torch.float32, 1, 320, 4, 1, 256, 100),    # windows not a multiple
    (torch.float32, 2, 256, 2, 2, 256, 65),     # of the key tile
    (torch.float32, 1, 384, 10, 1, 256, 130),   # MQA 10:1
    (torch.float32, 1, 64, 2, 1, 256, None),    # S = 64: one block a head
    (torch.float32, 1, 192, 2, 1, 256, 1),      # only the diagonal key
    (torch.float32, 1, 4096, 10, 1, 256, 2048)])    # RecurrentGemma-2B
def test_flash_attention_kernel(cuda, dtype, B, S, H, K, hd, window):
    """bf16 (wgmma): the kernel rounds the softmax weights to bf16 once
    per kv tile (128 keys at hd 128, 80 at hd 256, 64 at hd 64) before
    P @ V, as the JAX oracle does; the plain version keeps them in
    float32.  That moves the output by about one bf16 ulp
    (tests/test_torch_tc_numerics.py), inside the bar of 1e-2 abs and rel.
    float32: 3xTF32 on the tensor cores (each kv tile's products from
    zero, added in IEEE float32): 1e-5."""
    g = torch.Generator(device=cuda).manual_seed(S + H + K)
    q = randn(cuda, (B, S, H, hd), dtype, g)
    k = randn(cuda, (B, S, K, hd), dtype, g)
    v = randn(cuda, (B, S, K, hd), dtype, g)
    before = fa.launches
    got = fa.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = fa.flash_attention_plain(q, k, v, window=window)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    assert torch.allclose(got.float(), want.float(), atol=tol, rtol=tol), \
        (got.float() - want.float()).abs().max().item()


@pytest.mark.parametrize("dtype,hd,window", [(torch.bfloat16, 128, None),
                                              (torch.bfloat16, 64, 63),
                                              (torch.bfloat16, 256, 100),
                                              (torch.float32, 64, None),
                                              (torch.float32, 256, None),
                                              (torch.float32, 128, 100)])
def test_flash_attention_kernel_replay_is_bit_identical(cuda, dtype, hd,
                                                        window):
    g = torch.Generator(device=cuda).manual_seed(hd)
    q = randn(cuda, (2, 320, 8, hd), dtype, g)
    k = randn(cuda, (2, 320, 2, hd), dtype, g)
    v = randn(cuda, (2, 320, 2, hd), dtype, g)
    assert torch.equal(fa.flash_attention(q, k, v, window=window),
                       fa.flash_attention(q, k, v, window=window))


@pytest.mark.parametrize("hd", [256, 64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_hd256_does_not_spill(cuda, dtype, hd):
    """No local memory.  In bf16 hd 256 and 64 run the warp-specialised
    kernel: at hd 256 the 64 x 256 float32 O accumulator (128 registers a
    thread) fits the consumers' 240 after setmaxnreg (the launch's 168 a
    thread of 384); at hd 64 two 256-thread blocks share an SM, at most
    128 registers a thread.  In float32 every head dim runs a 3xTF32
    kernel: one 256-thread block an SM (its shared memory, 192 KB at hd
    128 and 225 KB at hd 256).  At hd 64 and 128 its consumer holds O
    (hd / 2 registers), a 32-column part's two accumulators (32) and P's
    hi and lo fragments of a 64-key tile (64).  At hd 256 O takes 128, so
    P's lo goes through shared memory: the consumer holds O, S's two
    accumulators (64) until the softmax, then P's hi (32) and a part's two
    sums (32), inside a thread's 255."""
    res = fa.flash_attention_resources(hd, dtype)
    limit, blocks = {(torch.bfloat16, 256): (168, 1),
                     (torch.bfloat16, 64): (128, 2),
                     (torch.float32, 64): (255, 1),
                     (torch.float32, 128): (255, 1),
                     (torch.float32, 256): (255, 1)}.get((dtype, hd),
                                                         (255, None))
    assert res["local_bytes"] == 0 and 0 < res["registers"] <= limit, res
    assert blocks is None or res["blocks_per_sm"] == blocks, res


def test_flash_attention_kernel_rejects_out_of_contract(cuda):
    ok = torch.zeros(1, 128, 4, 64, device=cuda)
    before = fa.launches
    for q, k, err in (
            (torch.zeros(1, 100, 4, 64, device=cuda),
             torch.zeros(1, 100, 2, 64, device=cuda), ValueError),
            (torch.zeros(1, 128, 4, 96, device=cuda),
             torch.zeros(1, 128, 4, 96, device=cuda), ValueError),
            (ok.half(), ok.half(), TypeError),
            (ok, ok.transpose(1, 2).contiguous().transpose(1, 2),
             ValueError)):
        with pytest.raises(err):
            fa.flash_attention(q, k, k)
    assert fa.launches == before


def test_model_prefill_through_the_kernel(cuda):
    """A small float32 model (hd = 64): the flash route through the kernel
    against the same model through the reference implementation."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config("llama3-8b", "reduced"),
                              d_model=512, attn_impl="flash", attn_chunk=64,
                              compute_dtype=torch.float32)
    model = Model(cfg, device=cuda).init(
        torch.Generator(device=cuda).manual_seed(0))
    tok = torch.randint(0, cfg.vocab_size, (2, 128), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    dispatch.reset_launch_counts()
    got, cache = model.prefill({"tokens": tok}, cache_len=160)
    assert dispatch.launch_counts()["flash_attention"] == cfg.n_layers
    model.backend = dispatch.ReproBackend.using(attention="reference")
    want, cache_ref = model.prefill({"tokens": tok}, cache_len=160)
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)
    assert torch.allclose(cache["layers"][1]["k"],
                          cache_ref["layers"][1]["k"], atol=1e-4)


FAMILIES = ["olmoe-1b-7b", "phi3.5-moe", "recurrentgemma-2b", "xlstm-1.3b",
            "qwen2-vl-7b", "musicgen-medium"]


def family_inputs(cfg, S=16, B=2):
    """Text tokens; or a VLM's patches and M-RoPE ids; or audio's
    conditioning and codes: S positions in all, from a seed."""
    rng = np.random.default_rng(3)
    V, d = cfg.vocab_size, cfg.d_model
    if cfg.family == "audio":
        n = cfg.n_cond_tokens
        return {"tokens": rng.integers(0, V, (B, cfg.n_codebooks, S - n)),
                "cond_embeds": rng.standard_normal((B, n, d))
                .astype(np.float32)}
    if cfg.family == "vlm":
        n = cfg.n_media_tokens
        p3 = np.broadcast_to(np.arange(S), (3, B, S)).copy()
        p3[1:, :, :n] = np.arange(n) % 4
        return {"tokens": rng.integers(0, V, (B, S - n)),
                "patch_embeds": rng.standard_normal((B, n, d))
                .astype(np.float32), "positions3": p3}
    return {"tokens": rng.integers(0, V, (B, S))}


@pytest.mark.parametrize("arch", FAMILIES)
def test_family_on_the_card_matches_the_cpu(cuda, arch):
    """Each family's REDUCED config in float32, the same weights on the
    card and on the CPU: forward, a ring prefill and three ring decode
    steps within 1e-4 (float32 sums in another order); the MoE forms'
    logits on the card bit for bit."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_config(arch, "reduced"),
                              compute_dtype=torch.float32)
    cpu = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    card = Model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    batch = family_inputs(cfg)

    def on_dev(b, dev):
        return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}

    def near(got, want):
        assert torch.allclose(got.cpu(), want, atol=1e-4, rtol=1e-4), \
            (got.cpu() - want).abs().max().item()
    near(card.forward(on_dev(batch, cuda)), cpu.forward(on_dev(batch,
                                                               "cpu")))
    lg, cg = card.prefill(on_dev(batch, cuda), cache_len=12)
    lc, cc = cpu.prefill(on_dev(batch, "cpu"), cache_len=12)
    near(lg, lc)
    rng = np.random.default_rng(4)
    shape = (2, cfg.n_codebooks) if cfg.family == "audio" else (2,)
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab_size, shape)
        lg, cg = card.decode_step(cg, {"token": torch.as_tensor(
            tok, device=cuda)}, ring=True)
        lc, cc = cpu.decode_step(cc, {"token": torch.as_tensor(tok)},
                                 ring=True)
        near(lg, lc)
    if cfg.n_experts:
        scatter = card.forward(on_dev(batch, cuda))
        card.cfg = dataclasses.replace(cfg, moe_impl="gather")
        assert torch.equal(card.forward(on_dev(batch, cuda)), scatter)


# ---------------------------------------------------------------------------
# the paper's other algorithms on the card: async gossip, joint graph
# learning and the nonlinear CL-ADMM agents (no kernels of their own; the
# nonlinear agents run cl_edge_step at p = 33)
# ---------------------------------------------------------------------------


def test_edge_reweight_on_the_card_matches_the_cpu(cuda):
    """CUDA's cumsum associates its adds differently from the CPU's, so
    the projection agrees to rounding (1e-5), not bit for bit."""
    from repro_torch.kernels import ref
    rng = np.random.default_rng(0)
    live = rng.uniform(size=(5000, 18)) < 0.85
    w = rng.uniform(0, 1, live.shape) * live
    w = (w / np.maximum(w.sum(1, keepdims=True), 1e-9)).astype(np.float32)
    d = rng.uniform(0, 4, live.shape).astype(np.float32)
    for eta, lam in ((0.3, 1.0), (1.0, 1e-3), (0.5, 1e3)):
        want = ref.edge_reweight(*map(torch.as_tensor, (d, w, live)),
                                 eta=eta, lam=lam)
        got = ref.edge_reweight(*(torch.as_tensor(a, device=cuda)
                                  for a in (d, w, live)), eta=eta, lam=lam)
        assert (got.cpu() - want).abs().max().item() <= 1e-5


def test_sparse_async_gossip_equals_dense_on_the_card(cuda):
    from repro_torch.core.graph import random_geometric_graph
    from repro_torch.core.model_propagation import async_gossip
    from repro_torch.simulate import sparse_async_gossip
    from repro_torch.simulate.topology import SparseTopology
    g = random_geometric_graph(64, k=5, seed=3)
    rng = np.random.default_rng(1)
    sol = rng.standard_normal((64, 32)).astype(np.float32)
    c = rng.uniform(0.05, 1.0, 64).astype(np.float32)
    dense = async_gossip(g, sol, c, 0.9, 600, seed=2, record_every=100,
                         device=cuda)
    topo = SparseTopology.from_graph(g)
    sparse = sparse_async_gossip(topo, sol, c, 0.9, 600, seed=2,
                                 record_every=100, device=cuda)
    assert torch.equal(dense.theta_hist, sparse.theta_hist)
    tabs = topo.tables
    rows, slots = np.nonzero(np.arange(topo.k_max)[None, :]
                             < tabs.deg_count[:, None])
    assert torch.equal(sparse.final_knowledge[rows, slots],
                       dense.final_knowledge[rows, tabs.nbr_idx[rows,
                                                                 slots]])


def test_joint_rate_zero_is_per_op_mp_on_the_card(cuda):
    from repro_torch.simulate import (NetworkConditions, ScenarioSpec,
                                      run_scenario)
    topo = random_geometric_topology(3000, k=6, seed=0)
    rng = np.random.default_rng(0)
    sol = rng.standard_normal((3000, 32)).astype(np.float32)
    c = rng.uniform(0.05, 1.0, 3000).astype(np.float32)
    kw = dict(topology=topo, conditions=NetworkConditions(
        drop_prob=0.1, stale_prob=0.3), rounds=40, batch=300, seed=1,
        record_every=10, theta_sol=sol, c=c, alpha=0.9, device=cuda)
    mp = run_scenario(ScenarioSpec(algo="mp", **kw))
    joint = run_scenario(ScenarioSpec(algo="joint", **kw))
    assert torch.equal(joint.theta_hist, mp.theta_hist)
    assert (joint.delivered, joint.dropped, joint.invalid) == \
        (mp.delivered, mp.dropped, mp.invalid)
    learned = run_scenario(ScenarioSpec(
        algo="joint", eta_graph=0.3, lam=1.0, graph_every=5,
        prune_eps=1e-3, **kw))
    live = learned.final_live
    assert (learned.final_w[~live] == 0).all()
    sums = learned.final_w.sum(1)[live.any(1)]
    assert (sums - 1).abs().max().item() <= 1e-5
    assert learned.suppressed <= learned.delivered


def test_inexact_primal_kernel_matches_reference_at_p33(cuda):
    """MLP agents (p = 33, cl_edge_step's generic-p path): the kernel run
    and the reference run agree within 1e-5, one launch a round."""
    from repro_torch.core.primal import InexactPrimal, solitary_adamw
    from repro_torch.data import federated_moons_problem
    from repro_torch.models import MLPAgent
    from repro_torch.simulate import (NetworkConditions, ScenarioSpec,
                                      run_scenario)
    model = MLPAgent(in_dim=2, hidden=(8,))
    topo, train, _, _ = federated_moons_problem(n=400, seed=0, device=cuda)
    sol = solitary_adamw(train, loss="logistic", model=model, steps=50)
    assert sol.shape == (400, 33)
    runs, launches = [], []
    for backend in (None, dispatch.ReproBackend(default="reference")):
        dispatch.reset_launch_counts()
        runs.append(run_scenario(ScenarioSpec(
            algo="cl", topology=topo, data=train, mu=0.5, rho=0.2,
            conditions=NetworkConditions(drop_prob=0.1, stale_prob=0.2),
            rounds=30, batch=40, seed=0, record_every=10, theta_sol=sol,
            primal=InexactPrimal(loss="logistic", model=model, b_steps=4,
                                 lr=0.1),
            backend=backend, device=cuda)))
        launches.append(dispatch.launch_counts()["cl_edge_step"])
    assert launches == [30, 0]
    assert (runs[0].theta_hist - runs[1].theta_hist).abs().max().item() \
        <= 1e-5
    assert torch.isfinite(runs[0].theta_hist).all()


# the rows kernel (D <= 8) on rows shorter than a warp, unaligned rows
# (n % 4 != 0: 4-byte loads), the sweeps' n = 300 and rows longer than one
# round of loads (n = 4099, theta too large to stage at D = 5 and 8)
ROWS_CASES = [(T, n, D) for D in (2, 5, 8) for T, n in (
    (300, 1), (300, 31), (20, 257), (300, 300), (1, 300), (20, 4099))]


@pytest.mark.parametrize("T,n,D", [(300, 300, 1), (7, 129, 3),
                                   (3, 256, 512), (2, 257, 301)]
                         + ROWS_CASES)
def test_graph_mix_kernel_trial_axis(cuda, T, n, D):
    """One launch for T trials; each trial's result equals its own
    unbatched launch bit for bit, a replay equals the first call bit for
    bit, and the plain version within 1e-5."""
    rng = np.random.default_rng(T + n + D)
    args = on(cuda, rng.standard_normal((T, n, D), dtype=np.float32),
              rng.standard_normal((T, n, D), dtype=np.float32),
              rng.random((T, n, n), dtype=np.float32) / n,
              rng.random((T, n), dtype=np.float32))
    before = gm.launches
    got = gm.graph_mix(*args)
    assert gm.launches == before + 1
    assert (got - gm.graph_mix_plain(*args)).abs().max().item() <= 1e-5
    for t in sorted({0, T // 2, T - 1}):
        assert torch.equal(got[t], gm.graph_mix(*(a[t] for a in args)))
    assert torch.equal(got, gm.graph_mix(*args))


@pytest.mark.parametrize("n,D", [(300, 1), (300, 5), (4100, 8)])
def test_graph_mix_rows_load_width_keeps_the_sum(cuda, n, D):
    """A moved 4 bytes off its 16-byte alignment takes the rows kernel's
    4-byte loads; the result is the same bits as with 16-byte loads."""
    T = 3
    rng = np.random.default_rng(n + D)
    theta, sol, A, b = on(cuda, rng.standard_normal((T, n, D)),
                          rng.standard_normal((T, n, D)),
                          rng.random((T, n, n)) / n, rng.random((T, n)))
    buf = torch.empty(T * n * n + 1, device=cuda)
    shifted = buf[1:].view(T, n, n)
    shifted.copy_(A)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    assert torch.equal(gm.graph_mix(theta, sol, A, b),
                       gm.graph_mix(theta, sol, shifted, b))


@pytest.mark.parametrize("n,D", [(512, 64), (2048, 4096)])
def test_graph_mix_tile_kernel_holds_over_3000_steps(cuda, n, D):
    """The tile kernel (D > 8) in ``synchronous`` at alpha = 0.99 for 3000
    steps stays within 1e-5 of the plain version: its partial sums reach
    the accumulator by IEEE adds, so truncation in the tensor core does not
    pile up near the fixed point.  At chip_smoke.py's 4c shape the sum
    carried through the tensor core's own adds drifted past 1e-5."""
    from repro_torch.core.graph import random_geometric_graph
    from repro_torch.core.model_propagation import synchronous
    g = random_geometric_graph(n, k=8, seed=0)
    rng = np.random.default_rng(0)
    sol = rng.standard_normal((n, D)).astype(np.float32)
    c = rng.uniform(0.05, 1.0, n).astype(np.float32)
    dispatch.reset_launch_counts()
    got = synchronous(g, sol, c, 0.99, 3000, device=cuda)
    assert dispatch.launch_counts()["graph_mix"] == 3000
    want = synchronous(g, sol, c, 0.99, 3000, device=cuda,
                       backend=dispatch.ReproBackend(default="reference"))
    assert (got - want).abs().max().item() <= 1e-5


def test_mp_sweep_one_launch_per_step_on_the_card(cuda):
    from repro_torch.experiments import mean_estimation_trials, run_mp_sweep
    trials = mean_estimation_trials(seeds=[0, 1, 2], alphas=[0.5, 0.9],
                                    n=60)
    dispatch.reset_launch_counts()
    got = run_mp_sweep(trials, sweeps=40, device=cuda)
    assert dispatch.launch_counts()["graph_mix"] == 40
    want = run_mp_sweep(trials, sweeps=40, device=cuda,
                        backend=dispatch.ReproBackend(default="reference"))
    assert np.abs(got.theta_final - want.theta_final).max() <= 1e-5
    assert np.isfinite(got.objective_hist).all()


@pytest.mark.parametrize("algo", ["mp-fused", "cl", "joint"])
def test_telemetry_observes_only_on_the_card(cuda, algo):
    from repro_torch.core.losses import pad_datasets, solitary_mean
    from repro_torch.simulate import (NetworkConditions, ScenarioSpec,
                                      run_scenario)
    from repro_torch.telemetry import TelemetryConfig, metrics
    n, rounds, rec = 3000, 40, 10
    topo = random_geometric_topology(n, k=6, seed=0)
    rng = np.random.default_rng(0)
    kw = dict(topology=topo, conditions=NetworkConditions(
        drop_prob=0.1, stale_prob=0.3, churn_rate=0.01,
        partition_start=5, partition_end=20), rounds=rounds, batch=300,
        seed=1, record_every=rec, device=cuda)
    if algo == "cl":
        data = pad_datasets(list(rng.standard_normal((n, 3, 8))),
                            device=cuda)
        kw.update(algo="cl", data=data, mu=0.1, rho=1.0,
                  theta_sol=solitary_mean(data))
    else:
        kw.update(theta_sol=rng.standard_normal((n, 8)).astype(np.float32),
                  c=rng.uniform(0.05, 1.0, n).astype(np.float32), alpha=0.9)
        if algo == "mp-fused":
            kw.update(algo="mp", backend=dispatch.ReproBackend())
        else:
            kw.update(algo="joint", eta_graph=0.3, graph_every=5,
                      prune_eps=1e-3)
    runs, launches = [], []
    for tel in (None, TelemetryConfig(enabled=True)):
        dispatch.reset_launch_counts()
        runs.append(run_scenario(ScenarioSpec(**kw, telemetry=tel)))
        launches.append(dispatch.launch_counts())
    off, on_ = runs
    assert launches[0] == launches[1]
    assert torch.equal(off.theta_hist, on_.theta_hist)
    f = on_.telemetry
    assert int(f.delivered[-1]) == on_.delivered
    assert int((f.drop_link + f.drop_churn + f.drop_partition)[-1]) == \
        on_.dropped
    assert np.isfinite(f.objective).all()
    if algo != "joint":
        from repro_torch.simulate import precompute_event_stream
        stream = precompute_event_stream(
            topo.device_tables(cuda), torch.as_tensor(
                topo.partition_halves()), kw["conditions"], 300, 1, rounds,
            device=cuda)
        np.testing.assert_array_equal(f.staleness,
                                      metrics.stream_staleness_chunks(
                                          stream, n, rounds // rec, rec))
        assert int(f.updates[-1]) == on_.delivered
    else:
        np.testing.assert_array_equal(f.updates + f.suppressed, f.delivered)


# the agent-axis form: n <= 32 agents, D > 8 (the LM coupling's shape),
# ragged D (4-byte and 2-byte element loads) and aligned D (16-byte loads)
AGENT_CASES = [(n, D) for n in (2, 3, 8, 32) for D in (9, 1001, 4096,
                                                       65536 + 3)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,D", AGENT_CASES)
def test_graph_mix_agent_axis(cuda, n, D, dtype):
    rng = np.random.default_rng(n * D)
    dt = getattr(torch, dtype)
    args = on(cuda, rng.standard_normal((n, D)), rng.standard_normal((n, D)),
              rng.random((n, n)) / n, dtype=dt)
    args.append(torch.as_tensor(rng.random(n), dtype=torch.float32,
                                device=cuda))
    before = gm.launches
    got = gm.graph_mix(*args)
    assert gm.launches == before + 1 and got.dtype == dt
    want = gm.graph_mix_plain(*args)
    if dtype == "float32":
        assert (got - want).abs().max().item() <= 1e-5
    else:
        assert ((got.float() - want.float()).abs()
                <= gm.bf16_tolerance(*args)).all()
    assert torch.equal(got, gm.graph_mix(*args))              # a replay


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_mix_agent_axis_slice_of_d_is_its_own_launch(cuda, dtype):
    """An output element's sum order depends only on n: columns lo..hi of
    a launch equal a launch on those columns alone, bit for bit, and so
    do the trials of a trial-axis launch."""
    rng = np.random.default_rng(3)
    dt = getattr(torch, dtype)
    n, D, lo, hi = 8, 100_003, 777, 50_777
    theta, sol, A = on(cuda, rng.standard_normal((n, D)),
                       rng.standard_normal((n, D)), rng.random((n, n)) / n,
                       dtype=dt)
    b = torch.as_tensor(rng.random(n), dtype=torch.float32, device=cuda)
    full = gm.graph_mix(theta, sol, A, b)
    part = gm.graph_mix(theta[:, lo:hi].contiguous(),
                        sol[:, lo:hi].contiguous(), A, b)
    assert torch.equal(full[:, lo:hi], part)
    stack = [torch.stack([x, x.flip(0)]) for x in (theta, sol, A)]
    both = gm.graph_mix(*stack, torch.stack([b, b.flip(0)]))
    assert torch.equal(both[0], full)


def test_graph_mix_bf16_outside_the_agent_axis_raises(cuda):
    x = torch.zeros((40, 16), dtype=torch.bfloat16, device=cuda)
    A = torch.zeros((40, 40), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError, match="n <= 32"):
        gm.graph_mix(x, x, A, torch.zeros(40, device=cuda))


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One mp-coupled step of a small LM (float32 compute) on the card,
    through the agent-axis kernel, against the same step on the CPU:
    losses within 1e-4 relative (cuBLAS and the CPU sum in other orders),
    parameters within 2 * lr * 2**-8 (a bf16 moment may round one ulp the
    other way)."""
    from repro_torch.core.graph import random_geometric_graph
    from repro_torch.coupling import CouplingConfig, make_state
    from repro_torch.models import Model, ModelConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_train_state, \
        make_train_step
    from repro_torch.tree import tree_leaves
    cfg = ModelConfig(name="t", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=96,
                      attn_impl="chunked", attn_chunk=8,
                      compute_dtype=torch.float32)
    model = Model(cfg, device="meta")
    lr, A = 1e-2, 4
    tcfg = TrainConfig(n_agents=A, steps=5, optimizer=AdamWConfig(lr=lr),
                       coupling=CouplingConfig(mode="mp", alpha=0.9))
    g = random_geometric_graph(A, k=2, seed=0)
    cpu = init_train_state(model, tcfg, torch.Generator().manual_seed(0),
                           perturb=0.01, device="cpu")
    card = state_to(cpu, cuda)
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 96, (A * 2, 17))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    dispatch.reset_launch_counts()
    card, mc = make_train_step(model, tcfg, make_state(g, device=cuda))(
        card, batch)
    assert dispatch.launch_counts()["graph_mix"] == len(
        tree_leaves(cpu.params))
    cpu, mh = make_train_step(model, tcfg, make_state(g, device="cpu"))(
        cpu, batch)
    np.testing.assert_allclose(mc["loss_per_agent"].cpu().numpy(),
                               mh["loss_per_agent"].numpy(), rtol=1e-4)
    for a, b in zip(tree_leaves(card.params), tree_leaves(cpu.params)):
        assert (a.cpu() - b).abs().max().item() <= 2 * lr * 2 ** -8


def state_to(state, device):
    """A copy of a TrainState with its trees on ``device``."""
    from repro_torch.train import TrainState
    from repro_torch.tree import tree_map

    def to(tree):
        return tree_map(lambda t: t.to(device, copy=True), tree)
    return TrainState(params=to(state.params), opt_state=to(state.opt_state),
                      solitary=to(state.solitary), step=state.step.clone())


# ---------------------------------------------------------------------------
# the partitioned simulator on a LocalMesh of the card, and the sharded
# dispatch implementations
# ---------------------------------------------------------------------------


def _sharded_problem(cuda, n=3000, p=32):
    from repro_torch.core.losses import pad_datasets, solitary_mean
    from repro_torch.simulate import NetworkConditions
    topo = random_geometric_topology(n, k=6, seed=0)
    rng = np.random.default_rng(0)
    sol = torch.as_tensor(rng.standard_normal((n, p)), dtype=torch.float32,
                          device=cuda)
    c = torch.as_tensor(rng.uniform(0.05, 1.0, n), dtype=torch.float32,
                        device=cuda)
    data = pad_datasets(list(rng.standard_normal((n, 3, p))), device=cuda)
    cond = NetworkConditions(drop_prob=0.1, stale_prob=0.3, churn_rate=0.01,
                             straggler_frac=0.3, partition_start=5,
                             partition_end=20)
    kw = dict(topology=topo, conditions=cond, rounds=40, batch=300, seed=1,
              record_every=10, device=cuda)
    return topo, sol, c, data, solitary_mean(data), kw


@pytest.mark.parametrize("P", [2, 8])
def test_sharded_mp_on_the_card(cuda, P):
    """9a at a small n: the LocalMesh run equals the per-op single-device
    run bit for bit and the fused one within 1e-5, with no overflow, in
    either exchange and the bf16 and int8 codecs within their error."""
    from repro_torch.launch import LocalMesh
    from repro_torch.simulate import ScenarioSpec, run_scenario
    topo, sol, c, _, _, kw = _sharded_problem(cuda)
    kw.update(algo="mp", theta_sol=sol, c=c, alpha=0.9)
    per_op = run_scenario(ScenarioSpec(**kw))
    fused = run_scenario(ScenarioSpec(**kw, backend=dispatch.ReproBackend()))
    mesh = LocalMesh(P, cuda)
    for exchange in ("all_gather", "ring"):
        sh = run_scenario(ScenarioSpec(**kw, sharded=True, mesh=mesh,
                                       exchange=exchange))
        assert sh.overflow == 0 and sh.n_shards == P
        assert torch.equal(sh.theta_hist, per_op.theta_hist), exchange
        assert (sh.theta_hist - fused.theta_hist).abs().max().item() <= 1e-5
        assert (sh.delivered, sh.dropped, sh.invalid) == \
            (per_op.delivered, per_op.dropped, per_op.invalid)
        assert torch.equal(sh.active_hist, per_op.active_hist)
    for codec, tol in (("bf16", 2e-2), ("int8", 5e-2)):
        lossy = run_scenario(ScenarioSpec(**kw, sharded=True, mesh=mesh,
                                          halo_codec=codec))
        err = (lossy.theta_hist - per_op.theta_hist).abs().max().item()
        assert 0 < err <= tol, (codec, err)


@pytest.mark.parametrize("P", [2, 8])
def test_sharded_cl_on_the_card(cuda, P):
    """9b at a small n: sharded CL-ADMM equals the single-device run (the
    cl_edge_step kernel) bit for bit."""
    from repro_torch.launch import LocalMesh
    from repro_torch.simulate import ScenarioSpec, run_scenario
    topo, _, _, data, sol_cl, kw = _sharded_problem(cuda)
    kw.update(algo="cl", data=data, mu=0.1, rho=1.0, theta_sol=sol_cl)
    dispatch.reset_launch_counts()
    one = run_scenario(ScenarioSpec(**kw))
    assert dispatch.launch_counts()["cl_edge_step"] == one.rounds
    for exchange in ("all_gather", "ring"):
        sh = run_scenario(ScenarioSpec(**kw, sharded=True,
                                       mesh=LocalMesh(P, cuda),
                                       exchange=exchange))
        assert sh.overflow == 0
        assert torch.equal(sh.theta_hist, one.theta_hist), exchange
        assert (sh.delivered, sh.dropped, sh.invalid) == \
            (one.delivered, one.dropped, one.invalid)


def test_sharded_joint_on_the_card(cuda):
    """9c at a small n: the sharded joint run with halo re-compaction
    equals the single-device one (theta_hist, learned weights, live
    mask, counters)."""
    from repro_torch.launch import LocalMesh
    from repro_torch.simulate import ScenarioSpec, run_scenario
    topo, sol, c, _, _, kw = _sharded_problem(cuda)
    kw.update(algo="joint", theta_sol=sol, c=c, alpha=0.9, eta_graph=0.3,
              lam=1.0, graph_every=5, prune_eps=0.02)
    one = run_scenario(ScenarioSpec(**kw))
    sh = run_scenario(ScenarioSpec(**kw, sharded=True,
                                   mesh=LocalMesh(8, cuda),
                                   recompact_every=10, recompact_frac=0.02))
    assert sh.overflow == 0 and sh.recompactions >= 1
    assert torch.equal(sh.theta_hist, one.theta_hist)
    assert torch.equal(sh.final_w, one.final_w)
    assert torch.equal(sh.final_live, one.final_live)
    assert torch.equal(sh.live_edges_hist, one.live_edges_hist)
    assert sh.suppressed == one.suppressed


def test_cuda_sharded_sparse_mix_on_the_card(cuda):
    """9d at a small n: ``cuda_sharded`` runs the kernel once a block with
    the block's share of the locality order, bit for bit with
    ``reference_sharded`` and with the single-device kernel sweep."""
    from repro_torch.launch import LocalMesh, use_mesh
    topo = random_geometric_topology(5003, k=6, seed=1)
    rng = np.random.default_rng(2)
    sol = rng.standard_normal((5003, 32)).astype(np.float32)
    c = rng.uniform(0.05, 1.0, 5003).astype(np.float32)
    one = sparse_sync_mp(topo, sol, c, 0.9, 15, device=cuda)
    with use_mesh(LocalMesh(8, cuda)):
        dispatch.reset_launch_counts()
        got = sparse_sync_mp(topo, sol, c, 0.9, 15, device=cuda,
                             backend=dispatch.ReproBackend.using(
                                 sparse_mix="cuda_sharded"))
        assert dispatch.launch_counts()["sparse_gather_mix"] == 15 * 8
        assert sm.ordered_launches == 15 * 8
        plain = sparse_sync_mp(topo, sol, c, 0.9, 15, device=cuda,
                               backend=dispatch.ReproBackend.using(
                                   sparse_mix="reference_sharded"))
    assert torch.equal(got, plain)
    assert torch.equal(got, one)


def test_dryrun_predicts_the_card_peak(cuda):
    """``chip_smoke.py`` 10a at one layer: Llama-3-8B at full width, one
    agent, batch 2 at sequence 1024, three ``make_train_step`` steps with
    mp coupling on the card, and ``repro_torch.launch.dryrun`` of the same
    configuration on a 1 x 1 mesh of the fake backend: the predicted
    per-device peak within 25 % of ``max_memory_allocated``."""
    import importlib.util
    import pathlib
    import subprocess

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs.TRAIN_LAYERS = 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    rec, bad = cs.check_dryrun_card(torch, np, dispatch, cuda, smi)
    assert bad is None, bad
    assert rec["n_layers"] == 1
    assert abs(rec["peak_rel_diff"]) <= cs.DRY_PEAK_RTOL


def test_quickstart_example_backends_on_the_card(cuda):
    """``examples/quickstart_torch.py``'s backend part on the card: the
    MP iterates and the trial-axis sweep through the ``graph_mix`` kernel
    and through its plain version within 1e-5, the kernel launched."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" \
        / "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location(path.stem, path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    size = example.SIZES[False]
    dispatch.reset_launch_counts()
    out = example.backends_and_sweeps(cuda, size["sync_steps"],
                                      size["sweeps"])
    assert dispatch.launch_counts()["graph_mix"] >= 1
    assert out["cuda_vs_reference"] is not None
    assert out["cuda_vs_reference"] <= 1e-5
    assert out["sweep_cuda_vs_reference"] is not None
    assert out["sweep_cuda_vs_reference"] <= 1e-5


@pytest.mark.parametrize("name", ["serve_demo", "collab_serve_demo"])
def test_serving_demo_on_the_card(cuda, name):
    """``examples/<name>_torch.py --smoke`` on the card: serve_demo
    decodes 24 tokens for each of its 8 requests without exhausting its
    ticks, collab_serve_demo's gossip trajectory is bit for bit the same
    with serving on and off; neither launches a kernel (serve_demo
    attends by the ``ref`` route, collab_serve_demo passes no backend)."""
    import contextlib
    import importlib.util
    import io
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" \
        / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(path.stem, path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    dispatch.reset_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        out = example.main(["--smoke"])
    assert not any(dispatch.launch_counts().values())
    if name == "serve_demo":
        assert not out["exhausted"]
        assert out["tokens_by_request"] == {rid: 24 for rid in range(8)}
    else:
        assert out["identical"] is True
        assert out["requests"] == 800
