"""The port's CUDA kernels on the card, each held against its plain
PyTorch version on the same inputs (the tolerances of
tests/test_torch_kernels.py; ``cl_edge_step`` and ``admm_edge_update``
bit for bit, repeated targets included).  The kernels have no CPU mode:
on a host without a CUDA card every test here skips.

Run on the card with ``python -m pytest -q tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import admm_update as au  # noqa: E402
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.kernels import graph_mix as gm  # noqa: E402
from repro_torch.kernels import round_fuse as rf  # noqa: E402
from repro_torch.kernels import sparse_mix as sm  # noqa: E402

pytestmark = pytest.mark.cuda

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def on(dev, *arrays, dtype=torch.float32):
    return [torch.as_tensor(a, dtype=dtype, device=dev) for a in arrays]


@pytest.mark.parametrize("n,D", [(1, 1), (129, 300), (256, 512)])
def test_graph_mix_kernel(cuda, n, D):
    rng = np.random.default_rng(n + D)
    args = on(cuda, rng.standard_normal((n, D)), rng.standard_normal((n, D)),
              rng.uniform(size=(n, n)) / n, rng.uniform(size=n))
    before = gm.launches
    got = gm.graph_mix(*args)
    assert gm.launches == before + 1
    assert (got - gm.graph_mix_plain(*args)).abs().max().item() <= 1e-5


@pytest.mark.parametrize("N,n,k,p", [(300, 200, 7, 40), (64, 64, 3, 32),
                                     (50, 10, 1, 5)])
def test_sparse_gather_mix_kernel(cuda, N, n, k, p):
    rng = np.random.default_rng(N + n + k + p)
    table, w, b, sol = on(cuda, rng.standard_normal((N, p)),
                          rng.uniform(size=(n, k)), rng.uniform(size=n),
                          rng.standard_normal((n, p)))
    (idx,) = on(cuda, rng.integers(0, N, (n, k)), dtype=torch.int32)
    got = sm.sparse_gather_mix(table, idx, w, b, sol)
    want = sm.sparse_gather_mix_plain(table, idx, w, b, sol)
    assert torch.equal(got, want)       # same slot-order arithmetic


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
                                       deliver_frac=0.0)])
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


def test_dispatch_auto_picks_kernels(cuda):
    for op in ("mix", "sparse_mix", "round_step", "admm_edge",
               "cl_edge_step"):
        assert dispatch.resolve(op, None, cuda) \
            is dispatch._REGISTRY[op]["cuda"]
