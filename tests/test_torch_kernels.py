"""The port's kernel modules on the CPU, where each wrapper runs its plain
PyTorch version: ``graph_mix`` and ``sparse_gather_mix`` against the JAX
oracles and the Pallas kernels in interpret mode (atol 1e-5, the parity
bar of ``repro.kernels.dispatch``); ``round_step`` against
``ref.gossip_round_step`` and ``round_fuse.round_step_xla`` (keep and
got_ever exact, theta and Ke within 1e-6, the bar of
tests/test_round_fuse.py); the round helpers exactly; the dispatch rules.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py).
The JAX side of every comparison runs in a subprocess of its own beside
the tests before this module (``jax_references``;
tests/_port_session.py), on inputs made there from the same seeds.
"""

import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import round_fuse as jrf  # noqa: E402
from repro.kernels.graph_mix import graph_mix as pallas_graph_mix  # noqa: E402
from repro.kernels.sparse_mix import \
    sparse_gather_mix as pallas_sparse_mix  # noqa: E402

import _port_session  # noqa: E402
from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from _port_session import port_background_jobs  # noqa: E402,F401
from repro_torch.kernels import dispatch, ref as tref  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import graph_mix as tgm  # noqa: E402
from repro_torch.kernels import round_fuse as trf  # noqa: E402
from repro_torch.kernels import sparse_mix as tsm  # noqa: E402

ATOL = 1e-5


def t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


# ---------------------------------------------------------------------------
# graph_mix
# ---------------------------------------------------------------------------


GRAPH_MIX = [(4, 64), (16, 100), (37, 513)]


def graph_mix_args(n, D):
    rng = np.random.default_rng(n * 1000 + D)
    theta = rng.standard_normal((n, D)).astype(np.float32)
    sol = rng.standard_normal((n, D)).astype(np.float32)
    A = (rng.uniform(size=(n, n)) / n).astype(np.float32)
    b = rng.uniform(size=n).astype(np.float32)
    return theta, sol, A, b


@pytest.mark.parametrize("n,D", GRAPH_MIX)
def test_graph_mix_plain_matches_jax(refs, n, D):
    got = tgm.graph_mix(*map(t, graph_mix_args(n, D))).numpy()
    want, pallas = refs["graph_mix"][n, D]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    assert tgm.launches == 0          # CPU tensors never launch


# ---------------------------------------------------------------------------
# sparse_gather_mix
# ---------------------------------------------------------------------------

SPARSE_MIX = [(50, 50, 4, 32), (90, 37, 6, 9), (20, 20, 3, 40)]


def sparse_mix_args(N, n, k, p):
    rng = np.random.default_rng(N + n + k + p)
    table = rng.standard_normal((N, p)).astype(np.float32)
    idx = rng.integers(0, N, (n, k)).astype(np.int32)
    w = rng.uniform(size=(n, k)).astype(np.float32)
    w[:, -1] = 0.0                                 # a pad slot
    b = rng.uniform(size=n).astype(np.float32)
    sol = rng.standard_normal((n, p)).astype(np.float32)
    return table, idx, w, b, sol


@pytest.mark.parametrize("N,n,k,p", SPARSE_MIX)
def test_sparse_gather_mix_plain_matches_jax(refs, N, n, k, p):
    got = tsm.sparse_gather_mix(*map(t, sparse_mix_args(N, n, k, p))).numpy()
    want, pallas = refs["sparse_mix"][N, n, k, p]
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=ATOL, rtol=0)
    assert tsm.launches == 0


def aggregate_args():
    rng = np.random.default_rng(2)
    return (rng.uniform(size=(7, 5)).astype(np.float32),
            rng.standard_normal((7, 5, 3)).astype(np.float32))


def test_neighbor_aggregate_matches_jax(refs):
    w, th = aggregate_args()
    np.testing.assert_allclose(tref.neighbor_aggregate(t(w), t(th)).numpy(),
                               refs["aggregate"], atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# round_step
# ---------------------------------------------------------------------------


def make_round(n, k, p, m, seed, *, collide=True, deliver_frac=0.7,
               seen_frac=0.5):
    """A random round over the flat slot table: duplicate targets (when
    ``collide``), sentinel (undelivered) events and first receipts."""
    rng = np.random.default_rng(seed)
    K = rng.standard_normal((n, k, p)).astype(np.float32)
    Ke = np.concatenate([K.reshape(n * k, p),
                         rng.integers(-1, 50, (n * k, 1)).astype(np.float32)],
                        axis=1)
    codes = rng.integers(0, n * k, m) if collide \
        else rng.choice(n * k, size=m, replace=False)
    deliver = rng.uniform(size=m) < deliver_frac
    return dict(
        theta=rng.standard_normal((n, p)).astype(np.float32),
        Ke=Ke,
        got_ever=rng.uniform(size=n) < seen_frac,
        msg=rng.standard_normal((m, p)).astype(np.float32),
        tgt_row=np.where(deliver, codes // k, n).astype(np.int32),
        enc=np.where(deliver, codes, n * k).astype(np.int32),
        k_old=rng.standard_normal((m, p)).astype(np.float32),
        theta_base=rng.standard_normal((n, p)).astype(np.float32),
        a_w=rng.uniform(0.1, 1.0, n * k).astype(np.float32))


def run_round(fn, args):
    out = fn(*(torch.as_tensor(a.copy()) for a in args.values()))
    return [o.numpy() for o in out]


def jax_round(fn, args):
    return [np.asarray(o) for o in fn(*map(jnp.asarray, args.values()))]


def assert_round_close(got, want, atol=1e-6):
    theta, Ke, got_ever, keep = got
    np.testing.assert_array_equal(keep, want[3])
    np.testing.assert_array_equal(got_ever, want[2])
    np.testing.assert_allclose(theta, want[0], atol=atol, rtol=0)
    np.testing.assert_allclose(Ke, want[1], atol=atol, rtol=0)


ROUNDS = [
    dict(n=41, k=6, p=9, m=48, seed=0, collide=False),
    dict(n=41, k=6, p=9, m=120, seed=1),
    dict(n=11, k=3, p=4, m=40, seed=2),               # heavy collisions
    dict(n=23, k=4, p=33, m=13, seed=3),              # p > 32, odd m
    dict(n=17, k=3, p=4, m=10, seed=4, deliver_frac=0.0),
    dict(n=30, k=5, p=8, m=64, seed=5, seen_frac=0.0),  # all first receipts
]


@pytest.mark.parametrize("case", ROUNDS)
def test_round_step_plain_matches_jax(refs, case):
    args = make_round(**case)
    want, want_x = refs["rounds"][ROUNDS.index(case)]
    np.testing.assert_array_equal(want[3], want_x[3])  # the winner rule
    got = run_round(trf.round_step, args)
    assert_round_close(got, want)
    assert_round_close(got, want_x)
    assert trf.launches == 0


def test_round_step_nothing_delivered_is_identity():
    args = make_round(17, 3, 4, 10, seed=6, deliver_frac=0.0)
    got = run_round(trf.round_step, args)
    for g, name in zip(got[:3], ("theta", "Ke", "got_ever")):
        np.testing.assert_array_equal(g, args[name])
    assert not got[3].any()


def chained_rounds():
    """``test_round_step_chained_rounds``' start state and its 30 rounds'
    event arrays (with the fixed base and weights)."""
    n, k, p = 37, 5, 8
    args = make_round(n, k, p, 24, seed=9)
    rounds = []
    for r in range(30):
        ev = make_round(n, k, p, 24, seed=100 + r)
        rounds.append([ev[f] for f in ("msg", "tgt_row", "enc", "k_old")]
                      + [args["theta_base"], args["a_w"]])
    return [args[f] for f in ("theta", "Ke", "got_ever")], rounds


def test_round_step_chained_rounds(refs):
    """30 rounds chained through the in-place state stay within 1e-6 of
    the oracle, and the slot table stays exact."""
    start, rounds = chained_rounds()
    state_t = [torch.as_tensor(a.copy()) for a in start]
    for rest in rounds:
        state_t = list(trf.round_step(*state_t,
                                      *map(torch.as_tensor, rest)))[:3]
    state_j = refs["chained"]
    np.testing.assert_array_equal(state_t[1].numpy(), state_j[1])
    np.testing.assert_array_equal(state_t[2].numpy(), state_j[2])
    np.testing.assert_allclose(state_t[0].numpy(), state_j[0], atol=1e-6,
                               rtol=0)


def test_round_step_rejects_too_many_events():
    args = {k: torch.as_tensor(v) for k, v in
            make_round(5, 2, 3, 4, seed=0).items()}
    args["msg"] = torch.zeros((trf.MAX_EVENTS, 3))
    with pytest.raises(ValueError, match="2\\^24|exact only below"):
        trf._check(*args.values())


# ---------------------------------------------------------------------------
# round helpers: exactly the JAX package's
# ---------------------------------------------------------------------------


def codec_args():
    rng = np.random.default_rng(11)
    K = rng.standard_normal((6, 3, 4)).astype(np.float32)
    nbr_p = rng.uniform(size=(6, 3)).astype(np.float32)
    c = rng.uniform(size=6).astype(np.float32)
    return K, nbr_p, c


def test_slot_codecs_and_scales_exact(refs):
    K, nbr_p, c = codec_args()
    Ke_j, scales_j = refs["codecs"]
    Ke_t = trf.encode_slots(t(K))
    np.testing.assert_array_equal(Ke_t.numpy(), Ke_j)
    np.testing.assert_array_equal(trf.decode_slots(Ke_t, 3).numpy(), K)
    # XLA may rewrite the division: equal to one float32 rounding
    np.testing.assert_allclose(
        trf.round_scales(t(nbr_p), t(c), alpha=0.9).numpy(), scales_j,
        rtol=2.0 ** -23, atol=0)


def prefetch_args(no_stale):
    """The prefetch case's arrays; K (to be encoded by the JAX package's
    ``encode_slots``) in place of the slot table."""
    n, k, p, B = 13, 4, 5, 9
    rng = np.random.default_rng(12)
    theta = rng.standard_normal((n, p)).astype(np.float32)
    theta_prev = rng.standard_normal((n, p)).astype(np.float32)
    K = rng.standard_normal((n, k, p)).astype(np.float32)
    ev = [rng.integers(0, n, B).astype(np.int32) for _ in range(2)] \
        + [rng.integers(0, k, B).astype(np.int32) for _ in range(2)] \
        + [rng.uniform(size=B) < q for q in (0.6, 0.6, 0.3, 0.3)]
    if no_stale:
        ev[6][:] = ev[7][:] = False
    return theta, theta_prev, K, ev


@pytest.mark.parametrize("no_stale", [False, True])
def test_round_prefetch_exact(refs, no_stale):
    theta, theta_prev, _, ev = prefetch_args(no_stale)
    Ke, want = refs["prefetch"][no_stale]
    got = trf.round_prefetch(t(theta), t(theta_prev), t(Ke), *map(t, ev),
                             no_stale=no_stale)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # the pre-gathered stale source gives the same operands
    src = trf.round_stale_src(t(theta_prev), t(ev[0]), t(ev[1]))
    got2 = trf.round_prefetch(t(theta), None, t(Ke), *map(t, ev),
                              stale_src=src, no_stale=no_stale)
    for g, w in zip(got2, want):
        np.testing.assert_array_equal(g.numpy(), w)


# ---------------------------------------------------------------------------
# dispatch rules
# ---------------------------------------------------------------------------


def test_dispatch_auto_and_explicit():
    cpu = torch.device("cpu")
    for op in ("mix", "sparse_mix", "round_step", "neighbor_aggregate"):
        assert dispatch.resolve(op, None, cpu) \
            is dispatch._REGISTRY[op]["reference"]
    for op in ("mix", "sparse_mix", "round_step"):
        assert dispatch.implementations(op) == ("reference", "cuda")
        with pytest.raises(dispatch.BackendUnavailable):
            dispatch.resolve(op, dispatch.ReproBackend.using(**{op: "cuda"}),
                             cpu)
        # auto picks the kernel for a CUDA device (resolution only)
        assert dispatch.resolve(op, None, "cuda") \
            is dispatch._REGISTRY[op]["cuda"]
    with pytest.raises(KeyError):
        dispatch.resolve("neighbor_aggregate",
                         dispatch.ReproBackend(default="cuda"), "cuda")
    assert dispatch.implementations("attention") == ("reference", "cuda")
    assert dispatch.resolve("attention", None, cpu) \
        is dispatch._REGISTRY["attention"]["reference"]
    assert dispatch.resolve("attention", None, "cuda") \
        is dispatch._REGISTRY["attention"]["cuda"]
    be = dispatch.ReproBackend.using(default="reference", mix="cuda")
    assert be.impl_for("mix") == "cuda"
    assert be.impl_for("round_step") == "reference"


@pytest.mark.parametrize("op,plain", [
    ("mix", tgm.graph_mix_plain),
    ("sparse_mix", tsm.sparse_gather_mix_plain),
    ("round_step", trf.round_step_plain),
    ("attention", tfa.flash_attention_plain)])
def test_one_plain_version_per_op(op, plain):
    """Each kernel's plain version is the op's dispatch reference, so the
    card is held against the function that the CPU tests hold against JAX."""
    assert dispatch.resolve(op, None, "cpu") is plain
    assert plain.__module__ == tref.__name__


def test_launch_counters_reset():
    dispatch.reset_launch_counts()
    assert dispatch.launch_counts() == {"graph_mix": 0,
                                        "sparse_gather_mix": 0,
                                        "round_step": 0,
                                        "cl_edge_step": 0,
                                        "admm_edge_update": 0,
                                        "flash_attention": 0}


def test_wrappers_check_inputs():
    with pytest.raises(TypeError):
        tsm._check(torch.zeros(4, 2), torch.zeros(4, 2, dtype=torch.int64),
                   torch.zeros(4, 2), torch.zeros(4), torch.zeros(4, 2))
    with pytest.raises(ValueError):
        tgm._check(torch.zeros(4, 3), torch.zeros(4, 3),
                   torch.zeros(4, 4).t(), torch.zeros(4))
    with pytest.raises(ValueError):
        tgm._check(torch.zeros(4, 3), torch.zeros(4, 2),
                   torch.zeros(4, 4), torch.zeros(4))


# ---------------------------------------------------------------------------
# the kernel library's build and C interface, checked without nvcc
# ---------------------------------------------------------------------------


def test_c_entry_points_match_declared_argtypes():
    """Every ctypes signature names an ``extern "C"`` entry of csrc/ with as
    many parameters (a mismatch would pass garbage to the card)."""
    import re

    from repro_torch.kernels import _build
    sources = "".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    for name, argtypes in _build.SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", sources)
        assert m, name
        params = [a for a in m.group(1).split(",") if a.strip()]
        assert len(params) == len(argtypes), name


def test_build_is_lazy_and_needs_nvcc(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    assert _build._lib is None            # importing built nothing
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
    srcs, key = _build._sources()
    assert {p.name for p in srcs} == {"graph_mix.cu", "sparse_mix.cu",
                                      "round_step.cu", "cl_edge_step.cu",
                                      "admm_edge.cu", "flash_attention.cu"}
    assert len(key) == 16
    # the shared header is not compiled alone but is part of the key
    assert {p.name for p in _build.CSRC.glob("*.cuh")} == {"hopper.cuh"}
    read = pathlib.Path.read_bytes
    monkeypatch.setattr(pathlib.Path, "read_bytes", lambda self: read(self)
                        + (b"//" if self.name == "hopper.cuh" else b""))
    assert _build._sources()[1] != key


# ---------------------------------------------------------------------------
# the JAX side, in a subprocess of its own
# ---------------------------------------------------------------------------


def jax_references():
    """JAX's results for every comparison of this module, on inputs made
    from the same seeds as the tests make them."""
    out = {"graph_mix": {}, "sparse_mix": {}, "prefetch": {}}
    for n, D in GRAPH_MIX:
        args = list(map(jnp.asarray, graph_mix_args(n, D)))
        out["graph_mix"][n, D] = (
            np.asarray(jref.graph_mix(*args)),
            np.asarray(pallas_graph_mix(*args, interpret=True)))
    for case in SPARSE_MIX:
        args = list(map(jnp.asarray, sparse_mix_args(*case)))
        out["sparse_mix"][case] = (
            np.asarray(jref.sparse_gather_mix(*args)),
            np.asarray(pallas_sparse_mix(*args, block_n=16,
                                         interpret=True)))
    w, th = aggregate_args()
    out["aggregate"] = np.stack([np.asarray(jref.neighbor_aggregate(
        jnp.asarray(w[i]), jnp.asarray(th[i]))) for i in range(7)])
    ref_round = jax.jit(jref.gossip_round_step)
    xla_round = jax.jit(jrf.round_step_xla)
    out["rounds"] = [(jax_round(ref_round, args), jax_round(xla_round, args))
                     for args in map(lambda c: make_round(**c), ROUNDS)]
    start, rounds = chained_rounds()
    state = list(map(jnp.asarray, start))
    for rest in rounds:
        state = list(ref_round(*state, *map(jnp.asarray, rest)))[:3]
    out["chained"] = [np.asarray(s) for s in state]
    K, nbr_p, c = codec_args()
    out["codecs"] = (np.asarray(jrf.encode_slots(jnp.asarray(K))),
                     np.asarray(jrf.round_scales(jnp.asarray(nbr_p),
                                                 jnp.asarray(c), alpha=0.9)))
    for no_stale in (False, True):
        theta, theta_prev, K, ev = prefetch_args(no_stale)
        Ke = jrf.encode_slots(jnp.asarray(K))
        want = jrf.round_prefetch(jnp.asarray(theta), jnp.asarray(theta_prev),
                                  Ke, *map(jnp.asarray, ev),
                                  no_stale=no_stale)
        out["prefetch"][no_stale] = (np.asarray(Ke),
                                     [np.asarray(x) for x in want])
    return out


refs = _port_session.reference_fixture(__name__)
