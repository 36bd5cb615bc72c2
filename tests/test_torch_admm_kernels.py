"""The port's CL-ADMM ops and kernel modules on the CPU, where each wrapper
runs its plain PyTorch version, held against the JAX package:

* ``admm_primal`` (batched over rows) against JAX's ``xla`` and
  ``reference`` row forms, vmapped: atol 1e-5 (the parity bar of
  ``repro.kernels.dispatch``);
* ``admm_edge_update`` against ``repro.kernels.ref.admm_edge_update``
  (atol 1e-6; both divide by rho) and the Pallas kernel in interpret mode
  (atol 2e-6; it multiplies by 1/rho);
* ``cl_edge_step`` against the XLA form ``repro.kernels.round_fuse.
  cl_edge_step`` on real event sides with repeated targets and stale
  sides (atol 1e-6): the port's prefetched stale rows give what the full
  ``pv_*`` snapshot gives, and repeated targets carry identical values;
* the CUDA kernel's edge election (one event per edge lands the union of
  the edge's delivered bits), emulated event by event in random orders on
  hand-built rounds (``tests/_cl_rounds.py``), bit for bit against the
  plain version, with the election words zero afterwards;
* the helpers (``admm_edge_halfstep``, ``sample_event``,
  ``personalized_predict``, ``cl_stale_prefetch``) and the dispatch rules.

The CUDA kernels themselves run only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import sparse as jsparse  # noqa: E402
from repro.kernels import dispatch as jdisp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import round_fuse as jrf  # noqa: E402
from repro.kernels.admm_update import \
    admm_edge_update as pallas_admm_edge  # noqa: E402
from repro.simulate import scheduler as jsched  # noqa: E402
from repro.simulate import topology as jtopo  # noqa: E402

from _cl_rounds import CASES, election_round  # noqa: E402
from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from _port_session import port_background_jobs  # noqa: E402,F401
from repro_torch.core import sparse as tsparse  # noqa: E402
from repro_torch.kernels import admm_update as tau  # noqa: E402
from repro_torch.kernels import dispatch, ref as tref  # noqa: E402
from repro_torch.kernels import round_fuse as trf  # noqa: E402


def t(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


# ---------------------------------------------------------------------------
# admm_primal
# ---------------------------------------------------------------------------


def primal_rows(R, k, p, seed):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, k + 1, R)
    live = np.arange(k)[None, :] < deg[:, None]
    w = np.where(live, rng.uniform(0.1, 2.0, (R, k)), 0.0).astype(np.float32)
    zl = [rng.standard_normal((R, k, p)).astype(np.float32)
          for _ in range(4)]
    D = rng.uniform(0.5, 3.0, R).astype(np.float32)
    m = rng.integers(0, 6, R).astype(np.float32)
    sx = rng.standard_normal((R, p)).astype(np.float32)
    return (w, live, *zl, D, m, sx)


@pytest.mark.parametrize("R,k,p", [(1, 4, 3), (37, 6, 8), (20, 1, 5)])
def test_admm_primal_matches_jax(R, k, p):
    rows = primal_rows(R, k, p, seed=R + k + p)
    mu, rho = 0.3, 1.3
    got = dispatch.resolve("admm_primal", None, "cpu")(*map(t, rows), mu,
                                                       rho)
    for impl in ("xla", "reference"):
        fn = jdisp.resolve("admm_primal", jdisp.ReproBackend(default=impl))
        want = jax.vmap(lambda *r: fn(*r, mu, rho))(*map(jnp.asarray, rows))
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-5,
                                       rtol=0)
    # one row without a batch axis is row 0 of the batch
    one = tsparse.quadratic_primal_core(*(t(a[0]) for a in rows), mu, rho)
    for g, o in zip(got, one):
        np.testing.assert_allclose(o.numpy(), g[0].numpy(), atol=1e-6,
                                   rtol=0)


# ---------------------------------------------------------------------------
# admm_edge_update
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("E,p,rho", [(37, 40, 0.7), (8, 512, 1.0),
                                     (5, 3, 2.5)])
def test_admm_edge_matches_jax(E, p, rho):
    rng = np.random.default_rng(E + p)
    args = [rng.standard_normal((E, p)).astype(np.float32) for _ in range(8)]
    got = tau.admm_edge_update(*map(t, args), rho=rho)
    want = jref.admm_edge_update(*map(jnp.asarray, args), rho)
    pallas = pallas_admm_edge(*map(jnp.asarray, args), rho=rho,
                              interpret=True)
    assert len(got) == 6 and tau.launches == 0      # CPU never launches
    for g, w_, pk in zip(got, want, pallas):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-6,
                                   rtol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(pk), atol=2e-6,
                                   rtol=0)


def test_admm_edge_halfstep_matches_jax():
    rng = np.random.default_rng(3)
    args = [rng.standard_normal((11, 7)).astype(np.float32)
            for _ in range(8)]
    got = tsparse.admm_edge_halfstep(*map(t, args), 0.8)
    want = jsparse.admm_edge_halfstep(*map(jnp.asarray, args), 0.8)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-6,
                                   rtol=0)


# ---------------------------------------------------------------------------
# cl_edge_step
# ---------------------------------------------------------------------------


def cl_case(n, B, p, seed):
    """Round 0 of a JAX event stream with drops and staleness (B >= n makes
    repeated targets certain), random round-start state and a random
    previous-round snapshot ``pv``, as numpy arrays."""
    topo = jtopo.random_geometric_topology(n, k=4, seed=seed)
    cond = jsched.NetworkConditions(drop_prob=0.3, stale_prob=0.3)
    ev = jsched.precompute_event_stream(
        topo.device_tables(), jnp.asarray(topo.partition_halves()), cond, B,
        seed, 1)
    ev = [np.asarray(f)[0] for f in (ev.i, ev.s, ev.j, ev.r, ev.stale_ij,
                                     ev.stale_ji, ev.deliver_ij,
                                     ev.deliver_ji)]
    i, s, j, r, st_ij, st_ji, d_ij, d_ji = ev
    sides = (np.concatenate([i, j]).astype(np.int32),
             np.concatenate([s, r]).astype(np.int32),
             np.concatenate([j, i]).astype(np.int32),
             np.concatenate([r, s]).astype(np.int32),
             np.concatenate([st_ji, st_ij]), np.concatenate([d_ji, d_ij]))
    k = topo.k_max
    rng = np.random.default_rng(seed)
    state = [rng.standard_normal((n, p)).astype(np.float32)] + [
        rng.standard_normal((n, k, p)).astype(np.float32) for _ in range(5)]
    pv = [rng.standard_normal((n, p)).astype(np.float32)] + [
        rng.standard_normal((n, k, p)).astype(np.float32) for _ in range(3)]
    return state, pv, sides


@pytest.mark.parametrize("n,B,p,seed,rho", [(40, 80, 8, 1, 1.0),
                                            (60, 90, 5, 2, 0.7)])
def test_cl_edge_step_matches_jax(n, B, p, seed, rho):
    state, pv, sides = cl_case(n, B, p, seed)
    upd, own_s, oth_a, oth_s, stale, got = sides
    k = state[1].shape[1]
    tgt = (upd.astype(np.int64) * k + own_s)[got]
    assert len(np.unique(tgt)) < len(tgt)            # repeated targets
    assert (stale & got).any() and (~got).any()      # stale and dropped
    want = jrf.cl_edge_step(*map(jnp.asarray, state + pv + list(sides)),
                            rho=rho)
    pay = trf.cl_stale_prefetch(*map(t, pv), t(oth_a), t(oth_s))
    out = trf.cl_edge_step(*map(t, state), *pay, *map(t, sides), rho=rho)
    assert trf.cl_edge_launches == 0
    for o, w_ in zip(out, want):
        np.testing.assert_allclose(o.numpy(), np.asarray(w_), atol=1e-6,
                                   rtol=0)
    # the engine's stale payload: exactly the snapshot's cells
    pv_t = list(map(t, pv))
    a, sl = t(oth_a).long(), t(oth_s).long()
    for p_, full in zip(pay, (pv_t[0][a],) + tuple(x[a, sl]
                                                   for x in pv_t[1:])):
        assert torch.equal(p_, full)


def test_cl_edge_step_repeated_targets_are_identical():
    """Every side aiming at one (agent, slot) computes bit-identical values
    (same round-start cells, same sender's staleness), so the order of the
    writes cannot matter: the result is the same with the sides reversed."""
    state, pv, sides = cl_case(50, 120, 6, 3)
    upd, own_s, oth_a, oth_s, stale, got = map(t, sides)
    th, K, _, _, Lo, Ln = map(t, state)
    pay = trf.cl_stale_prefetch(*map(t, pv), oth_a, oth_s)
    u, o, a, s = upd.long(), own_s.long(), oth_a.long(), oth_s.long()
    fresh = (th[a], K[a, s], Lo[a, s], Ln[a, s])
    pay = [torch.where(stale[:, None], x, f) for x, f in zip(pay, fresh)]
    vals = torch.cat(tref.admm_edge_halfstep(th[u], K[u, o], Lo[u, o],
                                             Ln[u, o], *pay, 1.0), dim=1)
    tgt = u * K.shape[1] + o
    order = torch.argsort(tgt, stable=True)
    ts, vs = tgt[order], vals[order]
    same = ts[1:] == ts[:-1]
    assert same.any()
    assert torch.equal(vs[1:][same], vs[:-1][same])
    rev = torch.arange(len(upd) - 1, -1, -1)
    fwd_pay = trf.cl_stale_prefetch(*map(t, pv), oth_a, oth_s)
    fwd = trf.cl_edge_step(*map(t, state), *fwd_pay, *map(t, sides),
                           rho=1.0)
    bwd = trf.cl_edge_step(*map(t, state), *(x[rev] for x in fwd_pay),
                           *(x[rev] for x in map(t, sides)), rho=1.0)
    assert all(torch.equal(x, y) for x, y in zip(fwd, bwd))


def test_cl_edge_step_nothing_delivered_is_identity():
    state, pv, sides = cl_case(30, 30, 4, 4)
    sides = sides[:5] + (np.zeros_like(sides[5]),)
    pay = trf.cl_stale_prefetch(*map(t, pv), t(sides[2]), t(sides[3]))
    out = trf.cl_edge_step(*map(t, state), *pay, *map(t, sides), rho=1.0)
    for o, s0 in zip(out, state[2:]):
        assert torch.equal(o, t(s0))


def emulate_election(state, sides, rho, k, events):
    """``csrc/cl_edge_step.cu``'s algorithm on the CPU, one event at a time:
    the claim ORs each event's delivered bits into its edge's canonical
    word, then the events in the order ``events`` swap the word for 0, and
    the one that gets it back nonzero computes both ends from the arrays
    as they stand and writes the ends whose bit is set.  Returns the four
    updated arrays and the election words."""
    th, K, Zo, Zn, Lo, Ln, pth, pK, pLo, pLn = [x.clone() for x in state]
    upd, own_s, oth_a, oth_s, stale, got = (x.tolist() for x in sides)
    n, _, p = K.shape
    B = len(upd) // 2
    Kf, Zof, Znf, Lof, Lnf = (a.view(n * k, p) for a in (K, Zo, Zn, Lo, Ln))
    flags = np.zeros(n * k, np.int64)

    def ends(b):
        ca, cb = upd[b] * k + own_s[b], oth_a[b] * k + oth_s[b]
        return ca, cb, min(ca, cb)

    for b in range(B):
        ga, gb = int(got[b]), int(got[b + B])
        if ga or gb:
            ca, cb, c = ends(b)
            flags[c] |= (ga | gb << 1) if ca <= cb else (gb | ga << 1)
    for b in events:
        if not (got[b] or got[b + B]):
            continue
        ca, cb, c = ends(b)
        bits, flags[c] = int(flags[c]), 0
        if not bits:
            continue
        own_a = (th[upd[b]], Kf[ca], Lof[ca], Lnf[ca])
        own_b = (th[oth_a[b]], Kf[cb], Lof[cb], Lnf[cb])
        pay_a = (pth[b], pK[b], pLo[b], pLn[b]) if stale[b] else own_b
        pay_b = ((pth[b + B], pK[b + B], pLo[b + B], pLn[b + B])
                 if stale[b + B] else own_a)
        ra = tref.admm_edge_halfstep(*own_a, *pay_a, rho)
        rb = tref.admm_edge_halfstep(*own_b, *pay_b, rho)
        for cell, res, bit in ((ca, ra, 1 if ca <= cb else 2),
                               (cb, rb, 2 if ca <= cb else 1)):
            if bits & bit:
                for arr, v in zip((Zof, Znf, Lof, Lnf), res):
                    arr[cell] = v          # scatter: unique targets (one cell)
    return (Zo, Zn, Lo, Ln), flags


@pytest.mark.parametrize("case", CASES)
def test_cl_edge_election_lands_what_the_plain_version_lands(case):
    """Each election case, with the events taken in three random orders:
    the same four arrays as the plain version, bit for bit, and every
    election word back at zero."""
    state, sides, rho, k = election_round(case, "cpu")
    B = sides[0].shape[0] // 2
    want = trf.cl_edge_step_plain(*[x.clone() for x in state], *sides,
                                  rho=rho)
    for seed in range(3):
        events = np.random.default_rng(seed).permutation(B).tolist()
        got, flags = emulate_election(state, sides, rho, k, events)
        assert not flags.any()
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_cl_edge_election_rounds_hit_their_cases():
    """The hand-built rounds contain what their names say: a repeated
    target, and for ``stale_dup`` stale and fresh sides on one edge."""
    for case in CASES:
        _, sides, _, k = election_round(case, "cpu")
        upd, own_s, _, _, stale, got = sides
        tgt = upd.long() * k + own_s.long()
        assert tgt.unique().numel() < tgt.numel(), case
        if case == "stale_dup":
            dup = tgt == tgt[(tgt[:, None] == tgt[None, :]).sum(1) > 1][0]
            assert (stale & got & dup).any()
        if case == "split_bits":
            assert got.sum() < got.numel()


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def test_sample_event_matches_jax_draws():
    topo = jtopo.random_geometric_topology(40, k=3, seed=0)
    tabs = topo.device_tables()
    host = topo.tables
    gen = torch.Generator().manual_seed(0)
    for key in jax.random.split(jax.random.PRNGKey(1), 20):
        i, s = jsparse.sample_event(key, 40, tabs.slot_cdf, tabs.deg_count)
        assert tsparse.sample_event(40, host.slot_cdf, host.deg_count,
                                    draw=(i, s)) == (int(i), int(s))
        ti, ts = tsparse.sample_event(40, host.slot_cdf, host.deg_count,
                                      generator=gen)
        assert 0 <= ti < 40 and 0 <= ts < host.deg_count[ti]
    # an out-of-range slot is clamped to the live range, a degree-0 row to 0
    assert tsparse.sample_event(2, np.zeros((2, 3), np.float32),
                                np.array([2, 0]), draw=(0, 7)) == (0, 1)
    assert tsparse.sample_event(2, np.zeros((2, 3), np.float32),
                                np.array([2, 0]), draw=(1, 2)) == (1, 0)


def test_personalized_predict_matches_jax():
    rng = np.random.default_rng(5)
    th, x = (rng.standard_normal((9, 6)).astype(np.float32)
             for _ in range(2))
    np.testing.assert_allclose(
        tsparse.personalized_predict(t(th), t(x)).numpy(),
        np.asarray(jsparse.personalized_predict(th, x)), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# dispatch rules and wrapper checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op,plain", [
    ("admm_edge", tau.admm_edge_update_plain),
    ("cl_edge_step", trf.cl_edge_step_plain)])
def test_cl_ops_dispatch(op, plain):
    cpu = torch.device("cpu")
    assert dispatch.implementations(op) == ("reference", "cuda")
    assert dispatch.resolve(op, None, cpu) is plain
    assert plain.__module__ == tref.__name__
    assert dispatch.resolve(op, None, "cuda") \
        is dispatch._REGISTRY[op]["cuda"]
    with pytest.raises(dispatch.BackendUnavailable):
        dispatch.resolve(op, dispatch.ReproBackend.using(**{op: "cuda"}),
                         cpu)


def test_admm_primal_has_no_kernel():
    assert dispatch.implementations("admm_primal") == ("reference",)
    assert dispatch.resolve("admm_primal", None, "cuda") is \
        tref.quadratic_primal
    with pytest.raises(KeyError):
        dispatch.resolve("admm_primal",
                         dispatch.ReproBackend(default="cuda"), "cuda")


def test_cl_wrappers_check_inputs():
    state, pv, sides = cl_case(20, 10, 3, 5)
    pay = trf.cl_stale_prefetch(*map(t, pv), t(sides[2]), t(sides[3]))
    good = list(map(t, state)) + list(pay) + list(map(t, sides))
    trf._check_cl(*good)
    bad = list(good)
    bad[10] = bad[10].long()                         # upd not int32
    with pytest.raises(TypeError):
        trf._check_cl(*bad)
    bad = list(good)
    bad[6] = bad[6][:-1]                             # pay_th short a row
    with pytest.raises(ValueError):
        trf._check_cl(*bad)
    odd = good[:6] + [x[:-1] for x in good[6:]]      # not event pairs
    with pytest.raises(ValueError, match="event pairs"):
        trf._check_cl(*odd)
    e = [torch.zeros(4, 3) for _ in range(8)]
    tau._check(e)
    with pytest.raises(ValueError):
        tau._check(e[:7] + [torch.zeros(4, 2)])
    with pytest.raises(TypeError):
        tau._check(e[:7] + [torch.zeros(4, 3, dtype=torch.float64)])
