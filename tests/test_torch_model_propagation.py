"""The port's model propagation (paper §3) against the JAX package on the
same inputs: the Prop. 1 closed form, the Eq. 5 synchronous iteration and
label propagation within 1e-5; the iteration converges to the closed form.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import graph as jgraph  # noqa: E402
from repro.core import model_propagation as jmp  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402

import _port_session  # noqa: E402
from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from _port_session import port_background_jobs  # noqa: E402,F401
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import losses as tlosses  # noqa: E402
from repro_torch.core import model_propagation as tmp  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402

ATOL = 1e-5
CPU = "cpu"


def problem_arrays(n=40, p=3, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(n, 2))
    sol = rng.standard_normal((n, p)).astype(np.float32)
    c = rng.uniform(0.05, 1.0, n).astype(np.float32)
    return pts, sol, c


def problem(n=40, p=3, seed=0):
    """The port's graph and the problem's arrays (JAX builds its own graph
    from the same points in ``jax_references``)."""
    pts, sol, c = problem_arrays(n, p, seed)
    return tgraph.gaussian_kernel_graph(pts, sigma=0.3), sol, c


def jax_problem(n=40, p=3, seed=0):
    pts, sol, c = problem_arrays(n, p, seed)
    return jgraph.gaussian_kernel_graph(pts, sigma=0.3), sol, c


ALPHAS, STEPS = [0.5, 0.9], [1, 7, 40]


def warm_start():
    return np.random.default_rng(9).standard_normal((40, 3)) \
        .astype(np.float32)


@pytest.mark.parametrize("alpha", ALPHAS)
def test_closed_form_matches_jax(refs, alpha):
    tg, sol, c = problem()
    got = tmp.closed_form(tg, sol, c, alpha, device=CPU).numpy()
    np.testing.assert_allclose(got, refs["closed_form"][alpha], atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("steps", STEPS)
def test_synchronous_matches_jax(refs, steps):
    tg, sol, c = problem(seed=1)
    got = tmp.synchronous(tg, sol, c, 0.9, steps, device=CPU).numpy()
    np.testing.assert_allclose(got, refs["synchronous"][steps], atol=ATOL,
                               rtol=0)


def test_synchronous_warm_start_and_reference_backend(refs):
    tg, sol, c = problem(seed=2)
    from repro_torch.kernels.dispatch import ReproBackend
    got = tmp.synchronous(tg, sol, c, 0.7, 5, theta0=warm_start(),
                          device=CPU,
                          backend=ReproBackend.using(mix="reference"))
    np.testing.assert_allclose(got.numpy(), refs["warm"], atol=ATOL, rtol=0)


def test_synchronous_converges_to_closed_form():
    tg, sol, c = problem(seed=3)
    star = tmp.closed_form(tg, sol, c, 0.9, device=CPU)
    it = tmp.synchronous(tg, sol, c, 0.9, 400, device=CPU)
    assert (it - star).abs().max().item() <= ATOL


def test_closed_form_minimizes_objective():
    tg, sol, c = problem(n=25, seed=4)
    alpha = 0.8
    mu = (1.0 - alpha) / alpha           # alpha = 1 / (1 + mu)
    star = tmp.closed_form(tg, sol, c, alpha, device=CPU)
    sol_t, c_t = torch.as_tensor(sol), torch.as_tensor(c)
    q = tmp.mp_objective(star, sol_t, tg.W, c_t, mu)
    rng = np.random.default_rng(0)
    for _ in range(5):
        bump = torch.as_tensor(rng.standard_normal(star.shape) * 0.05,
                               dtype=torch.float32)
        assert tmp.mp_objective(star + bump, sol_t, tg.W, c_t, mu) > q


LABELS = np.where(np.arange(30) % 3 == 0, 1.0, 0.0)[:, None]


def test_label_propagation_matches_jax(refs):
    tg = tgraph.random_geometric_graph(30, k=4, seed=5)
    got = tmp.label_propagation(tg, LABELS, 0.9, device=CPU).numpy()
    np.testing.assert_allclose(got, refs["labels"], atol=ATOL, rtol=0)


def test_mean_estimation_end_to_end(refs):
    """The paper's §5.1 block: solitary means and confidences from the same
    padded data, then the closed form — all against the JAX package."""
    tg, td, _, _ = tsyn.mean_estimation_problem(n=50, seed=2, device=CPU)
    jsol, jc, want = refs["mean_estimation"]
    tsol = tlosses.solitary_mean(td)
    np.testing.assert_allclose(tsol.numpy(), jsol, atol=1e-6, rtol=0)
    tc = tlosses.confidences_from_counts(td.counts)
    np.testing.assert_allclose(tc.numpy(), jc, atol=1e-7, rtol=0)
    got = tmp.closed_form(tg, tsol, tc, 0.9, device=CPU).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# ---------------------------------------------------------------------------
# the JAX side, in a subprocess of its own
# ---------------------------------------------------------------------------


def jax_references():
    """JAX's closed forms, synchronous runs and label propagation on the
    same problems."""
    from repro.core import losses as jlosses
    jg, sol, c = jax_problem()
    jg1, sol1, c1 = jax_problem(seed=1)
    jg2, sol2, c2 = jax_problem(seed=2)
    me_g, me_d, _, _ = jsyn.mean_estimation_problem(n=50, seed=2)
    me_sol = np.asarray(jlosses.solitary_mean(me_d))
    me_c = np.asarray(jlosses.confidences_from_counts(me_d.counts))
    return {
        "closed_form": {a: np.asarray(jmp.closed_form(jg, sol, c, a))
                        for a in ALPHAS},
        "synchronous": {s: np.asarray(jmp.synchronous(jg1, sol1, c1, 0.9, s))
                        for s in STEPS},
        "warm": np.asarray(jmp.synchronous(jg2, sol2, c2, 0.7, 5,
                                           theta0=warm_start())),
        "labels": np.asarray(jmp.label_propagation(
            jgraph.random_geometric_graph(30, k=4, seed=5), LABELS, 0.9)),
        "mean_estimation": (me_sol, me_c, np.asarray(jmp.closed_form(
            me_g, me_sol, me_c, 0.9)))}


refs = _port_session.reference_fixture(__name__)
