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

from _jax_caches import fresh_jax_caches  # noqa: E402,F401
from _port_session import port_background_jobs  # noqa: E402,F401
from repro_torch.core import graph as tgraph  # noqa: E402
from repro_torch.core import losses as tlosses  # noqa: E402
from repro_torch.core import model_propagation as tmp  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402

ATOL = 1e-5
CPU = "cpu"


def problem(n=40, p=3, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(size=(n, 2))
    sol = rng.standard_normal((n, p)).astype(np.float32)
    c = rng.uniform(0.05, 1.0, n).astype(np.float32)
    return (jgraph.gaussian_kernel_graph(pts, sigma=0.3),
            tgraph.gaussian_kernel_graph(pts, sigma=0.3), sol, c)


@pytest.mark.parametrize("alpha", [0.5, 0.9])
def test_closed_form_matches_jax(alpha):
    jg, tg, sol, c = problem()
    want = np.asarray(jmp.closed_form(jg, sol, c, alpha))
    got = tmp.closed_form(tg, sol, c, alpha, device=CPU).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("steps", [1, 7, 40])
def test_synchronous_matches_jax(steps):
    jg, tg, sol, c = problem(seed=1)
    want = np.asarray(jmp.synchronous(jg, sol, c, 0.9, steps))
    got = tmp.synchronous(tg, sol, c, 0.9, steps, device=CPU).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_synchronous_warm_start_and_reference_backend():
    jg, tg, sol, c = problem(seed=2)
    theta0 = np.random.default_rng(9).standard_normal(sol.shape) \
        .astype(np.float32)
    want = np.asarray(jmp.synchronous(jg, sol, c, 0.7, 5, theta0=theta0))
    from repro_torch.kernels.dispatch import ReproBackend
    got = tmp.synchronous(tg, sol, c, 0.7, 5, theta0=theta0, device=CPU,
                          backend=ReproBackend.using(mix="reference"))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_synchronous_converges_to_closed_form():
    _, tg, sol, c = problem(seed=3)
    star = tmp.closed_form(tg, sol, c, 0.9, device=CPU)
    it = tmp.synchronous(tg, sol, c, 0.9, 400, device=CPU)
    assert (it - star).abs().max().item() <= ATOL


def test_closed_form_minimizes_objective():
    _, tg, sol, c = problem(n=25, seed=4)
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


def test_label_propagation_matches_jax():
    jg = jgraph.random_geometric_graph(30, k=4, seed=5)
    tg = tgraph.random_geometric_graph(30, k=4, seed=5)
    labels = np.where(np.arange(30) % 3 == 0, 1.0, 0.0)[:, None]
    want = np.asarray(jmp.label_propagation(jg, labels, 0.9))
    got = tmp.label_propagation(tg, labels, 0.9, device=CPU).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_mean_estimation_end_to_end():
    """The paper's §5.1 block: solitary means and confidences from the same
    padded data, then the closed form — all against the JAX package."""
    from repro.core import losses as jlosses
    jg, jd, _, _ = jsyn.mean_estimation_problem(n=50, seed=2)
    tg, td, _, _ = tsyn.mean_estimation_problem(n=50, seed=2, device=CPU)
    jsol = np.asarray(jlosses.solitary_mean(jd))
    tsol = tlosses.solitary_mean(td)
    np.testing.assert_allclose(tsol.numpy(), jsol, atol=1e-6, rtol=0)
    jc = np.asarray(jlosses.confidences_from_counts(jd.counts))
    tc = tlosses.confidences_from_counts(td.counts)
    np.testing.assert_allclose(tc.numpy(), jc, atol=1e-7, rtol=0)
    want = np.asarray(jmp.closed_form(jg, jsol, jc, 0.9))
    got = tmp.closed_form(tg, tsol, tc, 0.9, device=CPU).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
