"""The cross-cutting invariants of ``tests/test_differential.py`` on the
port's scenario cells (its own torch-drawn streams; no JAX).

One invariant checker, two drivers: a pinned grid of cells that always
runs (clean/faulty x exact/inexact primals for CL, and the MP bodies and
joint learning), and a hypothesis fuzzer (derandomized, so every run
draws the same cells) over fault rates, seeds, ADMM constants and solver
configurations.  Per cell:

* same-seed replay is bit-identical (theta history and every counter);
* message accounting: delivered + dropped == 2 * (events - invalid);
* telemetry only observes: enabling it leaves theta bit-identical;
* exact-vs-inexact ordering: the B -> inf quadratic configuration tracks
  the exact engine to float32 rounding, and B = 1 is never closer than
  B = 128.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _port_session import port_background_jobs  # noqa: E402,F401

from repro_torch.core.losses import AgentData  # noqa: E402
from repro_torch.core.primal import (ExactQuadraticPrimal,  # noqa: E402
                                     InexactPrimal)
from repro_torch.kernels import dispatch  # noqa: E402
from repro_torch.simulate import (NetworkConditions,  # noqa: E402
                                  ScenarioSpec, random_geometric_topology,
                                  run_scenario)
from repro_torch.telemetry import TelemetryConfig  # noqa: E402

N, M, Q = 16, 6, 3


def make_spec(data_seed=0, drop=0.0, stale=0.0, run_seed=0, mu=0.4,
              rho=1.0, rounds=12, batch=6, algo="cl", **kw):
    """One scenario cell (fixed shapes, everything else variable)."""
    rng = np.random.default_rng(data_seed)
    topo = random_geometric_topology(N, k=4, seed=data_seed)
    x = rng.standard_normal((N, M, Q)).astype(np.float32)
    counts = rng.integers(1, M + 1, N)
    mask = (np.arange(M)[None] < counts[:, None]).astype(np.float32)
    sol = (np.sum(x * mask[..., None], 1)
           / np.maximum(counts, 1)[:, None]).astype(np.float32)
    cfg = dict(algo=algo, topology=topo, rounds=rounds, batch=batch,
               conditions=NetworkConditions(drop_prob=drop, stale_prob=stale),
               seed=run_seed, record_every=4, theta_sol=sol, device="cpu")
    if algo == "cl":
        data = AgentData(*(torch.as_tensor(a) for a in (
            x, np.zeros((N, M), np.float32), mask)))
        cfg.update(data=data, mu=mu, rho=rho)
    else:
        cfg.update(c=rng.uniform(0.1, 1.0, N).astype(np.float32), alpha=0.9)
    cfg.update(kw)
    return ScenarioSpec(**cfg)


def check_invariants(spec: ScenarioSpec):
    """Run the cell twice and with telemetry on; assert the invariants."""
    tr = run_scenario(spec)
    assert tr.delivered + tr.dropped == 2 * (tr.events - tr.invalid)
    assert torch.isfinite(tr.theta_hist).all()
    replay = run_scenario(spec)
    assert torch.equal(replay.theta_hist, tr.theta_hist)
    assert (replay.delivered, replay.dropped, replay.invalid) == \
        (tr.delivered, tr.dropped, tr.invalid)
    teled = run_scenario(dataclasses.replace(
        spec, telemetry=TelemetryConfig(enabled=True)))
    assert torch.equal(teled.theta_hist, tr.theta_hist)
    assert teled.telemetry is not None
    assert int(teled.telemetry.delivered[-1]) == tr.delivered
    return tr


PRIMALS = {"none": None, "exact": ExactQuadraticPrimal(),
           "b4": InexactPrimal(loss="quadratic", b_steps=4, lr=0.2),
           "binf": InexactPrimal(loss="quadratic", b_steps=None)}


class TestPinnedCells:
    @pytest.mark.parametrize("primal", sorted(PRIMALS))
    @pytest.mark.parametrize("drop,stale", [(0.0, 0.0), (0.25, 0.3)])
    def test_invariants(self, primal, drop, stale):
        check_invariants(make_spec(drop=drop, stale=stale,
                                   primal=PRIMALS[primal]))

    @pytest.mark.parametrize("algo,kw", [
        ("mp", {}), ("mp", dict(backend=dispatch.ReproBackend())),
        ("joint", dict(eta_graph=0.3, graph_every=3, prune_eps=1e-3))],
        ids=["mp-per-op", "mp-fused", "joint"])
    def test_invariants_mp_and_joint(self, algo, kw):
        check_invariants(make_spec(algo=algo, drop=0.2, stale=0.3, **kw))

    def test_exact_vs_inexact_ordering(self):
        exact = run_scenario(make_spec(drop=0.2))
        err = {}
        for b in (None, 1, 128):
            tr = run_scenario(make_spec(
                drop=0.2,
                primal=InexactPrimal(loss="quadratic", b_steps=b, lr=0.2)))
            err[b] = float((tr.theta_hist - exact.theta_hist).abs().max())
        assert err[None] <= 1e-5
        assert err[128] <= err[1]


# ---------------------------------------------------------------------------
# hypothesis fuzzing (optional dev dependency)
# ---------------------------------------------------------------------------

try:
    from hypothesis import given, settings, strategies as st
except ImportError:                  # pragma: no cover - no-dev-deps envs
    st = None

if st is not None:
    primal_st = st.one_of(
        st.none(),
        st.just(ExactQuadraticPrimal()),
        st.builds(InexactPrimal, loss=st.just("quadratic"),
                  b_steps=st.integers(1, 8),
                  lr=st.sampled_from([0.05, 0.2])),
        st.just(InexactPrimal(loss="quadratic", b_steps=None)))

    class TestFuzzedCells:
        @settings(max_examples=25, deadline=None, derandomize=True)
        @given(data_seed=st.integers(0, 2**16),
               run_seed=st.integers(0, 2**16),
               drop=st.floats(0.0, 0.5), stale=st.floats(0.0, 0.5),
               mu=st.sampled_from([0.1, 0.4, 1.0]),
               rho=st.sampled_from([0.5, 1.0]), primal=primal_st)
        def test_invariants_hold_for_any_cell(self, data_seed, run_seed,
                                              drop, stale, mu, rho, primal):
            check_invariants(make_spec(
                data_seed=data_seed, run_seed=run_seed, drop=drop,
                stale=stale, mu=mu, rho=rho, primal=primal))

        @settings(max_examples=10, deadline=None, derandomize=True)
        @given(data_seed=st.integers(0, 2**16),
               run_seed=st.integers(0, 2**16), drop=st.floats(0.0, 0.4))
        def test_b_inf_anchor_for_any_schedule(self, data_seed, run_seed,
                                               drop):
            exact = run_scenario(make_spec(data_seed=data_seed,
                                           run_seed=run_seed, drop=drop))
            inex = run_scenario(make_spec(
                data_seed=data_seed, run_seed=run_seed, drop=drop,
                primal=InexactPrimal(loss="quadratic", b_steps=None)))
            assert (inex.theta_hist - exact.theta_hist).abs().max() <= 1e-5
