"""Unified scenario API: one frozen spec, one entry point (counterpart of
``repro.simulate.spec``, single device).

``run_scenario(ScenarioSpec(algo=...))`` runs the MP gossip engine
(``"mp"``), the CL-ADMM engine with any primal solver (``"cl"``) or the
joint model and graph-learning engine (``"joint"``) on ``spec.device``
(CUDA when None).  ``stream=`` is accepted for all three: torch cannot
replay ``jax.random``, so a precomputed EventStream is how the port takes
the reference's draws.  ``telemetry=TelemetryConfig(enabled=True)``
attaches the run's metrics (``repro_torch.telemetry``) to the trace.

The spec carries every field of the JAX package's.  Sharding and serving
are not ported yet: ``sharded=True`` and ``serve=`` raise
``NotImplementedError`` naming the ROADMAP item that ports each; their
knobs (``n_shards`` ... ``recompact_frac``, ``serve_batch``) are read only
by those runners.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from . import engines as _engines
from .scheduler import EventStream, NetworkConditions

_ALGOS = ("mp", "cl", "joint")

#: What is not ported yet, and the ROADMAP queue-1 item that ports it.
_LATER = {
    "serve": "ROADMAP queue 1 item 9 (serving)",
    "sharded": "ROADMAP queue 1 item 10 (multi-GPU)",
}


@dataclasses.dataclass(frozen=True, eq=False)
class ScenarioSpec:
    """Everything that defines one scenario run.

    core:     algo ("mp" | "cl" | "joint"), topology (SparseTopology),
              conditions, rounds, batch, seed, record_every
    mp/joint: theta_sol (solitary models), c (confidences), alpha (Eq. 3
              mix)
    cl:       data (AgentData), mu, rho, theta_sol (warm start) or state
              (a SparseADMMState, updated in place), primal (a solver of
              ``core.primal``; None = the exact closed-form quadratic
              solve)
    joint:    eta_graph, lam, graph_every, prune_eps (DESIGN.md §13)
    events:   stream — a precomputed EventStream to replay (otherwise
              drawn from ``seed`` by the torch scheduler)
    exec:     backend (mp: fused round_step when given; all: per-op impl
              choice), telemetry (TelemetryConfig), device (CUDA when None)
    sharding: sharded plus the partitioned runner's knobs (n_shards, mesh,
              assignment, local_batch, exchange, halo_codec,
              partition_seed, recompact_every/frac — joint only); not
              ported yet
    serving:  serve (a stream of inference requests), serve_batch (decode
              batch width); not ported yet
    """

    algo: str
    topology: Any
    conditions: NetworkConditions
    rounds: int
    batch: int
    seed: int = 0
    record_every: int = 10
    theta_sol: Any = None
    c: Any = None
    alpha: float = 0.5
    data: Any = None
    mu: Optional[float] = None
    rho: Optional[float] = None
    state: Any = None
    primal: Any = None
    eta_graph: float = 0.0
    lam: float = 1.0
    graph_every: int = 1
    prune_eps: Optional[float] = None
    stream: Optional[EventStream] = None
    backend: Any = None
    device: Any = None
    telemetry: Any = None
    # sharding
    sharded: bool = False
    n_shards: Optional[int] = None
    mesh: Any = None
    assignment: Any = None
    local_batch: Optional[int] = None
    exchange: str = "all_gather"
    halo_codec: Any = "f32"
    partition_seed: int = 0
    recompact_every: Optional[int] = None
    recompact_frac: float = 0.25
    # serving
    serve: Any = None
    serve_batch: int = 256

    def __post_init__(self):
        if self.algo not in _ALGOS:
            raise ValueError(f"unknown algo {self.algo!r}; one of {_ALGOS}")
        if self.primal is not None and self.algo != "cl":
            raise ValueError("primal solvers plug into the CL-ADMM engine "
                             "only (algo='cl')")

    def _require(self, **fields):
        for name, val in fields.items():
            if val is None:
                raise ValueError(
                    f"algo={self.algo!r} requires ScenarioSpec.{name}")


def _not_ported(what: str):
    raise NotImplementedError(
        f"{what} is not ported to repro_torch yet: {_LATER[what]}")


def run_scenario(spec: ScenarioSpec):
    """Run the scenario a :class:`ScenarioSpec` describes; returns the
    engine's :class:`~repro_torch.simulate.engines.SimTrace` (a
    ``CLSimTrace`` for ``cl``, a ``JointSimTrace`` for ``joint``)."""
    if spec.sharded:
        _not_ported("sharded")
    if spec.serve is not None:
        _not_ported("serve")
    if spec.algo == "cl":
        spec._require(data=spec.data, mu=spec.mu, rho=spec.rho)
        if spec.state is None:
            spec._require(theta_sol=spec.theta_sol)
        return _engines.run_cl_scenario(
            spec.topology, spec.data, spec.mu, spec.rho, spec.conditions,
            spec.rounds, spec.batch, seed=spec.seed,
            record_every=spec.record_every, theta_sol=spec.theta_sol,
            state=spec.state, stream=spec.stream, backend=spec.backend,
            primal=spec.primal, telemetry=spec.telemetry, device=spec.device)
    spec._require(theta_sol=spec.theta_sol, c=spec.c)
    if spec.algo == "joint":
        return _engines.run_joint_scenario(
            spec.topology, spec.theta_sol, spec.c, spec.alpha,
            spec.conditions, spec.rounds, spec.batch, seed=spec.seed,
            record_every=spec.record_every, eta_graph=spec.eta_graph,
            lam=spec.lam, graph_every=spec.graph_every,
            prune_eps=spec.prune_eps, stream=spec.stream,
            backend=spec.backend, telemetry=spec.telemetry,
            device=spec.device)
    return _engines.run_mp_scenario(
        spec.topology, spec.theta_sol, spec.c, spec.alpha, spec.conditions,
        spec.rounds, spec.batch, seed=spec.seed,
        record_every=spec.record_every, backend=spec.backend,
        stream=spec.stream, telemetry=spec.telemetry, device=spec.device)
