"""Unified scenario API: one frozen spec, one entry point (counterpart of
``repro.simulate.spec``, single device).

``run_scenario(ScenarioSpec(algo=...))`` runs the MP gossip engine
(``"mp"``), the CL-ADMM engine with any primal solver (``"cl"``) or the
joint model and graph-learning engine (``"joint"``) on ``spec.device``
(CUDA when None).  ``stream=`` is accepted for all three: torch cannot
replay ``jax.random``, so a precomputed EventStream is how the port takes
the reference's draws.  ``telemetry=TelemetryConfig(enabled=True)``
attaches the run's metrics (``repro_torch.telemetry``) to the trace.

``serve=`` (a ``ServeStream`` of inference requests) runs the
personalization service against the run's committed record-chunk
snapshots — the read/write split of ``repro_torch.serve.store``: requests
read committed state only, so ``trace.theta_hist`` is the serve-free
run's bit for bit — and attaches its ``ServeReport`` as ``trace.serve``
(and the per-chunk ``serve_*`` counters to the telemetry frames when
telemetry is on).

``sharded=True`` runs the partitioned runner of the algo
(``simulate.partition``) over ``mesh`` — a ``launch.sim_mesh`` mesh, or
``make_sim_mesh(n_shards, device)`` when None — with the same rules as the
JAX spec: ``backend`` reaches only the sharded joint runner, and a warm CL
``state`` is single-device only.  With ``serve=`` a sharded run serves
from per-shard stores (``serve.ShardedAgentStateStore``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.sparse import record_chunks
from repro_torch.telemetry.metrics import (stream_dirty_chunks,
                                           stream_staleness_chunks)

from . import engines as _engines
from . import partition as _partition
from .scheduler import (EventStream, NetworkConditions,
                        precompute_event_stream, serve_chunk_requests)

_ALGOS = ("mp", "cl", "joint")


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
    sharding: sharded plus the partitioned runner's knobs (n_shards, mesh
              — a ``launch.sim_mesh`` LocalMesh or DistMesh —,
              assignment, local_batch, exchange, halo_codec,
              partition_seed, recompact_every/frac — joint only)
    serving:  serve (a ServeStream of inference requests interleaved
              with the gossip rounds), serve_batch (the service's batch
              width)
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


def run_scenario(spec: ScenarioSpec):
    """Run the scenario a :class:`ScenarioSpec` describes; returns the
    engine's :class:`~repro_torch.simulate.engines.SimTrace` (a
    ``CLSimTrace`` for ``cl``, a ``JointSimTrace`` for ``joint``), with
    ``trace.serve`` set when the spec carries a ``serve`` stream."""
    if spec.sharded and spec.backend is not None and spec.algo != "joint":
        raise ValueError(
            "backend overrides apply to the single-device engines and the "
            "sharded joint runner only")
    trace = _run_sharded(spec) if spec.sharded else _run_engine(spec)
    if spec.serve is not None:
        trace = _drive_serve(spec, trace)
    return trace


def _run_engine(spec: ScenarioSpec):
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


def _run_sharded(spec: ScenarioSpec):
    shard_kw = dict(n_shards=spec.n_shards, mesh=spec.mesh,
                    assignment=spec.assignment, local_batch=spec.local_batch,
                    exchange=spec.exchange, halo_codec=spec.halo_codec,
                    partition_seed=spec.partition_seed, stream=spec.stream,
                    telemetry=spec.telemetry, device=spec.device)
    common = (spec.conditions, spec.rounds, spec.batch, spec.seed,
              spec.record_every)
    if spec.algo == "cl":
        spec._require(data=spec.data, mu=spec.mu, rho=spec.rho,
                      theta_sol=spec.theta_sol)
        if spec.state is not None:
            raise ValueError(
                "warm ADMM state is single-device only (the sharded "
                "runner rebuilds its own sharded state)")
        return _partition.run_cl_scenario_sharded(
            spec.topology, spec.data, spec.mu, spec.rho, *common,
            theta_sol=spec.theta_sol, primal=spec.primal, **shard_kw)
    spec._require(theta_sol=spec.theta_sol, c=spec.c)
    if spec.algo == "joint":
        return _partition.run_joint_scenario_sharded(
            spec.topology, spec.theta_sol, spec.c, spec.alpha, *common,
            eta_graph=spec.eta_graph, lam=spec.lam,
            graph_every=spec.graph_every, prune_eps=spec.prune_eps,
            recompact_every=spec.recompact_every,
            recompact_frac=spec.recompact_frac, backend=spec.backend,
            **shard_kw)
    return _partition.run_mp_scenario_sharded(
        spec.topology, spec.theta_sol, spec.c, spec.alpha, *common,
        **shard_kw)


def _drive_serve(spec: ScenarioSpec, trace):
    """Serve the spec's request stream from the finished trace.

    Per record chunk this commits the chunk's snapshot (theta rows
    and the staleness the stream implies) to an agent-state store on the
    trace's device, voids the cache at the agents the chunk's deliveries
    rewrote, and serves every request whose round falls in the chunk from
    the committed state.  Reads never touch the run, so
    ``trace.theta_hist`` is unchanged.
    """
    from repro_torch.serve import (AgentStateStore, CollabServeEngine,
                                   ShardedAgentStateStore)

    topo = spec.topology
    n = topo.n
    record_every, n_rec = record_chunks(spec.rounds, spec.record_every)
    device = trace.theta_hist.device
    stream = spec.stream
    if stream is None:
        # the engines' own schedule: precompute_event_stream reproduces
        # the draws they make inline
        stream = precompute_event_stream(
            topo.device_tables(device),
            torch.as_tensor(topo.partition_halves()), spec.conditions,
            spec.batch, spec.seed, n_rec * record_every, device=device)
    dirty = stream_dirty_chunks(stream, n, n_rec, record_every)
    staleness = stream_staleness_chunks(stream, n, n_rec, record_every)
    requests = serve_chunk_requests(spec.serve, n_rec, record_every)

    p = int(trace.theta_hist.shape[-1])
    if spec.sharded:
        _, P_, _, part = _partition._sharded_setup(
            topo, spec.n_shards, spec.mesh, spec.assignment,
            spec.partition_seed, device)
        store = ShardedAgentStateStore(part.owner, part.local_pos, p, P_,
                                       device=device)
    else:
        store = AgentStateStore(n, p, device=device)
    eng = CollabServeEngine(store, n, p, batch_size=spec.serve_batch)
    counters = np.zeros((4, n_rec), np.int64)
    for ci in range(n_rec):
        eng.commit((ci + 1) * record_every, trace.theta_hist[ci],
                   staleness[ci], dirty[ci])
        users, _rounds = requests[ci]
        if users.size:
            eng.serve(users)
        counters[:, ci] = (eng.requests, eng.cache.hits, eng.cache.misses,
                           eng.cache.invalidations)
    trace = dataclasses.replace(trace, serve=eng.report(*counters))
    if trace.telemetry is not None:
        trace.telemetry.serve_requests = counters[0]
        trace.telemetry.serve_hits = counters[1]
        trace.telemetry.serve_misses = counters[2]
        trace.telemetry.serve_invalidations = counters[3]
    return trace
