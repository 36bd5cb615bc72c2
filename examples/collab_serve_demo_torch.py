"""Gossip-backed personalization service demo on the PyTorch port (the
counterpart of examples/collab_serve_demo.py, built from repro_torch
only; DESIGN.md §16).

Runs asynchronous MP gossip under faults with an inference-request
stream interleaved: per record chunk the run commits a snapshot to the
agent-state store, the mixed-model cache is invalidated at exactly the
agents that round's deliveries rewrote, and every request arriving in
the chunk is served by batched decode from the committed personalized
rows.  Prints the service report (requests, cache hit rate, served
staleness percentiles) and proves the acceptance property: the gossip
trajectory is bit-for-bit identical to the serve-free run.

The scenario passes no backend, as the JAX demo's does, so it runs the
per-op MP round (torch ops, no hand-written kernel), and the service
predicts with torch ops.  The port's scheduler draws its own events from
``--seed`` (torch cannot replay ``jax.random``), so the hit rate and the
staleness are the port's own; :func:`spec` takes an injected ``stream``.

Run on the CUDA card (default), or on the CPU:
  PYTHONPATH=src python examples/collab_serve_demo_torch.py
  PYTHONPATH=src python examples/collab_serve_demo_torch.py --smoke \
      --device cpu
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.simulate import (NetworkConditions, ScenarioSpec,
                                  cluster_topology, precompute_serve_stream,
                                  run_scenario)
from repro_torch.telemetry import TelemetryConfig, format_row, trace_rows


def spec(n, p, rounds, rate, seed, device, stream=None):
    """The demo's scenario: MP gossip under drops and churn on the
    clustered topology with serving and telemetry on, its models and
    confidences from ``seed``; ``stream`` an event stream to replay (the
    port's scheduler draws one from ``seed`` when None)."""
    topo = cluster_topology(n, n_clusters=8, k_intra=5, bridges=6,
                            seed=seed)
    rng = np.random.default_rng(seed)
    theta_sol = rng.standard_normal((n, p)).astype(np.float32)
    c = rng.uniform(0.05, 1.0, n).astype(np.float32)
    return ScenarioSpec(
        algo="mp", topology=topo, theta_sol=theta_sol, c=c, alpha=0.9,
        conditions=NetworkConditions(drop_prob=0.15, churn_rate=0.005),
        rounds=rounds, batch=max(1, n // 10), seed=seed,
        record_every=max(1, rounds // 8),
        telemetry=TelemetryConfig(enabled=True),
        serve=precompute_serve_stream(n, rounds, rate=rate, seed=seed),
        serve_batch=256, stream=stream, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--p", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--rate", type=float, default=50.0,
                    help="inference requests per gossip round")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny problem (tests)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n = 300 if args.smoke else args.n
    rounds = 80 if args.smoke else args.rounds
    rate = 10.0 if args.smoke else args.rate

    sp = spec(n, args.p, rounds, rate, args.seed, device)
    tr = run_scenario(sp)
    rep = tr.serve
    print(f"served {rep.requests} requests over {tr.rounds} rounds "
          f"({n} agents)")
    print(f"  cache: hit_rate={rep.hit_rate:.2%} hits={rep.hits} "
          f"misses={rep.misses} invalidations={rep.invalidations}")
    print(f"  served staleness: "
          f"p50={rep.staleness_percentile(50):.0f} "
          f"p99={rep.staleness_percentile(99):.0f} rounds")
    print(f"  last telemetry row: {format_row(trace_rows(tr)[-1])}")

    # acceptance: serving reads committed snapshots only — the gossip
    # trajectory must be bit-for-bit the serve-free one
    bare = run_scenario(dataclasses.replace(sp, serve=None, telemetry=None))
    identical = bool(torch.equal(tr.theta_hist, bare.theta_hist))
    assert identical
    print("OK: gossip trajectory identical with and without serving")
    return {"n": n, "rounds": tr.rounds, "requests": rep.requests,
            "hits": rep.hits, "misses": rep.misses,
            "invalidations": rep.invalidations, "hit_rate": rep.hit_rate,
            "staleness_p50": rep.staleness_percentile(50),
            "staleness_p99": rep.staleness_percentile(99),
            "identical": identical}


if __name__ == "__main__":
    main()
