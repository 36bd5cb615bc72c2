"""Fault-scenario tour of the sparse network simulator on the PyTorch port
(the counterpart of examples/network_sim_demo.py, built from repro_torch
only).

Runs asynchronous model-propagation gossip (paper §3.2) over a clustered
topology under every registered fault scenario and reports how far each
run gets toward the synchronous fixed point — the paper's convergence
story (Theorem 1) stress-tested under message loss, stragglers, churn and
partitions.  Every run records telemetry: the per-scenario line is the
telemetry report row (objective, staleness p50/p99, drop attribution),
and ``--out DIR`` records each scenario as a run directory
(manifest.json + metrics.jsonl) that ``tools/trace_report_torch.py`` and
``tools/trace_report.py`` render.

On the card the fixed point theta* is ``sparse_gather_mix`` sweeps.  The
scenarios pass no backend, as the JAX example's do, so they run the
per-op MP round (the fused ``round_step`` runs only under a backend that
asks for it).  The port's scheduler draws its own events from ``--seed``
(torch cannot replay ``jax.random``), so each ``rel_err`` is the port's
own.

    PYTHONPATH=src python examples/network_sim_demo_torch.py [--n 2000]
    PYTHONPATH=src python examples/network_sim_demo_torch.py --smoke \
        --device cpu --out /tmp/runs
"""

import argparse
import os

import numpy as np

from repro_torch import resolve_device
from repro_torch.simulate import (ScenarioSpec, cluster_topology,
                                  get_scenario, list_scenarios, run_scenario,
                                  sparse_sync_mp)
from repro_torch.telemetry import (TelemetryConfig, build_manifest,
                                   format_row, trace_rows, write_run)


SWEEPS = 400        # sparse_sync_mp's sweeps to theta*


def problem(n, p, seed):
    """The clustered topology, the solitary models and the confidences,
    from ``seed``: ``(topo, theta_sol, c)``."""
    topo = cluster_topology(n, n_clusters=8, k_intra=5, bridges=6, seed=seed)
    rng = np.random.default_rng(seed)
    # cluster-correlated targets: agents in a cluster share a model direction
    centers = rng.standard_normal((int(topo.groups.max()) + 1, p))
    theta_sol = (centers[topo.groups]
                 + 0.5 * rng.standard_normal((n, p))).astype(np.float32)
    c = rng.uniform(0.05, 1.0, n).astype(np.float32)
    return topo, theta_sol, c


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2000)
    ap.add_argument("--p", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=400)
    ap.add_argument("--alpha", type=float, default=0.9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny problem (tests)")
    ap.add_argument("--out", default=None,
                    help="write one telemetry run directory per scenario "
                         "under this path (see tools/trace_report_torch.py)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n = 300 if args.smoke else args.n
    rounds = 120 if args.smoke else args.rounds

    topo, theta_sol, c = problem(n, args.p, args.seed)

    # models + neighbor slots + tables, against the dense (n, n, p) state
    sparse_mb = (4 * (n * args.p + n * topo.k_max * args.p)
                 + 16 * n * topo.k_max) / 2**20
    dense_mb = 4 * n * n * args.p / 2**20
    print(f"topology: n={topo.n} k_max={topo.k_max} edges={topo.n_edges} "
          f"sparse_state={sparse_mb:.1f} MB (dense would be "
          f"{dense_mb:.0f} MB)")

    star = sparse_sync_mp(topo, theta_sol, c, args.alpha, sweeps=SWEEPS,
                          device=device).cpu().numpy()
    err0 = float(np.linalg.norm(theta_sol - star))

    out = {"n": n, "p": args.p, "seed": args.seed, "alpha": args.alpha,
           "rounds": rounds, "theta_star": star, "rel_err": {}, "runs": {}}
    batch = max(1, n // 10)
    for name in list_scenarios():
        sc = get_scenario(name)
        tr = run_scenario(ScenarioSpec(
            algo="mp", topology=topo, theta_sol=theta_sol, c=c,
            alpha=args.alpha, conditions=sc.make_conditions(rounds),
            rounds=rounds, batch=batch, seed=args.seed,
            record_every=max(1, rounds // 8),
            telemetry=TelemetryConfig(enabled=True), device=device))
        err = float(np.linalg.norm(tr.theta_hist[-1].cpu().numpy() - star)) \
            / err0
        out["rel_err"][name] = err
        rows = trace_rows(tr)
        print(f"{name:16s} rel_err={err:.3f}  {format_row(rows[-1])}")
        if args.out:
            d = write_run(os.path.join(args.out, name),
                          build_manifest(seed=args.seed, extra={
                              "scenario": name, "n": n, "rounds": rounds,
                              "alpha": args.alpha}),
                          rows)
            out["runs"][name] = d
            print(f"  -> {d}")
    print("\nrel_err = ||theta - theta*|| / ||theta_sol - theta*|| "
          "(lower is better; clean ~ the Theorem 1 limit)")
    return out


if __name__ == "__main__":
    main()
