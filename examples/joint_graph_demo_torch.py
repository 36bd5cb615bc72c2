"""Joint graph + model learning recovering planted clusters on the PyTorch
port (the counterpart of examples/joint_graph_demo.py, built from
repro_torch only; DESIGN.md §13).

Two clusters of agents estimate opposite means (the §5.1 mean-estimation
task with cluster structure planted in the targets).  The candidate
collaboration graph is deliberately polluted: every agent carries a few
links into the *wrong* cluster.  With graph learning enabled, the agents
re-estimate their outgoing edge weights from local model distances
(sparse simplex projection) while gossiping — and the learned graph drops
the planted inter-cluster edges while keeping >= 90% of the intra-cluster
ones.

Runs record telemetry; the per-run metric line is the telemetry report
row, and ``--out DIR`` records each run for ``tools/trace_report_torch.py``
(or ``tools/trace_report.py``).  The port's scheduler draws its own events
from ``--seed``, so the learned graph is the port's own.

    PYTHONPATH=src python examples/joint_graph_demo_torch.py            # full
    PYTHONPATH=src python examples/joint_graph_demo_torch.py --smoke \
        --device cpu
"""

import argparse
import os

from repro_torch import resolve_device
from repro_torch.core.graph_learning import cluster_edge_recovery
from repro_torch.data.synthetic import two_cluster_mean_problem
from repro_torch.simulate import (NetworkConditions, ScenarioSpec,
                                  planted_partition_topology, run_scenario)
from repro_torch.telemetry import (TelemetryConfig, build_manifest,
                                   format_row, trace_rows, write_run)


def recovery_figures(rec):
    return {"intra_recovered": rec.intra_recovered,
            "inter_suppressed": rec.inter_suppressed,
            "inter_mass": rec.inter_mass}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=400)
    ap.add_argument("--eta", type=float, default=0.3)
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny problem (tests)")
    ap.add_argument("--out", default=None,
                    help="write one telemetry run directory per eta under "
                         "this path (see tools/trace_report_torch.py)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n = 60 if args.smoke else args.n
    rounds = 150 if args.smoke else args.rounds

    topo = planted_partition_topology(n, 2, k_intra=5, k_inter=2,
                                      seed=args.seed)
    labels, _, theta_sol, c = two_cluster_mean_problem(n, p=4,
                                                       seed=args.seed)
    tabs = topo.tables
    base = cluster_edge_recovery(tabs.nbr_idx, tabs.deg_count, tabs.nbr_p,
                                 labels)
    print(f"candidate graph: n={n} directed slots={int(tabs.deg_count.sum())}"
          f" intra={base.n_intra} inter={base.n_inter}"
          f" (inter weight mass before learning: {base.inter_mass:.2f})")

    out = {"n": n, "rounds": rounds, "before": dict(
        recovery_figures(base), n_intra=base.n_intra, n_inter=base.n_inter),
        "runs": {}}
    for eta in (0.0, args.eta):
        tr = run_scenario(ScenarioSpec(
            algo="joint", topology=topo, theta_sol=theta_sol, c=c,
            alpha=0.9, conditions=NetworkConditions(), rounds=rounds,
            batch=n // 2, seed=args.seed, record_every=rounds // 3,
            eta_graph=eta, lam=args.lam, graph_every=5, prune_eps=1e-3,
            telemetry=TelemetryConfig(enabled=True), device=device))
        rec = cluster_edge_recovery(tabs.nbr_idx, tabs.deg_count,
                                    tr.final_w, labels)
        rows = trace_rows(tr)
        tag = "frozen graph (eta=0)" if eta == 0 else f"learned (eta={eta})"
        live = int(tr.live_edges_hist[-1])
        out[f"eta={eta:g}"] = dict(recovery_figures(rec), live_slots=live)
        print(f"{tag:22s} intra_recovered={rec.intra_recovered:5.1%} "
              f"inter_suppressed={rec.inter_suppressed:5.1%} "
              f"inter_mass={rec.inter_mass:.4f} "
              f"live_slots={live}")
        print(f"{'':22s} {format_row(rows[-1])}")
        if args.out:
            d = write_run(os.path.join(args.out, f"eta-{eta:g}"),
                          build_manifest(seed=args.seed, extra={
                              "eta_graph": eta, "lam": args.lam, "n": n,
                              "rounds": rounds}),
                          rows)
            out["runs"][f"eta-{eta:g}"] = d
            print(f"{'':22s} -> {d}")
    assert rec.intra_recovered >= 0.9, "cluster recovery regressed"
    print("OK: learned graph recovers the planted clusters")
    return out


if __name__ == "__main__":
    main()
