"""Quickstart on the PyTorch port: the paper's two algorithms in minutes
(the counterpart of examples/quickstart.py, built from repro_torch only).

1. Collaborative mean estimation (paper §5.1): solitary models, model
   propagation with confidence values (Prop. 1 + async gossip), and the
   errors of each.
2. Collaborative linear classification (paper §5.2): solitary vs consensus
   vs MP vs CL-ADMM accuracy.
3. Backend dispatch + batched sweeps: the same MP iterates through the
   ``graph_mix`` kernel and through its plain version, and a (seed x
   alpha) grid whose every sweep is one launch over the trial axis (on
   the card also held against its plain version).

``main`` returns the figures it prints and each part's wall seconds.

The async gossip draws its wake-ups with a seeded ``torch.Generator`` on
the run's device, so its L2 is the port's own, not the JAX example's.

Run on the CUDA card (default), or on the CPU:
  PYTHONPATH=src python examples/quickstart_torch.py
  PYTHONPATH=src python examples/quickstart_torch.py --smoke --device cpu
"""

import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import (async_gossip, closed_form,
                              confidences_from_counts, consensus_model,
                              solitary_gd, solitary_mean, sync_admm,
                              synchronous)
from repro_torch.data import (accuracy, linear_classification_problem,
                              mean_estimation_problem)
from repro_torch.experiments import mean_estimation_trials, run_mp_sweep
from repro_torch.kernels import ReproBackend

# the JAX example's sizes, and the --smoke cut
SIZES = {False: dict(gossip_steps=4000, solitary_steps=250,
                     consensus_steps=500, admm_steps=40, sync_steps=300,
                     sweeps=300),
         True: dict(gossip_steps=400, solitary_steps=25, consensus_steps=50,
                    admm_steps=2, sync_steps=50, sweeps=50)}


def as_np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") \
        else np.asarray(t)


def mean_estimation(device, gossip_steps):
    print("== collaborative mean estimation (n=100, eps=1) ==")
    g, data, targets, _ = mean_estimation_problem(n=100, eps=1.0, seed=0,
                                                  device=device)
    sol = solitary_mean(data)
    conf = confidences_from_counts(data.counts)

    def err(th):
        return float(np.mean((as_np(th)[:, 0] - targets) ** 2))
    star = closed_form(g, sol, conf, alpha=0.99, device=device)
    star_noc = closed_form(g, sol, np.ones(g.n), alpha=0.99, device=device)
    tr = async_gossip(g, sol, conf, alpha=0.99, steps=gossip_steps,
                      record_every=gossip_steps // 8, device=device)

    out = {"solitary": err(sol), "closed_form_no_conf": err(star_noc),
           "closed_form": err(star), "async_gossip": err(tr.theta_hist[-1]),
           "comms": int(tr.comms_hist[-1])}
    print(f" solitary models        L2 = {out['solitary']:.4f}")
    print(f" MP closed form (no c)  L2 = {out['closed_form_no_conf']:.4f}")
    print(f" MP closed form (Prop1) L2 = {out['closed_form']:.4f}")
    print(f" MP async gossip        L2 = {out['async_gossip']:.4f} "
          f"after {out['comms']} pairwise communications "
          f"(converging to the closed form; full curves in benchmarks)")
    return out


def linear_classification(device, solitary_steps, consensus_steps,
                          admm_steps):
    print("== collaborative linear classification (n=60, p=30) ==")
    g, train, test, _ = linear_classification_problem(n=60, p=30, seed=0,
                                                      device=device)
    sol = solitary_gd(train, "hinge", steps=solitary_steps)
    conf = confidences_from_counts(train.counts)

    def acc(th):
        return float(np.mean(accuracy(th, test)))
    cons = consensus_model(train, "hinge", steps=consensus_steps).expand(
        g.n, -1)
    mp = closed_form(g, sol, conf, alpha=0.99, device=device)
    cl = sync_admm(g, train, mu=0.05, rho=1.0, loss="hinge",
                   steps=admm_steps, k_steps=12, lr=0.05, theta_sol=sol,
                   device=device).theta_hist[-1]

    out = {"solitary": acc(sol), "consensus": acc(cons), "mp": acc(mp),
           "cl": acc(cl)}
    print(f" solitary  acc = {out['solitary']:.3f}")
    print(f" consensus acc = {out['consensus']:.3f}   (Eq. 2 baseline)")
    print(f" MP        acc = {out['mp']:.3f}")
    print(f" CL (ADMM) acc = {out['cl']:.3f}")
    return out


def backends_and_sweeps(device, sync_steps, sweeps):
    print("== backend dispatch + batched sweep ==")
    g, data, targets, _ = mean_estimation_problem(n=60, eps=1.0, seed=0,
                                                  device=device)
    sol = solitary_mean(data)
    conf = confidences_from_counts(data.counts)

    # auto backend: the graph_mix kernel on the card, its plain version
    # (kernels.ref) on the CPU
    auto = synchronous(g, sol, conf, alpha=0.9, steps=sync_steps,
                       device=device)
    out = {"synchronous": as_np(auto)[:, 0].tolist(),
           "cuda_vs_reference": None}
    if device.type == "cuda":
        # explicit overrides: the kernel against its plain version
        kern = synchronous(g, sol, conf, alpha=0.9, steps=sync_steps,
                           backend=ReproBackend.using(mix="cuda"),
                           device=device)
        plain = synchronous(g, sol, conf, alpha=0.9, steps=sync_steps,
                            backend=ReproBackend.using(mix="reference"),
                            device=device)
        out["cuda_vs_reference"] = float((kern - plain).abs().max())
        print(f" |cuda - reference| = {out['cuda_vs_reference']:.2e}")
    else:
        print(f" |cuda - reference|: not compared, the graph_mix kernel "
              f"needs the CUDA card (this run is on {device})")

    # 8 (seed, alpha) trials; each sweep is one mix op over the trial axis
    trials = mean_estimation_trials(seeds=range(4), alphas=[0.9, 0.99], n=60)
    res = run_mp_sweep(trials, sweeps=sweeps, device=device)
    out["sweep_cuda_vs_reference"] = None
    if device.type == "cuda":
        # the trial-axis kernel against its plain version
        plain = run_mp_sweep(trials, sweeps=sweeps, device=device,
                             backend=ReproBackend.using(mix="reference"))
        out["sweep_cuda_vs_reference"] = float(max(
            np.abs(res.err_hist - plain.err_hist).max(),
            np.abs(res.theta_final - plain.theta_final).max()))
        print(f" |sweep cuda - reference| = "
              f"{out['sweep_cuda_vs_reference']:.2e}")
    out["sweep"] = {}
    for a in (0.9, 0.99):
        sel = trials.alpha == np.float32(a)
        out["sweep"][a] = float(res.err_hist[sel, -1].mean())
        print(f" alpha={a}: mean final L2 over {int(sel.sum())} seeds = "
              f"{out['sweep'][a]:.4f}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="fewer ticks, iterations and sweeps (tests)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    size = SIZES[args.smoke]
    parts = {"mean_estimation": lambda: mean_estimation(
                 device, size["gossip_steps"]),
             "linear_classification": lambda: linear_classification(
                 device, size["solitary_steps"], size["consensus_steps"],
                 size["admm_steps"]),
             "backends": lambda: backends_and_sweeps(
                 device, size["sync_steps"], size["sweeps"])}
    out, seconds = {}, {}
    for name, part in parts.items():
        t0 = time.perf_counter()
        out[name] = part()         # each part ends on figures read back
        seconds[name] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


if __name__ == "__main__":
    main()
