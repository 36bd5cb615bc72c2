"""The paper's mean-estimation scenario end to end on the PyTorch port,
including the LM coupling operator running the SAME problem (the
counterpart of examples/federated_moons.py, built from repro_torch only).

Shows that the coupling layer (repro_torch.coupling, the operator that
mixes the agents' LM parameters in training) reproduces the paper's
Prop. 1 optimum when iterated.  On the card each iterate is one
``graph_mix`` launch (the ``mix`` op resolved for the leaves' device).

Run on the CUDA card (default), or on the CPU:
  PYTHONPATH=src python examples/federated_moons_torch.py
  PYTHONPATH=src python examples/federated_moons_torch.py --device cpu
"""

import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import (closed_form, confidences_from_counts,
                              solitary_mean)
from repro_torch.coupling import CouplingConfig, dense_mix_tree, make_state
from repro_torch.data import mean_estimation_problem

ITERATES = 400


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="accepted for a CLI like the other examples'; "
                         "the demo is small already and runs as is")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    g, data, targets, _ = mean_estimation_problem(n=60, eps=1.0, seed=0,
                                                  device=device)
    sol = solitary_mean(data)
    conf = confidences_from_counts(data.counts).cpu().numpy()
    alpha = 0.9   # faster spectral convergence for the demo

    star = closed_form(g, sol, conf, alpha, device=device).cpu().numpy()

    def err(th):
        th = th.cpu().numpy() if hasattr(th, "cpu") else th
        return float(np.mean((th[:, 0] - targets) ** 2))
    out = {"solitary": err(sol), "closed_form": err(star)}
    print(f"solitary L2  = {out['solitary']:.4f}")
    print(f"Prop.1 L2    = {out['closed_form']:.4f}")

    # the coupling layer's mixing operator, iterated == Eq. (5) iteration
    state = make_state(g, conf, alpha, device=device)
    cfg = CouplingConfig(mode="mp", alpha=alpha)
    theta = {"t": sol}
    anchor = {"t": sol}
    for _ in range(ITERATES):
        theta = dense_mix_tree(theta, anchor, state, cfg)
    out["coupling"] = err(theta["t"])
    print(f"coupling-op  = {out['coupling']:.4f} ({ITERATES} iterates)")
    out["gap"] = float(np.abs(theta["t"].cpu().numpy() - star).max())
    print(f"|coupling - closed_form|_max = {out['gap']:.2e}")
    assert out["gap"] < 1e-3
    return out


if __name__ == "__main__":
    main()
