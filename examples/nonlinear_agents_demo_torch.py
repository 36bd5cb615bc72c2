"""Nonlinear personalized agents over the CL-ADMM substrate on the PyTorch
port (the counterpart of examples/nonlinear_agents_demo.py, built from
repro_torch only; DESIGN §18).

Each agent holds a tiny MLP whose flat parameter row (p = 33) rides the
engines' slot-row layout (models.flatten.ParamFlattener); the primal
phase is B AdamW steps on the reduced local Lagrangian
(core.primal.InexactPrimal) instead of the closed-form quadratic solve,
and on the card every round's edge phase is one ``cl_edge_step`` launch.
On federated_moons — one rotated/flipped two-moons task per cluster,
unbalanced per-agent sample counts — collaboration beats purely-local
training by a wide margin.  The port's scheduler draws its own events
from ``--seed``, so the accuracies are the port's own.

Run on the CUDA card (default), or on the CPU:
  PYTHONPATH=src python examples/nonlinear_agents_demo_torch.py [--smoke]
  PYTHONPATH=src python examples/nonlinear_agents_demo_torch.py --smoke \
      --device cpu
"""

import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.primal import (InexactPrimal, flat_predictor,
                                     solitary_adamw)
from repro_torch.data import federated_moons_problem, model_accuracy
from repro_torch.models import MLPAgent
from repro_torch.simulate import (NetworkConditions, ScenarioSpec,
                                  run_scenario)
from repro_torch.telemetry import TelemetryConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small/fast settings (tests)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rounds, steps = (60, 100) if args.smoke else (300, 400)

    topo, train, test_x, test_y = federated_moons_problem(
        n=24, seed=args.seed, device=device)
    model = MLPAgent(in_dim=2, hidden=(8,))
    predict = flat_predictor(model)

    sol = solitary_adamw(train, loss="logistic", model=model, steps=steps,
                         seed=args.seed)
    acc_sol = float(model_accuracy(sol, predict, test_x, test_y).mean())
    print(f"purely-local AdamW accuracy: {acc_sol:.3f}")

    tr = run_scenario(ScenarioSpec(
        algo="cl", topology=topo, data=train, mu=0.5, rho=0.2,
        conditions=NetworkConditions(), rounds=rounds, batch=12,
        seed=args.seed, record_every=max(1, rounds // 3),
        theta_sol=sol,
        primal=InexactPrimal(loss="logistic", model=model, b_steps=10,
                             lr=0.1),
        telemetry=TelemetryConfig(enabled=True), device=device))
    acc = float(model_accuracy(tr.theta_hist[-1], predict, test_x,
                               test_y).mean())
    obj = np.asarray(tr.telemetry.objective).sum(axis=1)
    out = {"p": int(sol.shape[1]), "acc_solitary": acc_sol, "acc": acc,
           "objective_first": float(obj[0]), "objective_last": float(obj[-1])}
    print(f"collaborative accuracy:      {acc:.3f} "
          f"(+{100 * (acc - acc_sol):.1f} points)")
    print(f"Eq.7 objective (telemetry):  {obj[0]:.1f} -> {obj[-1]:.1f}")
    assert acc > acc_sol
    return out


if __name__ == "__main__":
    main()
