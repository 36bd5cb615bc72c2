"""Where a joint graph-learning step's time goes on the card, at the main
path's size (n = 1M agents, k = 18 slots, p = 32), on synthetic inputs:
theta and the slots K standard normal, about 85 % of the slots live, the
weights uniform on each row's live slots and normalised.

    python3 tools/probe_joint_step.py

Times the whole graph step of ``simulate.engines.run_joint_scenario``
(``core.graph_learning.reweight_rows`` then ``prune_rows``, with the JAX
benchmark's knobs eta 0.3, lam 1.0, prune 1e-3) and its parts: the slot
distances, the ``edge_reweight`` op, and inside that op the descending
sort and the float32 cumsum of the (n, k) rows.  Needs a CUDA card.  Each
is timed with CUDA events over 20 calls after warm-up, in two passes.
Prints one JSON line per measurement, then the card's name and power
limit.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, K, P = 1_000_000, 18, 32
ETA, LAM, PRUNE = 0.3, 1.0, 1e-3


def time_ms(torch, fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_joint_step: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.graph_learning import (prune_rows, reweight_rows,
                                                 slot_sq_distances)
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    theta = torch.randn((N, P), generator=g, device=dev)
    Kt = torch.randn((N, K, P), generator=g, device=dev)
    live = torch.rand((N, K), generator=g, device=dev) < 0.85
    w = torch.rand((N, K), generator=g, device=dev) * live
    w = w / w.sum(dim=1, keepdim=True).clamp(min=1e-9)
    d = slot_sq_distances(theta, Kt, live)
    vm = torch.where(live, -d / (2.0 * LAM), ref.NEG_INF)
    u = -torch.sort(-vm, dim=-1).values

    def step():
        w2 = reweight_rows(theta, Kt, w, live, eta=ETA, lam=LAM)
        return prune_rows(w2, live, PRUNE)

    parts = {
        "graph_step": step,
        "slot_sq_distances": lambda: slot_sq_distances(theta, Kt, live),
        "edge_reweight": lambda: ref.edge_reweight(d, w, live, eta=ETA,
                                                   lam=LAM),
        "sort": lambda: torch.sort(-vm, dim=-1),
        "cumsum": lambda: torch.cumsum(u, dim=-1),
        "prune_rows": lambda: prune_rows(w, live, PRUNE),
    }
    for rep in range(2):
        for name, fn in parts.items():
            print(json.dumps({"part": name, "pass": rep, "n": N, "k": K,
                              "p": P, "ms": time_ms(torch, fn)}),
                  flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
