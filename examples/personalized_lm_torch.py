"""End-to-end driver on the PyTorch port: train personalized ~100M-param
LMs with graph coupling, comparing coupling modes (the counterpart of
examples/personalized_lm.py, built from repro_torch only).

8 agents on a random geometric graph; each agent's data comes from its own
2-gram token process (neighbors share structure).  The run shows the
paper's central claim at LM scale: MP/CL coupling beats solitary training,
while a consensus model underfits the personalized distributions.

Run on the CUDA card (default), or on the CPU at the tiny size:
  PYTHONPATH=src python examples/personalized_lm_torch.py [--steps N]
  PYTHONPATH=src python examples/personalized_lm_torch.py --tiny --device cpu

The token stream holds (agents, V, V) float64 bigram tables on the host,
as the JAX example's does: 8.6 GB an agent at plm-100m's V = 32768.
"""

import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.graph import random_geometric_graph
from repro_torch.coupling import CouplingConfig, make_state
from repro_torch.data import PersonalizedLMConfig, personalized_token_stream
from repro_torch.models import Model, ModelConfig
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, save_checkpoint, train_loop


def model_config(tiny: bool) -> ModelConfig:
    if tiny:
        return ModelConfig(name="plm-tiny", family="dense", n_layers=2,
                           d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                           vocab_size=256, attn_impl="ref", remat=False)
    # ~100M params: 12L x 512 with 32k vocab
    return ModelConfig(name="plm-100m", family="dense", n_layers=12,
                       d_model=512, n_heads=8, n_kv_heads=4, d_ff=1536,
                       vocab_size=32768, attn_impl="ref", remat=False)


def train_config(mode: str, args, log_every=None) -> TrainConfig:
    return TrainConfig(
        n_agents=args.agents, steps=args.steps,
        optimizer=AdamWConfig(lr=1e-3, weight_decay=0.01),
        coupling=CouplingConfig(mode=mode, alpha=0.995, mu=0.02, every=4),
        log_every=log_every or max(args.steps // 10, 1))


def run(mode: str, args, graph, batches, model, state=None, log=print,
        log_every=None):
    """Train ``model``'s agents on ``batches`` with coupling ``mode`` on
    ``args.device``, from ``state`` (seed 0's initial state when None).
    Returns ``(final loss, seconds, state, history)``; the history holds
    every ``log_every``-th step (a tenth of the steps by default) and the
    last of ``args.steps``."""
    tcfg = train_config(mode, args, log_every)
    cstate = make_state(graph, np.ones(args.agents), tcfg.coupling.alpha,
                        device=args.device)
    t0 = time.time()
    state, hist = train_loop(model, tcfg, cstate, batches, state=state,
                             device=args.device,
                             log=lambda s: log(f"  [{mode}] {s}"))
    if args.ckpt:
        save_checkpoint(state, f"{args.ckpt}/{mode}", args.steps)
    return hist[-1]["loss"], time.time() - t0, state, hist


def make_batches(args, graph, vocab_size: int):
    """``args.steps`` batches of the agents' token stream, each
    ``{"tokens", "labels"}`` of (agents * batch, seq)."""
    lm = PersonalizedLMConfig(vocab_size=vocab_size, n_agents=args.agents,
                              seq_len=args.seq, batch_per_agent=args.batch,
                              seed=0)
    stream = personalized_token_stream(lm, graph)
    raw = [next(stream) for _ in range(args.steps)]
    B = args.agents * args.batch
    return [{"tokens": b[..., :-1].reshape(B, args.seq),
             "labels": b[..., 1:].reshape(B, args.seq)} for b in raw]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--agents", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--modes", default="none,consensus,mp,cl")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.tiny:
        args.steps = min(args.steps, 40)
    args.device = resolve_device(args.device)

    cfg = model_config(args.tiny)
    model = Model(cfg, device="meta")          # training reads its config
    print(f"model: {cfg.name} ({model.param_count()/1e6:.1f}M params), "
          f"{args.agents} agents, {args.steps} steps, on {args.device}")
    # k = 3 neighbours, as examples/personalized_lm.py (fewer when fewer
    # agents than that are asked for)
    graph = random_geometric_graph(args.agents, k=min(3, args.agents - 1),
                                   seed=0)
    batches = make_batches(args, graph, cfg.vocab_size)

    results = {}
    for mode in args.modes.split(","):
        loss, dt, _, _ = run(mode, args, graph, batches, model)
        results[mode] = loss
        print(f"{mode:10s} final loss {loss:.4f}  ({dt:.0f}s)")
    print("\nsummary (lower = better personalization):")
    for mode, loss in sorted(results.items(), key=lambda kv: kv[1]):
        print(f"  {mode:10s} {loss:.4f}")
    return results


if __name__ == "__main__":
    main()
