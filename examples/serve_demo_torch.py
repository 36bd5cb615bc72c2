"""Serving demo on the PyTorch port: batched decode with slot-based
continuous batching (the counterpart of examples/serve_demo.py, built
from repro_torch only).

Trains nothing — initializes a small model from a seeded
``torch.Generator``, submits a mixed batch of variable-length prompts,
and decodes with the split-KV cache engine.  The model takes the plain
``ref`` attention route, as the JAX demo's does, so no hand-written kernel
runs; decode is plain torch.  Tokens are drawn at temperature 0.7 on the
engine's own generator, so they are the port's own, not the JAX demo's.

Run on the CUDA card (default), or on the CPU:
  PYTHONPATH=src python examples/serve_demo_torch.py
  PYTHONPATH=src python examples/serve_demo_torch.py --smoke --device cpu
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import Model, ModelConfig
from repro_torch.serve import Engine, ServeConfig

# the JAX demo's model, serving knobs and prompt lengths
CONFIG = dict(name="serve-demo", family="dense", n_layers=4, d_model=128,
              n_heads=4, n_kv_heads=2, d_ff=256, vocab_size=512,
              attn_impl="ref", remat=False)
SERVE = dict(batch_size=4, cache_len=128, max_new_tokens=24,
             temperature=0.7, seed=0)
PROMPT_LENS = (9, 17, 5, 30, 12, 3, 21, 8)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="accepted for a CLI like the other examples'; "
                         "the demo is small already and runs as is")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = ModelConfig(**CONFIG)
    model = Model(cfg, device=device).init(
        torch.Generator(device=device).manual_seed(0))
    print(f"model: {model.param_count()/1e6:.2f}M params")

    eng = Engine(model, ServeConfig(**SERVE))
    rng = np.random.default_rng(0)
    t0 = time.time()
    rids = [eng.submit(rng.integers(0, cfg.vocab_size, (l,)))
            for l in PROMPT_LENS]
    print(f"submitted {len(rids)} requests into {SERVE['batch_size']} "
          f"slots")
    results = eng.run()
    dt = time.time() - t0
    total_toks = sum(len(v) for v in results.values())
    for rid in rids:
        toks = results[rid]
        print(f" req {rid}: {len(toks)} tokens -> {toks[:10]}...")
    print(f"{total_toks} tokens in {dt:.1f}s "
          f"({total_toks/dt:.1f} tok/s, {device.type.upper()}, batched)")
    return {"params": model.param_count(), "requests": len(rids),
            "tokens_by_request": {rid: len(results[rid]) for rid in rids},
            "total_tokens": total_toks, "seconds": dt,
            "exhausted": eng.exhausted}


if __name__ == "__main__":
    main()
