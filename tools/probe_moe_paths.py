"""How far apart a MoE model's attention paths land in bf16, and why.

    python3 tools/probe_moe_paths.py [--skip-paths] [--phases [8a ...]]

For OLMoE-1B-7B (16 layers, 2048 tokens) and Phi-3.5-MoE (cut to 8
layers, 4096 tokens), at full width with ``chip_smoke.py``'s random bf16
weights: ``Model.forward`` of one prompt through the ``flash`` route
(the ``flash_attention`` kernel), ``chunked`` and ``ref``
(``chunked_attention`` and ``ref_attention``, both plain torch), each
with every MoE layer's routing recorded.  Prints, for each pair of
routes: the relative L2 of the last position's logits, the median and
90th percentile over positions of each position's relative L2, the share
of positions past 0.1, and per layer the share of tokens whose top-k
experts differ and whose kept choices differ (a dropped choice moves
when any earlier token's routing does: capacity is taken in token
order).  ``--skip-paths`` leaves that out.  With ``--phases``, then runs
``chip_smoke.check_family`` for the family phases named (every one when
none is).  Needs an H100; prints the card's name and power
limit last.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CASES = (("olmoe-1b-7b", None, 2048), ("phi3.5-moe", 8, 4096))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-paths", action="store_true")
    ap.add_argument("--phases", nargs="*")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe_moe_paths: no CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import dispatch
    from repro_torch.models import Model
    from repro_torch.models import blocks

    dev = torch.device("cuda")
    routes = []
    real_moe = blocks.moe_apply

    def recording(cfg, p, x):
        """moe_apply, recording each token's chosen and kept experts as
        (T, E) masks (the routing of ``blocks.moe_apply``)."""
        y, aux = real_moe(cfg, p, x)
        E, k = cfg.n_experts, cfg.top_k
        gates = torch.softmax((x.reshape(-1, x.shape[-1]) @ p.router)
                              .float(), dim=-1)
        topi = blocks.moe_route(gates, k)[1]
        T = topi.shape[0]
        C = min(int(np.ceil(T * k / E * cfg.capacity_factor)), T)
        onehot = torch.nn.functional.one_hot(topi.reshape(-1), E)
        pos = torch.gather(torch.cumsum(onehot, 0) - onehot, 1,
                           topi.reshape(-1, 1)).reshape(T, k)
        chosen = torch.zeros(T, E, dtype=torch.bool, device=x.device)
        kept = chosen.clone()
        chosen.scatter_(1, topi, True)
        kept.scatter_(1, topi, pos < C)
        routes[-1].append((chosen.cpu(), kept.cpu()))
        return y, aux
    blocks.moe_apply = recording
    for arch, depth, S in () if args.skip_paths else CASES:
        cfg = dataclasses.replace(get_config(arch), attn_impl="flash")
        if depth:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        model = Model(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(chip_smoke.SEED))
        tok = torch.as_tensor(np.random.default_rng(chip_smoke.SEED + 9)
                              .integers(0, cfg.vocab_size, (1, S)),
                              device=dev)
        logits, routing = {}, {}
        for impl in ("flash", "chunked", "ref"):
            model.cfg = dataclasses.replace(cfg, attn_impl=impl)
            routes.append([])
            dispatch.reset_launch_counts()
            logits[impl] = model.forward({"tokens": tok})[0]
            routing[impl] = routes[-1]
            print(json.dumps(dict(arch=arch, impl=impl, launches=dispatch
                                  .launch_counts()["flash_attention"])),
                  flush=True)
        for a, b in itertools.combinations(logits, 2):
            la, lb = logits[a], logits[b]
            per = ((la - lb).norm(dim=-1) / lb.norm(dim=-1)).cpu().numpy()
            last = float(per[-1])
            rerouted = [float((ra[0] != rb[0]).any(-1).float().mean())
                        for ra, rb in zip(routing[a], routing[b])]
            kept = [float((ra[1] != rb[1]).any(-1).float().mean())
                    for ra, rb in zip(routing[a], routing[b])]
            print(json.dumps(dict(
                arch=arch, layers=cfg.n_layers, S=S, pair=f"{a}-{b}",
                last_position_rel_l2=last,
                median_position_rel_l2=float(np.median(per)),
                p90_position_rel_l2=float(np.quantile(per, 0.9)),
                share_positions_over_0_1=float((per > 0.1).mean()),
                share_tokens_rerouted_by_layer=rerouted,
                share_tokens_kept_differently_by_layer=kept)), flush=True)
        del model, logits
        torch.cuda.empty_cache()
    blocks.moe_apply = real_moe
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    if args.phases is not None:
        for phase in chip_smoke.FAMILY_PHASES:
            if args.phases and phase[0] not in args.phases:
                continue
            rec, _, bad = chip_smoke.check_family(torch, np, dispatch, dev,
                                                  smi, *phase)
            print(json.dumps(dict(rec, failed=bad)), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
