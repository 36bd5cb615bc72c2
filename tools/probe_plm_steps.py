"""``chip_smoke.py`` 7c's step time (the example's plm-100m on 8 agents,
every coupling mode) read several times in one process, to tell a cost of
the code from one of the machine or of what ran before it.

    python3 tools/probe_plm_steps.py [--parent PATH/chip_smoke.py]

Runs 7c (``chip_smoke.check_train_modes``) first in a fresh process, then
after 10a (``check_dryrun_card``: a one-agent Llama-3-8B step at 2 layers
and the dry run of it), as ``chip_smoke.py`` orders them, then once more.
Given ``--parent``, another ``chip_smoke.py`` (an older tree's) whose own
7c runs first and last, on this tree's package, so the two forms of 7c
are read in one call: parent, this, (10a,) this, this, parent.  Needs a
CUDA card.  Prints one JSON line per run (ms a step and tokens/s by
mode), then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    (mod.ROOT / "build").mkdir(exist_ok=True)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default="")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build, dispatch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    _build.library()
    dev = torch.device("cuda")
    this = load(ROOT / "chip_smoke.py", "chip_smoke_this")
    parent = load(pathlib.Path(args.parent).resolve(), "chip_smoke_parent") \
        if args.parent else None

    def run_7c(mod, label):
        rec, _, bad = mod.check_train_modes(torch, np, dispatch, dev, smi)
        print(json.dumps({"run": label, "failed": bad,
                          "ms_per_step": {m: v["ms_per_step"] for m, v in
                                          rec["modes"].items()},
                          "tokens_per_s": {m: v["tokens_per_s"] for m, v in
                                           rec["modes"].items()},
                          "device": smi}), flush=True)
        return bad

    bad = []
    if parent:
        bad.append(run_7c(parent, "parent 7c, first"))
    bad.append(run_7c(this, "7c, first"))
    _, err = this.check_dryrun_card(torch, np, dispatch, dev, smi)
    bad.append(err)
    bad.append(run_7c(this, "7c, after 10a"))
    bad.append(run_7c(this, "7c, again"))
    if parent:
        bad.append(run_7c(parent, "parent 7c, last"))
    print(smi)
    return 1 if any(bad) else 0


if __name__ == "__main__":
    sys.exit(main())
