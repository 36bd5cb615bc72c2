"""``flash_attention`` on the card at head dims 64, 128 and 256: what ptxas
says of each kernel, its registers and spills as the runtime reports them,
and each case of ``chip_smoke.FA_CASES`` (kernel against its plain
version, with the kernel's, the plain version's and SDPA's ms).

    python3 tools/probe_flash_attention.py

Needs an H100 and nvcc (``$CUDA_HOME`` or ``/usr/local/cuda``).
``flash_attention.cu`` is compiled once more on its own with
``-Xptxas -v`` into ``build/probe_flash_attention/`` (its register and
spill lines are printed); the cases run through the package's own
library.  Prints one JSON line per reading, then the card's name and
power limit.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "build/probe_flash_attention"


def ptxas_lines() -> list:
    nvcc = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) \
        / "bin/nvcc"
    OUT.mkdir(parents=True, exist_ok=True)
    src = ROOT / "src/repro_torch/kernels/csrc/flash_attention.cu"
    run = subprocess.run(
        [str(nvcc), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c", str(src), "-o",
         str(OUT / "flash_attention.o")], capture_output=True, text=True,
        check=True)
    return [ln for ln in run.stderr.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln
            or "C7515" in ln]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_flash_attention: no CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa

    for ln in ptxas_lines():
        print(ln, flush=True)
    for hd in fa.HEAD_DIMS:
        for dtype in fa.DTYPES:
            print(json.dumps(dict(hd=hd, dtype=str(dtype), **fa.
                                  flash_attention_resources(hd, dtype))),
                  flush=True)
    bad = 0
    for i, case in enumerate(chip_smoke.FA_CASES):
        kr = chip_smoke.check_flash(torch, fa, case, chip_smoke.SEED + i)
        bad += not kr["ok"]
        print(json.dumps(kr), flush=True)
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return int(bad > 0)


if __name__ == "__main__":
    sys.exit(main())
