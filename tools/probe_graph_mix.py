"""``graph_mix`` on the card, one source tree against another: the tile
kernel's drift over a long ``synchronous`` run (``chip_smoke.py``'s 4c'),
its time at 4c's shape, and the rows kernel's device and host time at the
sweeps' shapes.

    python3 tools/probe_graph_mix.py [--parent DIR] [--variants]

DIR is another checkout of the repository (``git archive`` of the parent
commit unpacked under ``build/``, say).  Needs an H100 and nvcc
(``$CUDA_HOME`` or ``/usr/local/cuda``).  ``graph_mix.cu`` of each tree is
built on its own (with ``-Xptxas -v``, whose register and spill lines are
printed) into ``build/probe_graph_mix/``, one nvcc each, all at once.
With ``--variants``, text edits of this checkout's tile kernel are built
too:

* ``truncating``: the three ``mma`` of a step straight into the running
  accumulator (the accumulation before the drift repair);
* ``one_fragment``: the three ``mma``, small terms first, into one zeroed
  fragment, then one IEEE add into the accumulator;
* ``rna_lo``: ``lo = x - hi`` rounded to TF32 (``cvt.rna``) before the
  tensor core reads it;
* ``c0_two``: the kernel's two fragments with the first ``mma`` of each
  reading C from one zero register, so no fragment is cleared.

Then one process for each reading, each with its tree's package on the
path and its library loaded in place of the package's kernels: the trees
in the order parent, change, change, parent (the change alone without
``--parent``), each the rows kernel at T = 300 and T = 20 (n = 300, D = 1;
``chip_smoke.check_graph_mix_trials``) and the tile kernel at n = 2048,
D = 4096 (``chip_smoke.check_graph_mix``), the first of each tree also the
drift (``chip_smoke.check_drift``, on 4c's graph and draws); then each
variant's drift and tile time.  Prints one JSON line per reading, then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = "src/repro_torch/kernels/csrc"
OUT = ROOT / "build/probe_graph_mix"

STEP = """          float hh[4] = {0.f, 0.f, 0.f, 0.f}, sm[4] = {0.f, 0.f, 0.f, 0.f};
          hopper::mma_tf32(sm, al, bh[j]);
          hopper::mma_tf32(sm, ah, bl[j]);
          hopper::mma_tf32(hh, ah, bh[j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += hh[e] + sm[e];
"""
TRUNCATING = """          hopper::mma_tf32(acc[i][j], al, bh[j]);
          hopper::mma_tf32(acc[i][j], ah, bl[j]);
          hopper::mma_tf32(acc[i][j], ah, bh[j]);
"""
ONE_FRAGMENT = """          float f[4] = {0.f, 0.f, 0.f, 0.f};
          hopper::mma_tf32(f, al, bh[j]);
          hopper::mma_tf32(f, ah, bl[j]);
          hopper::mma_tf32(f, ah, bh[j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += f[e];
"""
C0_STEP = """          float hh[4], sm[4];
          mma_c0(sm, al, bh[j]);
          hopper::mma_tf32(sm, ah, bl[j]);
          mma_c0(hh, ah, bh[j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += hh[e] + sm[e];
"""
INCLUDE = '#include "hopper.cuh"\n'
C0_MMA = INCLUDE + """
namespace {
// D = A . B with C read from one zero register (no fragment to clear)
__device__ __forceinline__ void mma_c0(float (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}
}  // namespace
"""
RNA = INCLUDE + """
namespace {
__device__ __forceinline__ void split_rna(float x, uint32_t& hi,
                                          uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo)
      : "f"(x - __uint_as_float(hi)));
}
}  // namespace
"""


def variants(text):
    for anchor in (STEP, INCLUDE, "hopper::split_tf32("):
        if anchor not in text:
            raise RuntimeError(f"graph_mix.cu changed: {anchor!r} not found")
    return {"truncating": text.replace(STEP, TRUNCATING),
            "one_fragment": text.replace(STEP, ONE_FRAGMENT),
            "rna_lo": text.replace(INCLUDE, RNA).replace(
                "hopper::split_tf32(", "split_rna("),
            "c0_two": text.replace(INCLUDE, C0_MMA).replace(STEP, C0_STEP)}


def build(nvcc, name, text, include):
    """Compile one source into a shared library; returns its path and
    ptxas's lines for the kernels."""
    src = OUT / f"{name}.cu"
    src.write_text(text)
    lib = OUT / f"{name}.so"
    done = subprocess.run([*nvcc, "-Xptxas", "-v", "-I", str(include),
                           "-shared", str(src), "-o", str(lib)],
                          capture_output=True, text=True)
    if done.returncode:                 # reported, and not run
        return None, done.stderr.splitlines()[-20:]
    keep = [line.strip() for line in done.stderr.splitlines()
            if any(w in line for w in ("Compiling entry", "spill", "Used"))]
    return str(lib), keep


def child(args) -> int:
    """One reading with ``args.src`` on the path and ``args.lib`` as the
    kernel library."""
    sys.path.insert(0, args.src)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core.graph import random_geometric_graph
    from repro_torch.core.model_propagation import (mp_mix_operator,
                                                    synchronous)
    from repro_torch.experiments import (joint_mean_estimation_trials,
                                         mean_estimation_trials)
    from repro_torch.kernels import _build, dispatch
    from repro_torch.kernels import graph_mix as gm

    torch.backends.cuda.matmul.allow_tf32 = False
    lib = ctypes.CDLL(args.lib)
    lib.repro_graph_mix.argtypes = list(_build.SIGNATURES["repro_graph_mix"])
    lib.repro_graph_mix.restype = ctypes.c_int
    _build._lib = lib
    dev = torch.device("cuda")
    tag = dict(tree=args.name, run=args.run)

    # chip_smoke.py's draws, in its order: the n = 1M models and
    # confidences, then 4c's confidences and D = 4096 models
    rng = np.random.default_rng(cs.SEED)
    rng.standard_normal((cs.N_AGENTS, cs.P))
    rng.uniform(0.05, 1.0, cs.N_AGENTS)
    g = random_geometric_graph(cs.N_DENSE, k=cs.K_DENSE, seed=cs.SEED)
    c = rng.uniform(0.05, 1.0, cs.N_DENSE).astype(np.float32)
    sol = rng.standard_normal((cs.N_DENSE, cs.D_DENSE)).astype(np.float32)

    if args.drift:
        drift, launches = cs.check_drift(torch, dispatch, synchronous, g, sol,
                                         c, dev)
        print(json.dumps(dict(tag, **drift, launches=launches)), flush=True)
    P = torch.as_tensor(g.P, dtype=torch.float32, device=dev)
    A, b = mp_mix_operator(P, torch.as_tensor(c, device=dev), cs.ALPHA)
    s = torch.as_tensor(sol, device=dev)
    tile = cs.check_graph_mix(torch, gm, (s, s, A.contiguous(),
                                          b.contiguous()))
    print(json.dumps(dict(tag, **tile)), flush=True)
    del P, A, b, s
    if args.drift_only:
        return 0
    for trials in (mean_estimation_trials(range(cs.SWEEP_SEEDS),
                                          cs.SWEEP_ALPHAS, n=cs.SWEEP_N),
                   joint_mean_estimation_trials(
                       range(cs.JOINT_SWEEP_SEEDS), (0.9,),
                       cs.JOINT_SWEEP_ETAS, n=cs.SWEEP_N)):
        P, c, s = (torch.as_tensor(a, device=dev)
                   for a in (trials.P, trials.c, trials.theta_sol))
        A, b = mp_mix_operator(
            P, c, torch.as_tensor(trials.alpha, device=dev)[:, None])
        rows = cs.check_graph_mix_trials(torch, gm, (s, s, A, b))
        print(json.dumps(dict(tag, **rows)), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="another checkout to hold against")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--name", help=argparse.SUPPRESS)
    ap.add_argument("--run", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--src", help=argparse.SUPPRESS)
    ap.add_argument("--lib", help=argparse.SUPPRESS)
    ap.add_argument("--drift", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--drift-only", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args)

    import torch
    if not torch.cuda.is_available():
        print("probe_graph_mix: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    trees = {"change": ROOT}
    if args.parent:
        trees["parent"] = pathlib.Path(args.parent).resolve()
    todo = {name: ((root / CSRC / "graph_mix.cu").read_text(), root / CSRC)
            for name, root in trees.items()}
    if args.variants:
        todo.update({name: (text, ROOT / CSRC) for name, text in
                     variants(todo["change"][0]).items()})
    nvcc = [_build._nvcc(), *_build.NVCC_FLAGS]
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as ex:
        built = dict(zip(todo, ex.map(
            build, [nvcc] * len(todo), todo, [t for t, _ in todo.values()],
            [inc for _, inc in todo.values()])))
    for name, (_, ptxas) in built.items():
        print(json.dumps(dict(build=name, ptxas=ptxas)), flush=True)

    order = ["parent", "change", "change", "parent"] if args.parent \
        else ["change"]
    runs = [(name, trees[name], k, k == order.index(name), False)
            for k, name in enumerate(order)]
    runs += [(name, ROOT, 0, True, True) for name in todo
             if name not in trees]
    failed = 0
    for name, root, k, drift, drift_only in runs:
        if built[name][0] is None:
            failed = 1
            continue
        cmd = [sys.executable, __file__, "--child", "--name", name,
               "--run", str(k), "--src", str(root / "src"),
               "--lib", built[name][0]]
        cmd += ["--drift"] * drift + ["--drift-only"] * drift_only
        failed |= subprocess.run(cmd).returncode
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
