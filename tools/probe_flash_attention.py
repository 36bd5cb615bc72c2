"""``flash_attention`` on the card, one source tree against another: what
ptxas says of each tree's kernels, their registers and spills as the
runtime reports them, and each case of ``chip_smoke.FA_CASES`` (kernel
against its plain version with the kernel's back-to-back ms, its device ms
and host µs a call read apart, the plain version's and SDPA's ms).

    python3 tools/probe_flash_attention.py [--parent DIR] [--variants]
                                           [--scaling] [--float32]

DIR is another checkout of the repository (``git archive`` of the parent
commit unpacked under ``build/``, say).  Needs an H100 and nvcc
(``$CUDA_HOME`` or ``/usr/local/cuda``).  ``flash_attention.cu`` of each
tree is built on its own (with ``-Xptxas -v``, whose register, spill and
warning lines are printed) into ``build/probe_flash_attention/``, one nvcc
each, all at once.  Then one process for each reading, each with its
tree's package on the path and its library loaded in place of the
package's kernels: the trees in the order parent, change, change, parent
(the change alone without ``--parent``).  The first reading of each tree
keeps its outputs, and the max abs difference between the two trees'
outputs on the same inputs is printed for every case.  With
``--variants``, text edits of this checkout's warp-specialised kernel
(``flash_fwd_ws``, head dims 256 and 64) are built too, each timed once
at the bf16 hd-256 and hd-64 cases (device ms; their outputs are wrong by
design and not held; with ``--float32`` the float32 edits below):

* ``no_reload``: each ring stage is filled once and the consumers compute
  on those tiles over and over (no copies in the loop);
* ``no_mma``: no ``wgmma`` issued (copies, waits and softmax only);
* ``no_softmax``: the softmax of every tile after the first skipped
  (copies and products only);
* ``no_pingpong``: the two consumer warpgroups issue their products
  without taking turns (hd 256);
* ``bk64``: 64-key tiles at hd 256 (Q 64 KB + K and V 2 x 32 KB each);
* ``unfused_softmax``: a weight as 2^(s * scale - m), rounded after the
  multiply, in place of 2^fma(s, scale, -m);
* ``exp2f``: the library's ``exp2f`` in place of one ``ex2.approx.ftz``.

With ``--float32``, only the float32 cases of ``FA_CASES`` are read (the
3xTF32 kernels: ``flash_fwd_3xtf32`` at head dims 64 and 128,
``flash_fwd_3xtf32_pieces`` at 256), with or without ``--parent``; with
``--variants`` too, the text edits are those of the hd-256 float32 kernel
(``f32_*`` in ``EDITS``), each timed once at the float32 hd-256 cases:

* ``f32_no_mma``: no ``wgmma`` issued (loads, splits, stores, waits and
  softmax only).

With ``--scaling``, each tree also times the bf16 hd-256 and hd-64 cases
at batch 1, 2, 4 and 8 (device ms), so that the cost of a launch's start
and tail shows against work that fills several waves.

Prints one JSON line per reading, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = "src/repro_torch/kernels/csrc"
OUT = ROOT / "build/probe_flash_attention"
# --scaling: the hd-256 and hd-64 cases at these batch sizes (blocks
# enough for several waves show what a launch's start and tail cost)
BATCHES = (1, 2, 4, 8)
PTXAS_WORDS = ("Compiling entry", "Used", "spill", "C75", "warning")


WS_MARK = "// ---- bf16 at hd 256 and 64: warp-specialised"
EDITS = {
    "no_reload": (
        ("      for (int i = 0; i < n_tiles; ++i) {\n        // use i / ST",
         "      for (int i = 0; i < min(n_tiles, ST); ++i) {\n        "
         "// use i / ST"),
        ("if (leader && i + ST < n_tiles) {", "if (false) {"),
        ("hopper::mbar_wait(&full[i % ST], (i / ST) & 1);",
         "hopper::mbar_wait(&full[i % ST], 0);")),
    "no_mma": (
        ("      if constexpr (BK == 80)\n"
         "        hopper::wgmma_m64n80k16_ss(acc, da, db, kk > 0);\n"
         "      else\n"
         "        hopper::wgmma_m64n64k16_ss(acc, da, db, kk > 0);", ""),
        ("        if constexpr (NP == 64)\n"
         "          hopper::wgmma_m64n128k16_rs_tb(o_acc[p], pa[kk], db);\n"
         "        else\n"
         "          hopper::wgmma_m64n64k16_rs_tb(o_acc[p], pa[kk], db);",
         "")),
    "no_softmax": (
        ("      softmax(s, kt_begin + i, alpha0, alpha1);",
         "    alpha0 = alpha1 = 1.f;"),),
    "no_pingpong": (
        ("hopper::named_sync(1 + wg, 256);", ";"),
        ("hopper::named_arrive(2 - wg, 256);", ";"),
        ("if (wg == 1) hopper::named_arrive(1, 256);", ";")),
    "bk64": (
        ("  static constexpr int BK = SPLIT ? 64 : 80;",
         "  static constexpr int BK = 64;"),),
    "unfused_softmax": (
        ("          const float p = ex2(fmaf(x[4 * j + e], scale_log2,\n"
         "                                   -(e < 2 ? mn0 : mn1)));",
         "          const float p = ex2(__fsub_rn(\n"
         "              __fmul_rn(x[4 * j + e], scale_log2), "
         "e < 2 ? mn0 : mn1));"),),
    "exp2f": (
        ('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
         "  y = exp2f(x);"),),
    # the float32 hd-256 kernel (flash_fwd_3xtf32_pieces)
    "f32_no_mma": (
        ("""        hopper::wgmma_m64n64k8_tf32_ss(shh, tc::desc_add(dqh, qo),
                                       tc::desc_add(dkh, ko), acc);
        hopper::wgmma_m64n64k8_tf32_ss(ssm, tc::desc_add(dql, qo),
                                       tc::desc_add(dkh, ko), acc);
        hopper::wgmma_m64n64k8_tf32_ss(ssm, tc::desc_add(dqh, qo),
                                       tc::desc_add(dkl, ko), 1);""", ""),
        ("""        hopper::wgmma_m64n32k8_tf32_rs(hh, ph[kk], bh, kk > 0);
        hopper::wgmma_m64n32k8_tf32_ss(sm, tc::desc_add(dp, po), bh, kk > 0);
        hopper::wgmma_m64n32k8_tf32_rs(sm, ph[kk], tc::desc_add(dvl, vo), 1);""",
         "")),
}


def variants(text, float32):
    """``EDITS`` applied to the kernels of ``text`` from the warp-specialised
    one on: the float32 ones (``f32_``) with ``float32``, else the rest."""
    head, mark, tail = text.partition(WS_MARK)
    out = {}
    for name, edits in EDITS.items():
        if name.startswith("f32_") != float32:
            continue
        body = tail
        for old, new in edits:
            if body.count(old) != 1:
                raise RuntimeError(f"flash_attention.cu changed: {old!r}")
            body = body.replace(old, new)
        out[name] = head + mark + body
    return out


def build(nvcc, name, text, include):
    """Compile one ``flash_attention.cu`` text (its headers from
    ``include``) into a shared library; returns its path (None if nvcc
    refused it) and ptxas's lines."""
    src = OUT / f"{name}.cu"
    src.write_text(text)
    lib = OUT / f"{name}.so"
    done = subprocess.run([*nvcc, "-Xptxas", "-v", "-I", str(include),
                           "-shared", str(src), "-o", str(lib)],
                          capture_output=True, text=True)
    if done.returncode:                 # reported, and not run
        return None, done.stderr.splitlines()[-30:]
    keep = [line.strip() for line in done.stderr.splitlines()
            if any(w in line for w in PTXAS_WORDS)]
    return str(lib), keep


def cases(cs, float32):
    """``(index, case)`` of ``FA_CASES``: the float32 ones with
    ``float32``, else all."""
    return [(i, case) for i, case in enumerate(cs.FA_CASES)
            if not float32 or case[6] == "float32"]


def child(args) -> int:
    """One reading with ``args.src`` on the path and ``args.lib`` as the
    kernel library."""
    sys.path.insert(0, args.src)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    lib = ctypes.CDLL(args.lib)
    for name in ("repro_flash_attention", "repro_flash_attention_attrs"):
        fn = getattr(lib, name)
        fn.argtypes = list(_build.SIGNATURES[name])
        fn.restype = ctypes.c_int
    _build._lib = lib
    tag = dict(tree=args.name, run=args.run)
    if args.timing_only:
        for i, case in enumerate(cs.FA_CASES):
            if args.float32 != (case[6] == "float32") or case[4] == 128 \
                    or (args.float32 and case[4] != 256):
                continue
            for batch in BATCHES if args.scaling else (case[0],):
                case = (batch, *case[1:])
                q, k, v = cs.flash_inputs(torch, case, cs.SEED + i)
                device_ms, host_us, kept_up = cs.queued(
                    torch,
                    lambda: fa.flash_attention(q, k, v, window=case[5]), 10)
                print(json.dumps(dict(tag, case=list(case),
                                      device_ms=device_ms,
                                      host_kept_up=kept_up)), flush=True)
                del q, k, v
        return 0
    for hd in fa.HEAD_DIMS:
        for dtype in fa.DTYPES:
            print(json.dumps(dict(tag, hd=hd, dtype=str(dtype),
                                  **fa.flash_attention_resources(hd, dtype))),
                  flush=True)
    bad = 0
    for i, case in cases(cs, args.float32):
        kr = cs.check_flash(torch, fa, case, cs.SEED + i)
        bad += not kr["ok"]
        print(json.dumps(dict(tag, **kr)), flush=True)
        if args.keep:
            q, k, v = cs.flash_inputs(torch, case, cs.SEED + i)
            torch.save(fa.flash_attention(q, k, v, window=case[5]).cpu(),
                       OUT / f"{args.name}-{i}.pt")
            del q, k, v
        torch.cuda.empty_cache()
    return int(bad > 0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="another checkout to hold against")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--scaling", action="store_true")
    ap.add_argument("--float32", action="store_true")
    ap.add_argument("--timing-only", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--name", help=argparse.SUPPRESS)
    ap.add_argument("--run", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--src", help=argparse.SUPPRESS)
    ap.add_argument("--lib", help=argparse.SUPPRESS)
    ap.add_argument("--keep", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args)

    import torch
    if not torch.cuda.is_available():
        print("probe_flash_attention: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.kernels import _build

    OUT.mkdir(parents=True, exist_ok=True)
    trees = {"change": ROOT}
    if args.parent:
        trees["parent"] = pathlib.Path(args.parent).resolve()
    todo = {name: ((root / CSRC / "flash_attention.cu").read_text(),
                   root / CSRC) for name, root in trees.items()}
    if args.variants:
        todo.update({name: (text, ROOT / CSRC) for name, text in
                     variants(todo["change"][0], args.float32).items()})
    nvcc = [_build._nvcc(), *_build.NVCC_FLAGS]
    with concurrent.futures.ThreadPoolExecutor(len(todo)) as ex:
        built = dict(zip(todo, ex.map(
            build, [nvcc] * len(todo), todo, [t for t, _ in todo.values()],
            [inc for _, inc in todo.values()])))
    for name, (_, ptxas) in built.items():
        print(json.dumps(dict(build=name, ptxas=ptxas)), flush=True)

    order = ["parent", "change", "change", "parent"] if args.parent \
        else ["change"]
    failed = 0
    for k, name in enumerate(order):
        if built[name][0] is None:
            failed = 1
            continue
        cmd = [sys.executable, __file__, "--child", "--name", name,
               "--run", str(k), "--src", str(trees[name] / "src"),
               "--lib", built[name][0]]
        cmd += ["--keep"] * (k == order.index(name) and len(trees) > 1)
        cmd += ["--float32"] * args.float32
        failed |= subprocess.run(cmd).returncode
    if args.scaling:
        for name in trees:
            failed |= subprocess.run(
                [sys.executable, __file__, "--child", "--timing-only",
                 "--scaling", "--name", name, "--src",
                 str(trees[name] / "src"), "--lib",
                 built[name][0]]).returncode
    for name in todo:
        if name in trees:
            continue
        if built[name][0] is None:
            failed = 1
            continue
        failed |= subprocess.run(
            [sys.executable, __file__, "--child", "--timing-only", "--name",
             name, "--src", str(ROOT / "src"), "--lib", built[name][0]]
            + ["--float32"] * name.startswith("f32_")).returncode
    if args.parent and not failed:
        for i, case in cases(cs, args.float32):
            a, b = (torch.load(OUT / f"{name}-{i}.pt") for name in trees)
            print(json.dumps(dict(
                case=list(case), change_vs_parent_max_abs_diff=(
                    a.float() - b.float()).abs().max().item())), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
