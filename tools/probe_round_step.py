"""Where ``round_step``'s time goes on the card: variants of its CUDA source
and torch's own gathers and scatters of the same rows, on one synthetic
round at the main path's size (n = 1M agents, k = 18 slots, p = 32,
m = 200k events, 90 % delivered, targets uniform over the slots).

    python3 tools/probe_round_step.py

Needs an H100 and nvcc (``$CUDA_HOME`` or ``/usr/local/cuda``); builds
into ``build/probe_round_step/``.  The variants are text edits of
``src/repro_torch/kernels/csrc/round_step.cu``:

* ``kernel``: the source as it is;
* ``lanes4``, ``lanes16``, ``lanes32``: another group size for the fixed
  kernels (the source takes 8 lanes an event);
* knock-outs, timed only (their results are wrong by design):
  ``no_ke_columns`` (winners do not land the p columns of their Ke
  rows), ``no_ke_id`` (nor the id column), ``no_ke_write`` (neither),
  ``own_word_only`` (an event reads its own slot's word, not its row's k
  words), ``no_a_w`` (the gain is a constant).

``kernel`` and the ``lanes`` variants are held bit for bit against the
plain version on their first call.  Each variant is timed with CUDA events
over 50 calls after warm-up, in two passes; the torch calls likewise.
Prints one JSON line per measurement, then the card's name and power
limit.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/csrc/round_step.cu"
OUT = ROOT / "build/probe_round_step"
N, K, P, M = 1_000_000, 18, 32, 200_000

GROUP = "constexpr int GROUP = 8;"
KE_ROW = ("#pragma unroll\n"
          "  for (int i = 0; i < F; ++i) Ke[(size_t)s * (P + 1) + i * G + j] "
          "= mv[i];\n")
KE_ID = "  if (j == 0) Ke[(size_t)s * (P + 1) + P] = (float)e;"
ROW_WORDS = "    w[i] = landed && i * G + j < K ? words[s0 + i * G + j] : 0;"
OWN_WORD = "    w[i] = landed && i * G + j == mine ? words[s0 + i * G + j] : 0;"
GAIN = "    my_aw = a_w[s];"


def variants(text):
    for anchor in (GROUP, KE_ROW, KE_ID, ROW_WORDS, GAIN):
        if anchor not in text:
            raise RuntimeError(f"round_step.cu changed: {anchor!r} not found")
    out = {"kernel": (text, True)}
    for g in (4, 16, 32):
        out[f"lanes{g}"] = (text.replace(GROUP, f"constexpr int GROUP = {g};"),
                            True)
    keep_msg = "  if (mv[0] == 12345.f) Ke[(size_t)s * (P + 1) + j] = mv[0];\n"
    out["no_ke_columns"] = (text.replace(KE_ROW, keep_msg), False)
    out["no_ke_id"] = (text.replace(KE_ID, "  if (j == 0 && e < 0) Ke[0] = 0.f;"),
                       False)
    out["no_ke_write"] = (text.replace(KE_ROW, keep_msg).replace(
        KE_ID, "  if (j == 0 && e < 0) Ke[0] = 0.f;"), False)
    out["own_word_only"] = (text.replace(ROW_WORDS, OWN_WORD), False)
    out["no_a_w"] = (text.replace(GAIN, "    my_aw = 0.5f;"), False)
    return out


def build(nvcc, name, text):
    """Compile one variant into a shared library; returns its path."""
    src = OUT / f"{name}.cu"
    src.write_text(text)
    lib = OUT / f"{name}.so"
    subprocess.run([*nvcc, "-shared", str(src), "-o", str(lib)], check=True)
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_round_step: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.ref import gossip_round_step

    OUT.mkdir(parents=True, exist_ok=True)
    todo = variants(SRC.read_text())
    nvcc = [_build._nvcc(), *_build.NVCC_FLAGS]
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as ex:
        libs = dict(zip(todo, ex.map(build, [nvcc] * len(todo), todo,
                                     [t for t, _ in todo.values()])))

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    codes = torch.randint(0, N * K, (M,), generator=g, device=dev)
    deliver = torch.rand(M, generator=g, device=dev) < 0.9
    enc = torch.where(deliver, codes, N * K).int()
    tgt_row = torch.where(deliver, codes // K, N).int()
    msg, k_old = (torch.randn(M, P, generator=g, device=dev)
                  for _ in range(2))
    theta0, base = (torch.randn(N, P, generator=g, device=dev)
                    for _ in range(2))
    Ke0 = torch.randn(N * K, P + 1, generator=g, device=dev)
    a_w = torch.rand(N * K, generator=g, device=dev)
    got0 = torch.rand(N, generator=g, device=dev) < 0.5
    want = gossip_round_step(theta0.clone(), Ke0.clone(), got0.clone(), msg,
                             tgt_row, enc, k_old, base, a_w)

    def time_ms(fn, iters=50):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        t1.synchronize()
        return t0.elapsed_time(t1) / iters

    ucodes = torch.unique(codes)
    rows = (codes // K).clamp(max=N - 1)
    rows132 = torch.randn(ucodes.numel(), P + 1, device=dev)
    rows128 = torch.randn(ucodes.numel(), P, device=dev)
    Ke_s = Ke0.clone()                  # scattered into; Ke0 stays as drawn
    K128 = torch.randn(N * K, P, device=dev)
    torch_calls = {
        "theta.index_select(0, rows): 200k random 128 B rows": (
            lambda: theta0.index_select(0, rows)),
        "Ke.index_select(0, slots): 200k random 132 B rows": (
            lambda: Ke0.index_select(0, ucodes)),
        "Ke.index_copy_(0, slots, .): 200k random 132 B rows": (
            lambda: Ke_s.index_copy_(0, ucodes, rows132)),
        "K128.index_copy_(0, slots, .): 200k random 128 B rows": (
            lambda: K128.index_copy_(0, ucodes, rows128)),
    }
    for rep in range(2):
        for name, lib_path in libs.items():
            lib = ctypes.CDLL(str(lib_path))
            fn = lib.repro_round_step
            fn.argtypes = list(_build.SIGNATURES["repro_round_step"])
            theta, Ke, got = theta0.clone(), Ke0.clone(), got0.clone()
            words = torch.zeros(N * K + 2, dtype=torch.int64, device=dev)
            keep = torch.empty(M, dtype=torch.bool, device=dev)
            ptrs = [t.data_ptr() for t in (theta, Ke, got, msg, k_old,
                                           tgt_row, enc, base, a_w, words,
                                           keep)]

            def call():
                err = fn(*ptrs, M, N, K, P,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            call()
            torch.cuda.synchronize()
            exact = None
            if todo[name][1]:
                exact = all(torch.equal(a, b) for a, b in
                            zip((theta, Ke, got, keep), want))
                if not exact:
                    raise AssertionError(f"{name}: differs from the plain "
                                         f"version")
            print(json.dumps(dict(variant=name, run=rep,
                                  ms=time_ms(call), bit_for_bit=exact)),
                  flush=True)
            del theta, Ke, got, words
        for name, torch_call in torch_calls.items():
            print(json.dumps(dict(torch_call=name, run=rep,
                                  ms=time_ms(torch_call))), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
