"""Build and load the CUDA kernels of ``kernels/csrc/`` on first use.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``), one ``nvcc`` process per
source started together, and the objects are linked into one shared
library with a plain C interface.  The library lives under
``<repo>/build/kernels/<hash>/``, keyed by a hash of the sources and
flags, so an edited source
rebuilds and an unchanged one loads the cached library.  It is loaded with
``ctypes``; every entry point declares its ``argtypes`` (``c_void_p`` for
pointers and the CUDA stream, ``c_int`` for sizes — ``c_longlong`` for one
that may pass 2^31 —, ``c_float`` for scalars) and returns ``cudaGetLastError()``, which :func:`launch` turns
into an exception.

Nothing here runs at import time: the CPU-only tests import every module
of the package on hosts without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
L = ctypes.c_longlong
#: C entry points and their argument types (pointers, sizes, scalars,
#: stream last for those that launch).
SIGNATURES = {
    # A, theta, sol, b, out, T, n, D, stream
    "repro_graph_mix": (P, P, P, P, P, I, I, I, P),
    # A, theta, sol, b, out, T, n, D (long long), is_bf16, stream
    "repro_graph_mix_agents": (P, P, P, P, P, I, I, L, I, P),
    # table, idx, w, b, sol, order (or NULL), out, N, n, k, p, stream
    "repro_sparse_gather_mix": (P,) * 7 + (I,) * 4 + (P,),
    # theta, Ke, got_ever, msg, k_old, tgt_row, enc, theta_base, a_w,
    # words, keep, m, n, k, p, stream
    "repro_round_step": (P,) * 11 + (I,) * 4 + (P,),
    # k, p, out (int[2]): no stream, called directly, not through launch()
    "repro_round_step_attrs": (I, I, P),
    # theta, K, Z_own, Z_nbr, L_own, L_nbr, pay_th, pay_K, pay_Lo, pay_Ln,
    # upd, own_s, oth_a, oth_s, stale, got, flags, E, k, p, rho, stream
    "repro_cl_edge_step": (P,) * 17 + (I, I, I, F, P),
    # t_ii, t_ji, t_jj, t_ij, l_own_i, l_nbr_j_of_i, l_own_j, l_nbr_i_of_j,
    # z_i, z_j and the four dual outputs, E, p, rho, stream
    "repro_admm_edge": (P,) * 14 + (I, I, F, P),
    # q, k, v, o, B, S, H, KH, hd, window, is_bf16, scale, stream
    "repro_flash_attention": (P,) * 4 + (I,) * 7 + (F, P),
    # hd, is_bf16, out (int[3]): no stream, called directly
    "repro_flash_attention_attrs": (I, I, P),
}

_lock = threading.Lock()
_lib = None
build_seconds = None   # wall time of the build that loaded the library


BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "the machine with the card (CUDA toolkit "
                           "under $CUDA_HOME or on PATH)")
    return found


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return srcs, digest.hexdigest()[:16]


def _compile(out: pathlib.Path, srcs) -> None:
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for src in srcs:                  # one nvcc per source, all at once
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failed = []
        for src, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode:
                failed.append(f"{src.name}:\n{log.decode(errors='replace')}")
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        lib = pathlib.Path(tmp) / out.name
        subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                        "-o", str(lib)], check=True)
        os.replace(lib, out)              # atomic: readers never see half


def library() -> ctypes.CDLL:
    """The kernel library, built from ``csrc/`` on first call."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            srcs, key = _sources()
            out = BUILD_ROOT / key / "librepro_kernels.so"
            if not out.exists():
                out.parent.mkdir(parents=True, exist_ok=True)
                _compile(out, srcs)
            lib = ctypes.CDLL(str(out))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
            build_seconds = time.perf_counter() - t0
        return _lib


def launch(name: str, *args, device: torch.device) -> None:
    """Call C entry ``name`` with ``args`` on torch's current stream of
    ``device``; raise if the launch reported a CUDA error."""
    stream = torch.cuda.current_stream(device).cuda_stream
    err = getattr(library(), name)(*args, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({torch.cuda.get_device_name(device)})")
