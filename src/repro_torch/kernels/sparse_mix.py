"""``sparse_gather_mix``: the CSR model-propagation sweep over
padded-neighbor tables,
``out[i] = b[i] * sol[i] + sum_s w[i, s] * table[idx[i, s]]``.

The CUDA kernel (``csrc/sparse_mix.cu``, one warp per output row) replaces
the Pallas TPU kernel ``repro/kernels/sparse_mix.py::sparse_gather_mix``.
Beside it sits the plain PyTorch version (``kernels.ref.sparse_gather_mix``,
the same slot-order sum, so the two agree bit for bit), which runs for
tensors on the CPU only: for CUDA tensors the wrapper launches the kernel
or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import sparse_gather_mix as sparse_gather_mix_plain

#: Kernel launches made by :func:`sparse_gather_mix` in this process.
launches = 0


def _check(table, idx, w, b, sol):
    n, k = idx.shape
    p = table.shape[1]
    want = {"table": (table, torch.float32, None),
            "idx": (idx, torch.int32, (n, k)),
            "w": (w, torch.float32, (n, k)),
            "b": (b, torch.float32, (n,)),
            "sol": (sol, torch.float32, (n, p))}
    for name, (t, dtype, shape) in want.items():
        if t.device != table.device:
            raise ValueError(f"sparse_gather_mix: {name} on {t.device}, "
                             f"table on {table.device}")
        if t.dtype != dtype:
            raise TypeError(f"sparse_gather_mix: {name} must be {dtype}, "
                            f"got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"sparse_gather_mix: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"sparse_gather_mix: {name} must be "
                             f"contiguous")
    if table.dim() != 2 or table.shape[0] < 1:
        raise ValueError(f"sparse_gather_mix: table must be (N, p), got "
                         f"{tuple(table.shape)}")


def sparse_gather_mix(table, idx, w, b, sol):
    """table: (N, p) with N >= 1; idx: (n, k) int32 row ids into table;
    w: (n, k) with w = 0 at pad slots; b: (n,); sol: (n, p) -> (n, p).

    The output row count follows ``idx``/``sol``; the table may hold more
    rows than are mixed.  CUDA tensors launch the kernel; CPU tensors take
    the plain version.
    """
    global launches
    if table.device.type == "cpu":
        return sparse_gather_mix_plain(table, idx, w, b, sol)
    if table.device.type != "cuda":
        raise ValueError(f"sparse_gather_mix: no kernel for {table.device}")
    _check(table, idx, w, b, sol)
    n, k = idx.shape
    p = table.shape[1]
    out = torch.empty((n, p), dtype=torch.float32, device=table.device)
    _build.launch("repro_sparse_gather_mix", table.data_ptr(),
                  idx.data_ptr(), w.data_ptr(), b.data_ptr(),
                  sol.data_ptr(), out.data_ptr(), n, k, p,
                  device=table.device)
    launches += 1
    return out
