"""``sparse_gather_mix``: the CSR model-propagation sweep over
padded-neighbor tables,
``out[i] = b[i] * sol[i] + sum_s w[i, s] * table[idx[i, s]]``.

The CUDA kernel (``csrc/sparse_mix.cu``: one warp per output row, the
rows taken in an optional locality order, all of a row's slot gathers in
flight at once) replaces the Pallas TPU kernel
``repro/kernels/sparse_mix.py::sparse_gather_mix``.  Beside it sits the
plain PyTorch version (``kernels.ref.sparse_gather_mix``, the same
slot-order sum, so the two agree bit for bit in any row order), which runs
for tensors on the CPU only: for CUDA tensors the wrapper launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import sparse_gather_mix as sparse_gather_mix_plain

#: Kernel launches made by :func:`sparse_gather_mix` in this process.
launches = 0

#: Of those, the launches given a row order.
ordered_launches = 0


def _check_order(order, table, n):
    if order is None:
        return
    if order.device != table.device:
        raise ValueError(f"sparse_gather_mix: order on {order.device}, "
                         f"table on {table.device}")
    if order.dtype != torch.int32:
        raise TypeError(f"sparse_gather_mix: order must be torch.int32, "
                        f"got {order.dtype}")
    if tuple(order.shape) != (n,):
        raise ValueError(f"sparse_gather_mix: order has shape "
                         f"{tuple(order.shape)}, expected {(n,)}")
    if not order.is_contiguous():
        raise ValueError("sparse_gather_mix: order must be contiguous")


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


def sparse_gather_mix(table, idx, w, b, sol, *, order=None):
    """table: (N, p) with N >= 1; idx: (n, k) int32 row ids into table;
    w: (n, k) with w = 0 at pad slots; b: (n,); sol: (n, p) -> (n, p).

    ``order``, an (n,) int32 permutation of ``range(n)`` on the table's
    device (``SparseTopology.locality_order``), is the order in which the
    kernel takes the rows; the result does not depend on it.  Its dtype,
    shape and device are checked; that it is a permutation is not (that
    would cost a host sync a call).  The output row count follows
    ``idx``/``sol``; the table may hold more rows than are mixed.  CUDA
    tensors launch the kernel; CPU tensors take the plain version.
    """
    global launches, ordered_launches
    _check_order(order, table, idx.shape[0])
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
                  sol.data_ptr(), None if order is None else order.data_ptr(),
                  out.data_ptr(), table.shape[0], n, k, p,
                  device=table.device)
    launches += 1
    ordered_launches += order is not None
    return out
