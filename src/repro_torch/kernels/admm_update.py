"""``admm_edge_update``: the fused CL-ADMM Z + dual update over a batch of
edges (paper §4.2 steps 2-3): eight (E, p) slabs in, six out.

The CUDA kernel (``csrc/admm_edge.cu``, one grid-stride pass over the
E*p elements) replaces the Pallas TPU kernel
``repro/kernels/admm_update.py::admm_edge_update``.  Beside it sits the
plain PyTorch version (``kernels.ref.admm_edge_update``: the same
operations in the same order, so the two agree bit for bit), which runs
for tensors on the CPU only; for CUDA tensors the wrapper launches the
kernel or raises.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import admm_edge_update as admm_edge_update_plain

#: Kernel launches made by :func:`admm_edge_update` in this process.
launches = 0

_NAMES = ("t_ii", "t_ji", "t_jj", "t_ij", "l_own_i", "l_nbr_j_of_i",
          "l_own_j", "l_nbr_i_of_j")


def _check(args):
    ref = args[0]
    if ref.dim() != 2:
        raise ValueError(f"admm_edge_update: inputs must be (E, p), got "
                         f"{tuple(ref.shape)}")
    for name, t in zip(_NAMES, args):
        if t.device != ref.device:
            raise ValueError(f"admm_edge_update: {name} on {t.device}, "
                             f"t_ii on {ref.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"admm_edge_update: {name} must be "
                            f"torch.float32, got {t.dtype}")
        if t.shape != ref.shape:
            raise ValueError(f"admm_edge_update: {name} has shape "
                             f"{tuple(t.shape)}, expected {tuple(ref.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"admm_edge_update: {name} must be contiguous")


def admm_edge_update(t_ii, t_ji, t_jj, t_ij, l_own_i, l_nbr_j_of_i,
                     l_own_j, l_nbr_i_of_j, *, rho: float):
    """Eight (E, p) float32 slabs -> ``(z_i, z_j, l_own_i', l_nbr_j_of_i',
    l_own_j', l_nbr_i_of_j')`` (``kernels.ref.admm_edge_update``).

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    global launches
    args = (t_ii, t_ji, t_jj, t_ij, l_own_i, l_nbr_j_of_i, l_own_j,
            l_nbr_i_of_j)
    if t_ii.device.type == "cpu":
        return admm_edge_update_plain(*args, rho)
    if t_ii.device.type != "cuda":
        raise ValueError(f"admm_edge_update: no kernel for {t_ii.device}")
    _check(args)
    E, p = t_ii.shape
    outs = tuple(torch.empty_like(t_ii) for _ in range(6))
    _build.launch("repro_admm_edge", *(t.data_ptr() for t in args + outs),
                  E, p, float(rho), device=t_ii.device)
    launches += 1
    return outs
