"""``graph_mix``: the dense model-propagation step (paper Eq. 5),
``out = A @ theta + b[:, None] * theta_sol``.

The CUDA kernel (``csrc/graph_mix.cu``: 3xTF32 on the tensor cores with
``mma.sync``, operands split into TF32 hi and lo in registers so that the
result keeps float32 accuracy, a 3-stage ``cp.async`` pipeline, the anchor
fused into the epilogue) replaces the Pallas TPU kernel
``repro/kernels/graph_mix.py::graph_mix``; the source note there says what
bounds it on the H100 and how the design answers that.  Beside it sits the
plain PyTorch version (``kernels.ref.graph_mix``), which runs for tensors
on the CPU only: for CUDA tensors the wrapper launches the kernel or
raises.
"""

from __future__ import annotations

import torch

from . import _build
from .ref import graph_mix as graph_mix_plain

#: Kernel launches made by :func:`graph_mix` in this process.
launches = 0


def _check(theta, theta_sol, A, b):
    n, D = theta.shape
    want = {"theta": (theta, (n, D)), "theta_sol": (theta_sol, (n, D)),
            "A": (A, (n, n)), "b": (b, (n,))}
    for name, (t, shape) in want.items():
        if t.device != theta.device:
            raise ValueError(f"graph_mix: {name} on {t.device}, theta on "
                             f"{theta.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"graph_mix: {name} must be float32, got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"graph_mix: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"graph_mix: {name} must be contiguous")


def graph_mix(theta, theta_sol, A, b):
    """theta, theta_sol: (n, D); A: (n, n); b: (n,) -> (n, D), float32.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    global launches
    if theta.device.type == "cpu":
        return graph_mix_plain(theta, theta_sol, A, b)
    if theta.device.type != "cuda":
        raise ValueError(f"graph_mix: no kernel for {theta.device}")
    _check(theta, theta_sol, A, b)
    n, D = theta.shape
    out = torch.empty_like(theta)
    _build.launch("repro_graph_mix", A.data_ptr(), theta.data_ptr(),
                  theta_sol.data_ptr(), b.data_ptr(), out.data_ptr(),
                  n, D, device=theta.device)
    launches += 1
    return out
