"""``graph_mix``: the dense model-propagation step (paper Eq. 5),
``out = A @ theta + b[:, None] * theta_sol``, for one problem or for T
trials at once along an optional leading axis (the sweeps' trial axis: one
launch for all trials).

The CUDA kernel (``csrc/graph_mix.cu``: 3xTF32 on the tensor cores with
``mma.sync``, operands split into TF32 hi and lo in registers and each
8-deep step's partial sums added to the accumulator in IEEE float32, so
that the result keeps float32 accuracy over long runs, a 3-stage
``cp.async`` pipeline, the anchor fused into the epilogue; for narrow
models, D <= 8, an FFMA kernel that streams A's rows, 16 lanes a row, with
many 16-byte loads in flight and theta staged in shared memory) replaces
the Pallas TPU kernel
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


#: The most trials one launch takes (CUDA's grid z limit).
MAX_TRIALS = 65535


def _check(theta, theta_sol, A, b):
    if theta.dim() not in (2, 3):
        raise ValueError(f"graph_mix: theta must be (n, D) or (T, n, D), "
                         f"got {tuple(theta.shape)}")
    lead, (n, D) = tuple(theta.shape[:-2]), theta.shape[-2:]
    if lead and not 0 < lead[0] <= MAX_TRIALS:
        raise ValueError(f"graph_mix: {lead[0]} trials; one launch takes "
                         f"1 to {MAX_TRIALS}")
    want = {"theta": (theta, lead + (n, D)),
            "theta_sol": (theta_sol, lead + (n, D)),
            "A": (A, lead + (n, n)), "b": (b, lead + (n,))}
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
    """theta, theta_sol: (T?, n, D); A: (T?, n, n); b: (T?, n) ->
    (T?, n, D), float32; the leading trial axis is optional.

    CUDA tensors launch the kernel, once for all trials; CPU tensors take
    the plain version.
    """
    global launches
    if theta.device.type == "cpu":
        return graph_mix_plain(theta, theta_sol, A, b)
    if theta.device.type != "cuda":
        raise ValueError(f"graph_mix: no kernel for {theta.device}")
    _check(theta, theta_sol, A, b)
    n, D = theta.shape[-2:]
    trials = theta.shape[0] if theta.dim() == 3 else 1
    out = torch.empty_like(theta)
    _build.launch("repro_graph_mix", A.data_ptr(), theta.data_ptr(),
                  theta_sol.data_ptr(), b.data_ptr(), out.data_ptr(),
                  trials, n, D, device=theta.device)
    launches += 1
    return out
