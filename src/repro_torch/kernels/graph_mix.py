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
many 16-byte loads in flight and theta staged in shared memory; for few
agents, n <= 32 and D > 8 — the LM coupling's shape, one launch a
parameter leaf — an FFMA kernel that keeps A and b in shared memory and
streams theta and sol once, in float32 or bf16) replaces the Pallas TPU
kernel
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
#: The agent-axis form: at most this many agents, models wider than
#: ``SMALL_D``; the only form that also takes bf16 operands.
AGENT_MAX, SMALL_D = 32, 8


def agent_axis(n: int, D: int) -> bool:
    """Whether an (n, D) problem takes the agent-axis kernel."""
    return n <= AGENT_MAX and D > SMALL_D


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
    # float32 everywhere, or (the agent-axis form) theta, theta_sol and A
    # all float32 or all bf16 with b float32
    wide = theta.dtype if agent_axis(n, D) and theta.dtype in (
        torch.float32, torch.bfloat16) else torch.float32
    for name, (t, shape) in want.items():
        if t.device != theta.device:
            raise ValueError(f"graph_mix: {name} on {t.device}, theta on "
                             f"{theta.device}")
        dtype = torch.float32 if name == "b" else wide
        if t.dtype != dtype:
            raise TypeError(
                f"graph_mix: {name} must be {dtype}, got {t.dtype} (bf16 "
                f"operands: n <= {AGENT_MAX} and D > {SMALL_D} only)"
                if wide == torch.float32 else
                f"graph_mix: {name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"graph_mix: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"graph_mix: {name} must be contiguous")


def graph_mix(theta, theta_sol, A, b):
    """theta, theta_sol: (T?, n, D); A: (T?, n, n); b: (T?, n) ->
    (T?, n, D) in theta's dtype; the leading trial axis is optional.
    Float32, or for n <= 32 and D > 8 theta, theta_sol and A in bf16 (b
    float32); the sums are float32.

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
    ptrs = [t.data_ptr() for t in (A, theta, theta_sol, b, out)]
    if agent_axis(n, D):
        _build.launch("repro_graph_mix_agents", *ptrs, trials, n, D,
                      int(theta.dtype == torch.bfloat16),
                      device=theta.device)
    else:
        _build.launch("repro_graph_mix", *ptrs, trials, n, D,
                      device=theta.device)
    launches += 1
    return out


def bf16_tolerance(theta, theta_sol, A, b):
    """Elementwise bound on ``|kernel - plain|`` for bf16 operands: one
    bf16 ulp of the plain (float32-computed, cast) result, plus ``n *
    2**-24`` of the float32 sum of the terms' magnitudes — the two sum in
    float32 in different orders, and where terms cancel the sums' last
    bits are many ulps of a small result."""
    f = torch.float32
    want = graph_mix_plain(theta, theta_sol, A, b).to(f)
    _, ex = torch.frexp(want)
    ulp = torch.ldexp(torch.ones_like(want), ex - 8)
    mag = A.to(f).abs() @ theta.to(f).abs() \
        + (b.to(f)[..., None] * theta_sol.to(f)).abs()
    return ulp + theta.shape[-2] * 2.0 ** -24 * mag
