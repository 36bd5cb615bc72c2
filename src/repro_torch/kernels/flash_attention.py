"""``flash_attention``: causal, optionally sliding-window attention with
grouped kv heads, ``(q (B, S, H, hd), k, v (B, S, K, hd), *, window) ->
(B, S, H, hd)``.

The CUDA kernel (``csrc/flash_attention.cu``) replaces the Pallas TPU
kernel ``repro/kernels/flash_attention.py::flash_attention``, at head dims
64, 128 and 256 (RecurrentGemma's).  In bf16 it runs on the tensor cores
by ``wgmma``, Q, K and V brought in by TMA, with the online softmax in
registers and the weights P rounded to bf16 once per kv tile (the JAX
oracle ``repro.kernels.ref.flash_attention`` rounds them too): at head
dim 128, one block of two warpgroups per (batch * head, 128-query tile),
128-key tiles through a 2-stage ring; at head dims 256 and 64, a
warp-specialised kernel with two consumer warpgroups, separate K and V
rings and a tile's softmax under the previous tile's P V: at 256 a
producer warpgroup hands its registers to the consumers, which own 64
query rows each, take turns on the tensor cores and walk 80-key tiles; at
64 the consumers share a 64-query tile and split its 64-key tiles, merged
at the end, two blocks an SM.
In float32 it runs 3xTF32 on the tensor cores (``wgmma``) at every head
dim: every operand and the softmax weights split into a TF32 hi and lo,
a . b ~ a_hi b_hi + (a_lo b_hi + a_hi b_lo), each kv tile's products
summed from zero and added to O in IEEE float32, which keeps the float32
bar of 1e-5; one block per (batch * head, 64-query tile) whose producer
threads load, split and transpose V into shared memory for one consumer
warpgroup, 64-key tiles.  At head dims 64 and 128 K and V have rings of
their own; at 256 Q's hi and lo stay in shared memory, K and V^T
stream through one ring in 32-column pieces of the head dim, and P's lo
goes through shared memory to its one product.  Every
kernel reads the kv heads in place and never loads a fully masked kv
tile; the source note says what bounds each on the H100 and how the
design answers that.
Beside it sits the plain PyTorch version (``kernels.ref.flash_attention``),
which runs for tensors on the CPU only: for CUDA tensors the wrapper
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import flash_attention as flash_attention_plain

#: Kernel launches made by :func:`flash_attention` in this process.
launches = 0

#: S must be a multiple (the float32 kernels' query tile; the bf16
#: kernel's 128-query tiles at head dims 128 and 256 may end half full).
BLOCK = 64
HEAD_DIMS = (64, 128, 256)
DTYPES = (torch.bfloat16, torch.float32)


def _check(q, k, v, window):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention: q and k must be (B, S, H, hd), "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    B, S, H, hd = q.shape
    K = k.shape[2]
    if tuple(k.shape) != (B, S, K, hd) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k and v must be (B, S, K, hd) "
                         f"= {(B, S, K, hd)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if K < 1 or H % K:
        raise ValueError(f"flash_attention: {K} kv heads do not divide "
                         f"{H} query heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if S % BLOCK or S == 0:
        raise ValueError(f"flash_attention: S = {S} is not a positive "
                         f"multiple of {BLOCK}")
    if B * H > 65535:
        raise ValueError(f"flash_attention: B * H = {B * H} > 65535")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"flash_attention: {name} is {t.dtype}; q, k "
                            f"and v must share one of {DTYPES}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned")


def flash_attention(q, k, v, *, window=None):
    """q: (B, S, H, hd); k, v: (B, S, K, hd) with K | H -> (B, S, H, hd)
    in q's dtype (``kernels.ref.flash_attention``).

    CUDA tensors launch the kernel (bf16 or float32, hd in {64, 128, 256},
    S % 64 == 0, else it raises; float32 runs 3xTF32 on the tensor cores,
    within 1e-5 of the plain version); CPU tensors take the plain
    version.
    """
    global launches
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    _check(q, k, v, window)
    B, S, H, hd = q.shape
    out = torch.empty_like(q)
    _build.launch("repro_flash_attention", q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), B, S, H, k.shape[2], hd,
                  0 if window is None else int(window),
                  int(q.dtype == torch.bfloat16), float(hd ** -0.5),
                  device=q.device)
    launches += 1
    return out


def flash_attention_resources(hd: int, dtype) -> dict:
    """Registers and local memory bytes (spills included) a thread of the
    kernel that :func:`flash_attention` launches for head dim ``hd`` and
    ``dtype``, as the CUDA runtime reports them
    (``cudaFuncGetAttributes``), and the blocks of it an SM holds at its
    launch shape (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    out = (ctypes.c_int * 3)()
    err = _build.library().repro_flash_attention_attrs(
        hd, int(dtype == torch.bfloat16), ctypes.addressof(out))
    if err:
        raise RuntimeError(f"repro_flash_attention_attrs: CUDA error {err}")
    return {"registers": out[0], "local_bytes": out[1],
            "blocks_per_sm": out[2]}
