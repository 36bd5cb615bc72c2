"""PyTorch/CUDA port of the collaborative-learning system (``repro``).

Module names mirror the JAX package (``repro_torch.core.graph`` is the
counterpart of ``repro.core.graph`` and so on); inside them the code is
plain PyTorch: functions on tensors, an explicit ``device=`` argument and
an explicit ``torch.Generator`` wherever something is drawn.  The hot
loops run hand-written CUDA kernels for Hopper (``repro_torch.kernels``).

Entry points run on the CUDA card unless the caller passes another device:
``device=None`` resolves to ``"cuda"`` and raises when CUDA is absent — a
run never drops to the CPU without being asked to.

This package imports neither ``jax`` nor ``repro``; it keeps its own copy
of what it needs from the JAX package.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device a run uses: ``device`` as given, or CUDA when it is None.

    Raises ``RuntimeError`` for ``device=None`` on a host without CUDA —
    pass ``device="cpu"`` to run the plain PyTorch paths there.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the CUDA card by default and CUDA is not "
            "available here; pass device='cpu' to run on the CPU")
    return torch.device("cuda")
