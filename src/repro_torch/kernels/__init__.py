"""Hand-written CUDA kernels for Hopper (built from ``csrc/`` on first
use), their plain PyTorch versions, the oracles, and the dispatch registry
that chooses between them per device."""

from . import dispatch, ref
from .dispatch import BackendUnavailable, ReproBackend, resolve

__all__ = ["dispatch", "ref", "ReproBackend", "resolve",
           "BackendUnavailable"]
