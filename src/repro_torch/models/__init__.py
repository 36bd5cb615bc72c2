"""Decoder model stack, dense family (counterpart of ``repro.models``)."""

from .common import ModelConfig
from .model import Model

__all__ = ["ModelConfig", "Model"]
