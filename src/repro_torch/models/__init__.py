"""Decoder model stack, dense family, and the flat-row agent models
(counterpart of ``repro.models``)."""

from .common import ModelConfig
from .flatten import LoRAAgent, MLPAgent, ParamFlattener
from .model import Model

__all__ = ["LoRAAgent", "MLPAgent", "Model", "ModelConfig",
           "ParamFlattener"]
