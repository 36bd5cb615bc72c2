"""Personalized LM training: the train step and loop, and checkpoints
(counterpart of ``repro.train``)."""

from .checkpoint import load_checkpoint, save_checkpoint
from .trainer import (TrainConfig, TrainState, init_train_state,
                      make_train_step, stack_params, train_loop)

__all__ = ["TrainConfig", "TrainState", "init_train_state",
           "make_train_step", "stack_params", "train_loop",
           "save_checkpoint", "load_checkpoint"]
