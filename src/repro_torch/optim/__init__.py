"""Optimizers (counterpart of ``repro.optim``)."""

from .adamw import (AdamWConfig, adamw_init, adamw_rows, adamw_update,
                    cosine_schedule)

__all__ = ["AdamWConfig", "adamw_init", "adamw_rows", "adamw_update",
           "cosine_schedule"]
