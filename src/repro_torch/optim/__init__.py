"""Optimizers (counterpart of ``repro.optim``)."""

from .adamw import (AdamWConfig, adamw_init, adamw_rows, adamw_update,
                    adamw_update_, cosine_schedule)

__all__ = ["AdamWConfig", "adamw_init", "adamw_rows", "adamw_update",
           "adamw_update_", "cosine_schedule"]
