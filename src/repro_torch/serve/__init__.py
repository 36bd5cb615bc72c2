"""Serving: the batched decode engine with slot-based continuous batching
(counterpart of ``repro.serve``; the gossip-backed personalization
service waits for the scenario-API slice)."""

from .engine import Engine, ServeConfig, sample_token

__all__ = ["ServeConfig", "Engine", "sample_token"]
