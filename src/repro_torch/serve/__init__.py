"""Serving (counterpart of ``repro.serve``): the batched decode engine
with slot-based continuous batching, and the gossip-backed
personalization service over an agent-state store."""

from .engine import CollabServeEngine, Engine, ServeConfig, sample_token
from .store import (AgentStateStore, CommittedState, MixedModelCache,
                    ServeReport, ShardedAgentStateStore)

__all__ = ["ServeConfig", "Engine", "sample_token", "AgentStateStore",
           "CollabServeEngine", "CommittedState", "MixedModelCache",
           "ServeReport", "ShardedAgentStateStore"]
