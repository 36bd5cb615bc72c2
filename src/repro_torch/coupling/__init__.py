"""Coupling: the paper's algorithms as cross-agent strategies over
agent-stacked parameter trees (counterpart of ``repro.coupling``)."""

from .strategies import (CouplingConfig, CouplingState, consensus_mean_tree,
                         dense_mix_tree, gossip_mix_tree,
                         laplacian_pull_tree, make_coupling, make_state,
                         mp_matrices)

__all__ = ["CouplingConfig", "CouplingState", "make_coupling", "make_state",
           "mp_matrices", "dense_mix_tree", "gossip_mix_tree",
           "consensus_mean_tree", "laplacian_pull_tree"]
