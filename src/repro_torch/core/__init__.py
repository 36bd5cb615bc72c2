"""Core: graphs, padded-neighbor tables and model propagation (paper §3)."""

from .graph import (Graph, as_torch, gaussian_kernel_graph,
                    knn_graph_from_similarity, random_geometric_graph,
                    ring_graph, two_moons)
from .losses import (AgentData, confidences_from_counts, pad_datasets,
                     solitary_mean)
from .model_propagation import (closed_form, label_propagation,
                                mp_mix_operator, mp_objective, synchronous)
from .sparse import (DeviceTables, NeighborTables, batched_model_update,
                     live_slots, neighbor_aggregate, padded_neighbor_tables,
                     record_chunks, tables_from_adjacency, to_device)

__all__ = [n for n in dir() if not n.startswith("_")]
