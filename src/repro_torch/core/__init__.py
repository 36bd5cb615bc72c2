"""Core: graphs, padded-neighbor tables, model propagation (paper §3),
collaborative learning by ADMM (paper §4) with pluggable primal solvers,
and joint learning of the collaboration graph."""

from .collaborative import (ADMMState, CLTrace, async_admm, cl_objective,
                            direct_minimize, init_state, sync_admm)
from .consensus import consensus_mean, consensus_model
from .graph import (Graph, angular_kernel_graph, as_torch,
                    gaussian_kernel_graph, knn_graph_from_similarity,
                    random_geometric_graph, ring_graph, two_moons)
from .graph_learning import (DEAD_DISTANCE, GraphRecovery,
                             cluster_edge_recovery, learned_weight_tables,
                             prune_rows, reweight_rows, slot_sq_distances)
from .losses import (LOSSES, AgentData, confidences_from_counts,
                     guarded_loss, hinge_loss, local_stats, logistic_loss,
                     masked_sum, pad_datasets, quadratic_loss, solitary_gd,
                     solitary_mean, total_loss)
from .model_propagation import (AsyncTrace, async_gossip, closed_form,
                                label_propagation, mp_mix_operator,
                                mp_objective, synchronous)
from .primal import (ExactQuadraticPrimal, InexactPrimal, flat_predictor,
                     solitary_adamw)
from .sparse import (DeviceTables, NeighborTables, admm_edge_halfstep,
                     agent_model_update, batched_admm_primal,
                     batched_model_update, live_slots, neighbor_aggregate,
                     padded_neighbor_tables, personalized_predict,
                     quadratic_primal_core, record_chunks, sample_event,
                     tables_from_adjacency, to_device, wakeups)

__all__ = [n for n in dir() if not n.startswith("_")]
