"""Sparse event-driven network simulator: model propagation, CL-ADMM
and joint collaboration-graph learning."""

from .topology import (SparseTopology, cluster_topology,
                       planted_partition_topology, random_geometric_topology,
                       ring_topology)
from .scheduler import (EventBatch, EventStream, NetworkConditions,
                        ServeStream, churn_step, draw_events, draw_slots,
                        draw_wakeups, precompute_event_stream,
                        precompute_serve_stream, serve_chunk_requests,
                        straggler_rates, stream_totals)
from .engines import (CLSimTrace, JointSimTrace, SimTrace, SparseADMMState,
                      SparseCLTrace, SparseTrace, init_sparse_admm,
                      run_cl_scenario, run_joint_scenario, run_mp_scenario,
                      sparse_async_admm, sparse_async_gossip,
                      sparse_sync_mp)
from .partition import (GraphPartition, JointShardedTrace, ShardedSimTrace,
                        block_partition, default_local_batch,
                        default_local_events, edge_cut, greedy_partition,
                        run_cl_scenario_sharded, run_joint_scenario_sharded,
                        run_mp_scenario_sharded)
from .spec import ScenarioSpec, run_scenario
from .scenarios import SCENARIOS, Scenario, get_scenario, list_scenarios

from repro_torch.launch.sim_mesh import HaloCodec, resolve_halo_codec

__all__ = [n for n in dir() if not n.startswith("_")]
