"""Launch (counterpart of ``repro.launch``): the simulator's agent meshes
(``sim_mesh``), the production ("pod", "data", "model") meshes
(``mesh``), the sharding specs' assembly (``sharding``), the assigned
input shapes (``shapes``), the cost model on H100 constants (``cost``,
the counterpart of ``hlo_analysis``) and the dry run on torch's fake
process group (``dryrun``: ``python -m repro_torch.launch.dryrun``).

``use_mesh`` here is the sim mesh's: a production ``DeviceMesh`` is passed
explicitly wherever it is used."""

from .mesh import (AgentMesh, make_debug_mesh, make_production_mesh,
                   n_agents_of)
from .sim_mesh import (AGENT_AXIS, DistMesh, HaloCodec, LocalMesh,
                       current_mesh, halo_exchange_fn, halo_payload_bytes,
                       make_sim_mesh, mesh_shards, resolve_halo_codec,
                       shard_read_route, use_mesh)

__all__ = [n for n in dir() if not n.startswith("_")]
