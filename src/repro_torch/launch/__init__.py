"""Launch: the simulator's agent meshes (counterpart of ``repro.launch``;
the production train/serve meshes and the dry-run tooling are not ported
yet)."""

from .sim_mesh import (AGENT_AXIS, DistMesh, HaloCodec, LocalMesh,
                       current_mesh, halo_exchange_fn, halo_payload_bytes,
                       make_sim_mesh, mesh_shards, resolve_halo_codec,
                       shard_read_route, use_mesh)

__all__ = [n for n in dir() if not n.startswith("_")]
