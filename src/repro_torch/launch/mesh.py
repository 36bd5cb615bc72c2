"""Production meshes (counterpart of ``repro.launch.mesh``; DESIGN.md §4).

A production mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over
the process group that is initialised: 16 x 16 ("data", "model") devices
a pod, or 2 x 16 x 16 ("pod", "data", "model") for two pods.  Agents are
laid out over ("pod", "data"), one agent a row of the mesh, and each
agent's model is tensor-parallel over "model".  The dry run builds it on
torch's ``fake`` backend (one process standing for every rank); a real
launch builds it on NCCL.  A mesh is passed explicitly wherever it is
used: there is no ambient mesh.

:class:`AgentMesh` is the agent sub-mesh of a production mesh in the form
the coupling strategies take a mesh (``coupling.make_coupling``): one
agent a rank, leaves ``(1, ...)`` whose tensor-parallel shards stay
where they are.
"""

from __future__ import annotations

import torch

from repro_torch.launch.sharding import agent_axes_of
from repro_torch.models.common import like_local, split_local


def _device_type() -> str:
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """16 x 16 = 256 devices a pod; 2 pods = 512 devices when
    ``multi_pod``.  The world size of the initialised process group must
    be the mesh's size; ``device_type`` defaults to "cuda" under NCCL and
    "cpu" otherwise."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_debug_mesh(n_agents: int = 4, model: int = 2, *,
                    multi_pod: bool = False, device_type=None):
    """A small mesh for tests: (n_agents, model) ("data", "model"), or
    (2, n_agents, model) with a "pod" axis."""
    if multi_pod:
        return make_mesh((2, n_agents, model), ("pod", "data", "model"),
                         device_type)
    return make_mesh((n_agents, model), ("data", "model"), device_type)


def make_mesh(shape, axes, device_type=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialised
    process group."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=tuple(axes))


def axis_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def n_agents_of(mesh) -> int:
    sizes = axis_sizes(mesh)
    return sizes.get("pod", 1) * sizes.get("data", 1)


def agent_group(mesh):
    """The process group of this device's peers across the agent axes
    (the devices holding the same tensor-parallel shard of every agent),
    its ranks in agent order."""
    dims = agent_axes_of(mesh)
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    return mesh[dims]._flatten().get_group()


@torch.library.custom_op("repro_torch::exchange", mutates_args=())
def exchange(x: torch.Tensor, group_name: str, peer: int) -> torch.Tensor:
    """Send ``x`` to global rank ``peer`` of the named process group and
    receive its tensor of the same shape: one point-to-point exchange, an
    operator of its own so that a dispatch-level recorder (the dry run's)
    sees it; on ``meta`` tensors it moves nothing and returns an empty
    tensor like ``x``."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    group = _resolve_process_group(group_name)
    recv = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, peer, group),
           dist.P2POp(dist.irecv, recv, peer, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


@exchange.register_fake
def _(x, group_name, peer):
    return torch.empty_like(x)


class AgentMesh:
    """The agent axes of a production mesh as a one-agent-a-rank mesh
    (``kind="dist"``, as ``launch.sim_mesh.DistMesh``): ``rank`` is this
    device's agent, ``n_shards`` the number of agents.  ``all_gather`` and
    ``exchange_with`` move each leaf's local tensor-parallel shard across
    the agent axes only, and rewrap it with the leaf's placements."""

    kind = "dist"

    def __init__(self, mesh):
        import torch.distributed as dist
        self._dist = dist
        self.mesh = mesh
        self.group = agent_group(mesh)
        self.n_shards = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)

    def all_gather(self, x):
        """(1, ...) this agent's leaf -> (A, ...) every agent's, local
        shards gathered over the agent axes."""
        ops = torch.ops._c10d_functional
        local, like = split_local(x)
        out = ops.wait_tensor(ops.all_gather_into_tensor(
            local.contiguous(), self.n_shards, self.group.group_name))
        return like_local(out, like)

    def exchange_with(self, x, partner: int):
        """Swap this agent's leaf with agent ``partner``'s: one send and
        one receive of the local shard (the ``repro_torch::exchange``
        op), nothing else."""
        local, like = split_local(x)
        peer = self._dist.get_global_rank(self.group, partner)
        recv = torch.ops.repro_torch.exchange(local.contiguous(),
                                              self.group.group_name, peer)
        return like_local(recv, like)

    def __repr__(self):
        return f"AgentMesh(n_agents={self.n_shards}, agent={self.rank})"
