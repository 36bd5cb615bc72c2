"""1-D agent meshes for partitioned network simulation (counterpart of
``repro.launch.sim_mesh``; DESIGN.md §11).

The network simulator shards the *agent* axis: a mesh of P shards, each
holding one block of the agent graph, all running the same per-shard
round body and exchanging halo models between event batches.  The JAX
package gets P devices into one process with XLA's fake host devices and
runs the body under ``shard_map``.  A card cannot host two NCCL ranks, so
the port has two mesh forms over one round body written along a leading
shard axis ``S``:

* :class:`LocalMesh` — all P shards in this process on one device, state
  stacked ``(P, m, ...)`` (S = P).  A collective is a tensor op along the
  shard axis: ``all_gather`` is the stacked boundary buffer itself, one
  ring step a roll of it by one shard.
* :class:`DistMesh` — one shard a process over ``torch.distributed``
  (S = 1): gloo for CPU processes, NCCL across GPUs.  ``all_gather`` is
  ``dist.all_gather_into_tensor`` (``dist.all_gather`` under gloo); a
  ring step is ``dist.batch_isend_irecv`` to shard ``(q + 1) % P`` from
  ``(q - 1) % P`` — the JAX ring's ``ppermute`` with
  ``[(s, (s + 1) % P)]``.

``make_sim_mesh`` returns a :class:`DistMesh` over the default process
group when one is initialised, else a :class:`LocalMesh`.  Meshes made
without ``device=`` live on the CUDA card and raise where there is none.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device

AGENT_AXIS = "shards"

EXCHANGES = ("all_gather", "ring")


class LocalMesh:
    """``n_shards`` shards in this process on ``device`` (CUDA when None),
    stacked along a leading shard axis."""

    kind = "local"

    def __init__(self, n_shards: int, device=None):
        if int(n_shards) < 1:
            raise ValueError(f"a mesh needs at least one shard, got "
                             f"{n_shards}")
        self.n_shards = int(n_shards)
        self.device = resolve_device(device)

    @property
    def local_shards(self) -> int:
        """Shards held by this process (S)."""
        return self.n_shards

    @property
    def first_shard(self) -> int:
        """Global id of this process's first shard."""
        return 0

    def local(self, x):
        """This process's rows of a (P, ...) per-shard table."""
        return x

    def all_gather(self, x):
        """(S, ...) per-shard blocks -> (P, ...) blocks of every shard."""
        return x

    def ring_shift(self, x):
        """One ring step: shard q receives shard ``(q - 1) % P``'s block."""
        return torch.roll(x, 1, dims=0)

    def __repr__(self):
        return f"LocalMesh(n_shards={self.n_shards}, device={self.device})"


class DistMesh:
    """One shard a process over a ``torch.distributed`` process group
    (``group=None``: the default group); this process's tensors live on
    ``device`` (CUDA when None)."""

    kind = "dist"

    def __init__(self, group=None, device=None):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("DistMesh needs an initialised process group "
                               "(torch.distributed.init_process_group)")
        self._dist = dist
        self.group = group if group is not None else dist.group.WORLD
        self.n_shards = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.device = resolve_device(device)
        self.backend = dist.get_backend(self.group)

    @property
    def local_shards(self) -> int:
        """Shards held by this process (S = 1)."""
        return 1

    @property
    def first_shard(self) -> int:
        """Global id of this process's shard (its rank in the group)."""
        return self.rank

    def local(self, x):
        """This process's row of a (P, ...) per-shard table."""
        return x[self.rank:self.rank + 1]

    def _peer(self, q: int) -> int:
        return self._dist.get_global_rank(self.group, q % self.n_shards)

    def all_gather(self, x):
        """(1, ...) this shard's block -> (P, ...) blocks of every shard."""
        dist = self._dist
        x = x.contiguous()
        if self.backend == "nccl":
            out = x.new_empty((self.n_shards,) + tuple(x.shape[1:]))
            dist.all_gather_into_tensor(out, x, group=self.group)
            return out
        outs = [torch.empty_like(x) for _ in range(self.n_shards)]
        dist.all_gather(outs, x, group=self.group)
        return torch.cat(outs)

    def ring_shift(self, x):
        """One ring step: send to shard ``(q + 1) % P``, receive from
        ``(q - 1) % P``."""
        dist = self._dist
        x = x.contiguous()
        recv = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, self._peer(self.rank + 1),
                          self.group),
               dist.P2POp(dist.irecv, recv, self._peer(self.rank - 1),
                          self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    def exchange_with(self, x, partner: int):
        """Swap ``x`` with shard ``partner`` (one send, one receive)."""
        dist = self._dist
        x = x.contiguous()
        recv = torch.empty_like(x)
        peer = self._peer(partner)
        ops = [dist.P2POp(dist.isend, x, peer, self.group),
               dist.P2POp(dist.irecv, recv, peer, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv

    def __repr__(self):
        return (f"DistMesh(n_shards={self.n_shards}, rank={self.rank}, "
                f"backend={self.backend}, device={self.device})")


def make_sim_mesh(n_shards: Optional[int] = None, device=None):
    """The simulator's mesh: a :class:`DistMesh` over the default process
    group when one is initialised (``n_shards`` must then be None or the
    world size), else a :class:`LocalMesh` of ``n_shards`` shards (None:
    1, as a one-device JAX process gets) on ``device`` (CUDA when None)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size()
        if n_shards is not None and int(n_shards) != world:
            raise ValueError(f"n_shards={n_shards} but the process group "
                             f"has {world} ranks (one shard a rank)")
        return DistMesh(device=device)
    return LocalMesh(1 if n_shards is None else n_shards, device)


def mesh_shards(mesh) -> int:
    """Shard count of a sim mesh (size of its agent axis)."""
    return int(mesh.n_shards)


_CURRENT = []


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the one the sharded dispatch implementations
    (``reference_sharded``, ``cuda_sharded``) run on inside the block."""
    _CURRENT.append(mesh)
    try:
        yield mesh
    finally:
        _CURRENT.pop()


def current_mesh(device=None):
    """The mesh set by :func:`use_mesh`, else ``make_sim_mesh`` on
    ``device``."""
    return _CURRENT[-1] if _CURRENT else make_sim_mesh(device=device)


@dataclasses.dataclass(frozen=True)
class HaloCodec:
    """Wire format for the boundary rows a shard publishes each round.

    Three codecs, all decoding to float32 on the receiving shard so every
    accumulation downstream stays float32:

    ``f32``
        Identity: the bit-for-bit parity anchor.
    ``bf16``
        Rows cast to bfloat16 on the wire (half the bytes; relative
        round-trip error <= 2^-8).
    ``int8``
        Per-row symmetric int8: each trailing-axis vector ships as int8
        codes plus one float32 scale ``max|row| / 127`` (about a quarter
        of the bytes; per-row relative error <= 2^-6).  ``x / scale`` is
        taken in float32 and rounded half to even; zero rows get scale
        1.0, so they round-trip exactly.
    """

    name: str = "f32"

    NAMES = ("f32", "bf16", "int8")

    def __post_init__(self):
        if self.name not in self.NAMES:
            raise ValueError(
                f"unknown halo codec {self.name!r}; one of {self.NAMES}")

    @property
    def is_identity(self) -> bool:
        """Whether the wire carries the float32 rows themselves."""
        return self.name == "f32"

    def encode(self, x):
        """float32 rows -> tuple of wire tensors (payload, then scales)."""
        if self.name == "f32":
            return (x,)
        if self.name == "bf16":
            return (x.to(torch.bfloat16),)
        amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
        scale = torch.where(amax > 0, amax / 127.0,
                            torch.ones_like(amax)).to(torch.float32)
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        return (q, scale)

    def decode(self, parts):
        """Tuple of wire tensors -> float32 rows."""
        if self.name == "f32":
            return parts[0]
        if self.name == "bf16":
            return parts[0].to(torch.float32)
        q, scale = parts
        return q.to(torch.float32) * scale

    def row_nbytes(self, row_shape) -> int:
        """Wire bytes for one boundary row of the given trailing shape."""
        elems = int(math.prod(row_shape))
        if self.name == "f32":
            return 4 * elems
        if self.name == "bf16":
            return 2 * elems
        # int8 codes + one f32 scale per trailing-axis vector
        return elems + 4 * (elems // int(row_shape[-1]))


def resolve_halo_codec(codec: Union[str, HaloCodec, None]) -> HaloCodec:
    """Normalize a codec spec (name, instance, or None -> f32)."""
    if codec is None:
        return HaloCodec("f32")
    if isinstance(codec, HaloCodec):
        return codec
    return HaloCodec(str(codec))


def halo_exchange_fn(bnd_pos, halo_src_shard, halo_src_pos, n_halo: int,
                     mesh, exchange: str = "all_gather",
                     codec: Union[str, HaloCodec, None] = None):
    """Build the halo exchange of the partitioned simulators.

    ``bnd_pos`` (P, B) and ``halo_src_shard`` / ``halo_src_pos`` (P, H)
    are a ``GraphPartition``'s per-shard tables (numpy or tensors).
    Returns ``run(x)`` mapping this process's shard-stacked local rows
    ``x (S, m, ...)`` to the extended buffers ``[local | halo (H, ...) |
    zero row]`` of shape ``(S, m + H + 1, ...)``: each shard publishes its
    boundary rows ``x[q, bnd_pos[q]]`` and pulls its halo from the
    gathered boundary buffers — ``all_gather`` by default, or a P-1-step
    ring (``exchange="ring"``).  ``run.fill(ext, m)`` does the same into
    a buffer whose local rows ``ext[:, :m]`` are already written.  Any
    trailing shape works: the MP engine exchanges (m, p) model rows, the
    CL-ADMM engine (m, 1 + 3k, p) stacked payloads.

    ``codec`` selects the :class:`HaloCodec` wire format: boundary rows
    are encoded before the collective and decoded to float32 after the
    halo rows are selected.  With no halo (``n_halo == 0``) the exchange
    is skipped.
    """
    if exchange not in EXCHANGES:
        raise ValueError(f"unknown halo exchange {exchange!r}; one of "
                         f"{EXCHANGES}")
    codec = resolve_halo_codec(codec)
    dev = mesh.device
    P_ = mesh.n_shards
    H = int(n_halo)

    def table(a):
        return mesh.local(torch.as_tensor(np.asarray(a), device=dev).long())

    bnd, hsrc, hpos = (table(a) for a in (bnd_pos, halo_src_shard,
                                          halo_src_pos))
    S = bnd.shape[0]
    shard = torch.arange(S, device=dev)[:, None]
    q_ids = mesh.first_shard + torch.arange(S, device=dev)

    def fill(ext, m: int):
        ext[:, m + H] = 0  # scatter: unique targets (one row a shard)
        if H == 0:
            return ext
        wire = codec.encode(ext[shard, bnd])          # (S, B, ...)
        if exchange == "ring":
            halo = torch.zeros((S, H) + tuple(ext.shape[2:]),
                               dtype=ext.dtype, device=dev)
            bcast = (S, H) + (1,) * (ext.dim() - 2)
            bufs = wire
            for step in range(1, P_):
                bufs = tuple(mesh.ring_shift(b) for b in bufs)
                src = (q_ids - step) % P_
                mask = (hsrc == src[:, None]).reshape(bcast)
                rows = codec.decode(tuple(b[shard, hpos] for b in bufs))
                halo = torch.where(mask, rows, halo)
        else:
            allb = tuple(mesh.all_gather(b) for b in wire)   # (P, B, ...)
            halo = codec.decode(tuple(b[hsrc, hpos] for b in allb))
        ext[:, m:m + H] = halo
        return ext

    def run(x):
        m = x.shape[1]
        ext = x.new_empty((x.shape[0], m + H + 1) + tuple(x.shape[2:]))
        ext[:, :m] = x
        return fill(ext, m)

    run.fill = fill
    return run


def halo_payload_bytes(n_shards: int, boundary_size: int, row_nbytes: int,
                       halo_size: int) -> int:
    """Bytes published per halo exchange across the whole mesh.

    Every shard publishes its ``boundary_size`` boundary rows each
    exchange, whichever rows its neighbors read, so the wire cost is
    ``P * B * row_nbytes`` — zero when the partition has no halo, in which
    case the engines skip the exchange.  ``row_nbytes`` is the wire size
    of one boundary row (``HaloCodec.row_nbytes``).
    """
    if halo_size == 0:
        return 0
    return int(n_shards) * int(boundary_size) * int(row_nbytes)


def shard_read_route(owner, local_pos, users):
    """Route per-user state reads to the owning shard's store.

    ``owner`` / ``local_pos`` are a ``GraphPartition``'s (n,) tables
    (agent a lives at row ``local_pos[a]`` of shard ``owner[a]``'s
    block).  Returns the ``(shard, pos)`` int32 arrays of a batch of user
    ids: reads go to the one shard that owns the user's row, never
    through a gathered global copy (DESIGN.md §16).
    """
    users = np.asarray(users, np.int64)
    return (np.asarray(owner, np.int32)[users],
            np.asarray(local_pos, np.int32)[users])
