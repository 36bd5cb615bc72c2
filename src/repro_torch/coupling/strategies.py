"""The paper's algorithms as cross-agent coupling strategies (counterpart
of ``repro.coupling.strategies``, one device).

Every leaf of a parameter tree carries a leading agent axis A.  After the
agents' local optimizer steps, a strategy mixes the leaves across it:

  mode="none"       solitary training (paper Eq. 1 baseline)
  mode="consensus"  the uniform average over agents (Eq. 2 baseline)
  mode="mp"         model propagation: one Eq. (5) iterate,
                    ``A_mix @ theta + b_anchor * theta_sol`` per leaf,
                    anchored at a solitary snapshot (paper §3), through
                    the ``mix`` op (``kernels.dispatch``): on a CUDA
                    device the ``graph_mix`` kernel's agent-axis form,
                    one launch a leaf
  mode="cl"         collaborative learning: a gradient step on the Q_CL
                    smoothness term (paper §4)

Two schedules realise the same mp operator (DESIGN.md §2):

  schedule="dense"   the ``mix`` op over the whole agent axis (above)
  schedule="gossip"  the paper's pairwise exchanges: the graph is
                     edge-coloured into matchings
                     (``CouplingState.send_to``) and ``sum_j A_mix[i, j]
                     theta_j`` is accumulated one matching at a time, self
                     term first, over a sim mesh of agents
                     (``launch.sim_mesh``): on a ``LocalMesh`` each
                     matching is a gather of the agent-stacked leaves; on
                     a ``DistMesh`` each rank holds one agent's leaves and
                     each matching is one send and one receive.

Over a mesh of one agent a rank (``mesh.kind == "dist"``: a ``DistMesh``,
or ``launch.mesh.AgentMesh``, the agent axes of a production mesh whose
leaves are tensor-parallel ``DTensor``s) the dense schedule all-gathers
the agents' leaves and mixes this rank's row; the gossip schedule moves
each leaf's local tensor-parallel shard, one exchange a matching, never
an all-gather (the JAX package's ``param_specs`` under ``shard_map``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.graph import Graph
from repro_torch.kernels.dispatch import ReproBackend, resolve
from repro_torch.models.common import like_local, split_local
from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class CouplingConfig:
    mode: str = "mp"              # none | consensus | mp | cl
    schedule: str = "dense"       # dense | gossip
    alpha: float = 0.99           # MP trade-off (mu = (1-alpha)/alpha)
    mu: float = 0.01              # CL trade-off
    rho: float = 1.0              # ADMM penalty
    every: int = 1                # apply every k optimizer steps
    use_kernel: bool = False      # force the "mix" op's CUDA kernel
    mix_dtype: Any = torch.float32   # the type the agents' leaves mix in
    # kernels.dispatch.ReproBackend choosing the "mix" implementation
    # (None = auto: the CUDA kernel for CUDA tensors)
    backend: Optional[ReproBackend] = None

    def mix_backend(self) -> Optional[ReproBackend]:
        if self.backend is not None:
            return self.backend
        if self.use_kernel:
            return ReproBackend.using(mix="cuda")
        return None


@dataclasses.dataclass
class CouplingState:
    """Per-run mixing operators on the agents' device.

    ``send_to`` (M, A) holds each matching round's partner of every agent
    (-1 = idle), the schedule of the gossip form, as host data.
    """
    A_mix: torch.Tensor           # (A, A)  diag(alpha/(alpha+abar c)) P
    b_anchor: torch.Tensor        # (A,)    abar c / (alpha + abar c)
    W: torch.Tensor               # (A, A)  raw weights (cl)
    send_to: tuple = ()


def mp_matrices(graph: Graph, confidences, alpha: float):
    """Eq. (5) as out = A_mix @ theta + b_anchor * theta_sol (float32
    numpy, computed in float64)."""
    c = np.asarray(confidences, np.float64)
    abar = 1.0 - alpha
    denom = alpha + abar * c
    A_mix = (alpha / denom)[:, None] * np.asarray(graph.P)
    b = abar * c / denom
    return A_mix.astype(np.float32), b.astype(np.float32)


def make_state(graph: Graph, confidences=None, alpha: float = 0.99,
               device=None) -> CouplingState:
    """The mixing operators of ``graph`` on ``device`` (CUDA when None);
    unit confidences when None."""
    device = resolve_device(device)
    n = graph.n
    if confidences is None:
        confidences = np.ones(n)
    A_mix, b = mp_matrices(graph, confidences, alpha)
    matchings = graph.edge_coloring()
    send_to = np.full((len(matchings), n), -1, np.int32)
    for m, pairs in enumerate(matchings):
        for (i, j) in pairs:
            send_to[m, i] = j  # scatter: unique targets (a matching)
            send_to[m, j] = i  # scatter: unique targets (a matching)
    return CouplingState(
        A_mix=torch.as_tensor(A_mix, device=device),
        b_anchor=torch.as_tensor(b, device=device),
        W=torch.as_tensor(graph.W, dtype=torch.float32, device=device),
        send_to=tuple(map(tuple, send_to.tolist())))


# ---------------------------------------------------------------------------
# Mixing operators over (A, ...) stacked trees, one leaf at a time
# ---------------------------------------------------------------------------


def _mp_leaf(leaf, sol, state: CouplingState, cfg: CouplingConfig):
    n = leaf.shape[0]
    mix = resolve("mix", cfg.mix_backend(), leaf.device)
    # the kernel takes contiguous operands; the one-agent-a-rank form
    # passes its agent's anchor expanded over the agents
    out = mix(leaf.reshape(n, -1).to(cfg.mix_dtype),
              sol.reshape(n, -1).to(cfg.mix_dtype).contiguous(),
              state.A_mix.to(cfg.mix_dtype), state.b_anchor)
    return out.reshape(leaf.shape).to(leaf.dtype)


def _consensus_leaf(leaf, cfg: CouplingConfig):
    mean = torch.mean(leaf.to(cfg.mix_dtype), dim=0, keepdim=True,
                      dtype=torch.float32)
    return mean.expand(leaf.shape).to(leaf.dtype)


def _laplacian_leaf(leaf, state: CouplingState, cfg: CouplingConfig,
                    lr: float):
    n = leaf.shape[0]
    W = state.W.to(cfg.mix_dtype)
    deg = W.sum(dim=1, dtype=torch.float32)
    lf = leaf.to(cfg.mix_dtype)
    nbr = (W.float() @ lf.reshape(n, -1).float()).reshape(leaf.shape)
    grad = 2.0 * (deg.reshape((-1,) + (1,) * (leaf.dim() - 1)) * lf - nbr)
    return (lf - lr * grad).to(leaf.dtype)


def dense_mix_tree(params, solitary, state: CouplingState,
                   cfg: CouplingConfig):
    """out = A_mix @ theta + b * theta_sol per leaf, through the ``mix``
    op resolved for the leaves' device from ``cfg.mix_backend()``.  Leaves
    and A_mix are quantized to ``cfg.mix_dtype``; b stays float32; the
    sums are float32 and the result is cast back to the leaf's dtype."""
    return tree_map(lambda leaf, sol: _mp_leaf(leaf, sol, state, cfg),
                    params, solitary)


def _gossip_leaf(leaf, sol, state: CouplingState, cfg: CouplingConfig,
                 mesh):
    """One leaf of the gossip schedule: the self term, then one matching
    at a time, then the anchor, each product in float32 (the JAX form's
    float32 weights against ``cfg.mix_dtype`` leaves)."""
    f = torch.float32
    x = leaf.to(cfg.mix_dtype)
    if mesh.kind == "local":
        A = leaf.shape[0]
        if A != mesh.n_shards:
            raise ValueError(f"gossip: {A} agents on a mesh of "
                             f"{mesh.n_shards} shards (one agent a shard)")
        bshape = (A,) + (1,) * (leaf.dim() - 1)
        agents = torch.arange(A, device=leaf.device)
        acc = state.A_mix.diagonal().reshape(bshape) * x.to(f)
        for partner in state.send_to:
            if max(partner) < 0:
                continue
            pv = torch.as_tensor(partner, device=leaf.device).long()
            has = pv >= 0
            src = pv.clamp(min=0)
            recv = torch.where(has.reshape(bshape), x[src],
                               torch.zeros_like(x))
            w = torch.where(has, state.A_mix[agents, src], 0.0)
            acc = acc + w.reshape(bshape) * recv.to(f)
        anchored = state.b_anchor.reshape(bshape) * sol.to(cfg.mix_dtype) \
            .to(f)
        return (acc + anchored).to(leaf.dtype)
    i = mesh.rank
    acc = state.A_mix[i, i] * x.to(f)
    for partner in state.send_to:
        if max(partner) < 0:
            continue
        j = partner[i]
        if j >= 0:
            recv, w = mesh.exchange_with(x, j), state.A_mix[i, j]
        else:
            recv, w = torch.zeros_like(x), state.A_mix.new_zeros(())
        acc = acc + w * recv.to(f)
    anchored = state.b_anchor[i] * sol.to(cfg.mix_dtype).to(f)
    return (acc + anchored).to(leaf.dtype)


def _dist_dense_leaf(leaf, sol, cfg: CouplingConfig, mesh, op):
    """One leaf of the dense schedule over a mesh of one agent a rank:
    the agents' (1, ...) leaves all-gathered to (A, ...) (sent in
    ``cfg.mix_dtype``, which the operators quantize to first), the mode's
    stacked operator ``op`` over them, this rank's row kept.  A
    ``DTensor`` leaf mixes its local tensor-parallel shard: the operators
    mix each coordinate across agents only."""
    local, like = split_local(leaf)
    blocks = mesh.all_gather(local.to(cfg.mix_dtype)).to(local.dtype)
    # the anchor enters row i only, so every row may see this agent's
    # (a view; the mp operator makes it whole for the kernel)
    sols = split_local(sol)[0].expand(blocks.shape)
    i = mesh.rank
    return like_local(op(blocks, sols)[i:i + 1], like)


def gossip_mix_tree(params, solitary, state: CouplingState,
                    cfg: CouplingConfig, mesh):
    """The dense operator as matching-scheduled exchanges over ``mesh``:
    accumulates ``sum_j A_mix[i, j] theta_j`` one matching at a time, no
    all-gather.  On a ``LocalMesh`` the leaves are agent-stacked (A, ...)
    with A the mesh's shard count; on a ``DistMesh`` each rank's leaves are
    its own agent's (1, ...), the agent id being the rank."""
    return tree_map(lambda leaf, sol: _gossip_leaf(leaf, sol, state, cfg,
                                                   mesh),
                    params, solitary)


def consensus_mean_tree(params, cfg: CouplingConfig):
    """The uniform average over the agent axis (Eq. 2 baseline), summed in
    float32."""
    return tree_map(lambda leaf: _consensus_leaf(leaf, cfg), params)


def laplacian_pull_tree(params, state: CouplingState, cfg: CouplingConfig,
                        lr: float):
    """CL smoothness-term gradient step (paper §4 objective):

        theta_i <- theta_i - lr * 2 sum_j W_ij (theta_i - theta_j)

    the gradient of sum_{i<j} W_ij ||theta_i - theta_j||^2, the neighbor
    sums in float32."""
    return tree_map(lambda leaf: _laplacian_leaf(leaf, state, cfg, lr),
                    params)


# ---------------------------------------------------------------------------
# Strategy factory
# ---------------------------------------------------------------------------


def make_coupling(cfg: CouplingConfig, state: CouplingState, mesh=None):
    """Returns ``apply(params, solitary, step) -> params``.

    ``schedule="gossip"`` (mode "mp") runs the matchings over ``mesh``
    (required; see :func:`gossip_mix_tree`).  Given a mesh of one agent a
    rank (``mesh.kind == "dist"``), the dense schedule of every mode
    all-gathers the agents' leaves over it and runs the mode's stacked
    operator, the ``mix`` op included (:func:`_dist_dense_leaf`).

    On steps where ``step % cfg.every == 0`` it mixes ``params``; on the
    others it returns them unchanged (the JAX package computes the mix and
    selects the old value: the same values).  The JAX package returns new
    arrays; here each leaf's mix is written into the leaf in place, one
    leaf at a time, so at most one leaf's mix is held besides the tree.
    """
    gossip = cfg.mode == "mp" and cfg.schedule == "gossip"
    if gossip and mesh is None:
        raise ValueError("gossip schedule needs a mesh")
    if cfg.mode == "none":
        return lambda params, solitary, step: params
    if gossip:
        def mix(leaf, sol):
            return _gossip_leaf(leaf, sol, state, cfg, mesh)
    elif cfg.mode == "consensus":
        def mix(leaf, sol):
            return _consensus_leaf(leaf, cfg)
    elif cfg.mode == "cl":
        def mix(leaf, sol):
            # lr folded into mu: proximal step size on the smoothness term
            return _laplacian_leaf(leaf, state, cfg, cfg.mu)
    elif cfg.mode == "mp":
        def mix(leaf, sol):
            return _mp_leaf(leaf, sol, state, cfg)
    else:
        raise ValueError(f"unknown coupling mode {cfg.mode!r}")
    if not gossip and mesh is not None and mesh.kind == "dist":
        stacked = mix

        def mix(leaf, sol):
            return _dist_dense_leaf(leaf, sol, cfg, mesh, stacked)

    def apply(params, solitary, step):
        if int(step) % cfg.every == 0:
            for leaf, sol in zip(tree_leaves(params),
                                 tree_leaves(solitary)):
                leaf.copy_(mix(leaf, sol))
        return params
    return apply
