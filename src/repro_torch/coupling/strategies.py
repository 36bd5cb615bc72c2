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

The JAX package's ``schedule="gossip"`` runs the same operator as
matching-scheduled collective permutes inside ``shard_map`` over a device
mesh; it waits for the multi-GPU slice (ROADMAP queue 1 item 10) and
raises here.  The matchings (``CouplingState.send_to``) are kept, so a
state built here is the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.graph import Graph
from repro_torch.kernels.dispatch import ReproBackend, resolve
from repro_torch.tree import tree_leaves, tree_map

GOSSIP_LATER = ("schedule='gossip' needs a device mesh (collective "
                "permutes between the agents' devices): it waits for "
                "ROADMAP queue 1 item 10 (multi-GPU); use "
                "schedule='dense'")


@dataclasses.dataclass(frozen=True)
class CouplingConfig:
    mode: str = "mp"              # none | consensus | mp | cl
    schedule: str = "dense"       # dense | gossip (item 10)
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
    out = mix(leaf.reshape(n, -1).to(cfg.mix_dtype),
              sol.reshape(n, -1).to(cfg.mix_dtype),
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


def gossip_mix_tree(params, solitary, state: CouplingState,
                    cfg: CouplingConfig, axis_names=()):
    """The dense operator as matching-scheduled exchanges between the
    agents' devices: not ported (ROADMAP queue 1 item 10)."""
    raise NotImplementedError(GOSSIP_LATER)


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


def make_coupling(cfg: CouplingConfig, state: CouplingState):
    """Returns ``apply(params, solitary, step) -> params``.

    On steps where ``step % cfg.every == 0`` it mixes ``params``; on the
    others it returns them unchanged (the JAX package computes the mix and
    selects the old value: the same values).  The JAX package returns new
    arrays; here each leaf's mix is written into the leaf in place, one
    leaf at a time, so at most one leaf's mix is held besides the tree.
    """
    if cfg.mode == "mp" and cfg.schedule == "gossip":
        raise NotImplementedError(GOSSIP_LATER)
    if cfg.mode == "none":
        return lambda params, solitary, step: params
    if cfg.mode == "consensus":
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

    def apply(params, solitary, step):
        if int(step) % cfg.every == 0:
            for leaf, sol in zip(tree_leaves(params),
                                 tree_leaves(solitary)):
                leaf.copy_(mix(leaf, sol))
        return params
    return apply
