"""Personalized training: per-agent local steps and cross-agent coupling
(counterpart of ``repro.train.trainer``).

``make_train_step`` builds the step the training loop runs:

  1. the batch (B, ...) is split over the agent axis into (A, B/A, ...);
  2. each agent's loss and gradient, through autograd over the agent's
     slice of the stacked parameters (a loop over agents: each gradient
     is its own loss's, as under the JAX package's ``vmap``);
  3. AdamW (``optim.adamw_update_``), clipped by the global norm over all
     agents' gradients together — the JAX package clips the stacked tree,
     and the port keeps that;
  4. the solitary anchor's EMA, in float32, cast back;
  5. the coupling strategy (none / consensus / mp / cl) across the agent
     axis, on steps where ``step % every == 0``.

The JAX package's state is immutable and each step returns a new one.
Here the step writes parameters, moments and the anchor in place, a
leaf (or a slab of one) at a time, so that training an agent-stacked
model of billions of parameters holds one copy of each: the values are
the JAX package's.  ``TrainState.solitary`` is a copy of the parameters
from the start (the JAX package's first state shares the arrays).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.coupling import CouplingConfig, CouplingState, make_coupling
from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
from repro_torch.optim.adamw import adamw_update_, slabs
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    n_agents: int
    steps: int = 100
    optimizer: AdamWConfig = AdamWConfig()
    coupling: CouplingConfig = CouplingConfig(mode="mp")
    anchor_ema: float = 0.99       # solitary-anchor EMA rate
    log_every: int = 10


@dataclasses.dataclass
class TrainState:
    params: Any          # agent-stacked (A, ...) tree
    opt_state: Any       # {"m", "v": trees like params, "count": int32 ()}
    solitary: Any        # MP anchor tree (same structure)
    step: torch.Tensor   # int32 () on the CPU


def stack_params(params, n_agents: int, perturb: float = 0.0,
                 generator: Optional[torch.Generator] = None):
    """Replicate base params across agents (a copy each), optionally
    de-correlated by ``perturb * normal`` drawn from ``generator`` leaf
    by leaf."""
    stacked = tree_map(lambda leaf: leaf[None].expand(
        (n_agents,) + tuple(leaf.shape)).clone(), params)
    if perturb and generator is not None:
        for leaf in tree_leaves(stacked):
            leaf.add_(perturb * torch.randn(leaf.shape, generator=generator,
                                            device=leaf.device,
                                            dtype=leaf.dtype))
    return stacked


def init_train_state(model, tcfg: TrainConfig, generator: torch.Generator,
                     perturb: float = 0.0, device=None) -> TrainState:
    """Agent-stacked copies of ``model.init_params(generator, device)``,
    zero moments, the anchor a copy of the parameters, step 0."""
    params = stack_params(model.init_params(generator, device),
                          tcfg.n_agents, perturb, generator)
    return TrainState(params=params,
                      opt_state=adamw_init(params, tcfg.optimizer),
                      solitary=tree_map(torch.clone, params),
                      step=torch.zeros((), dtype=torch.int32))


def _split_batch(batch: Dict, A: int, device) -> Dict:
    """(B, ...) leaves -> (A, B/A, ...); others broadcast over agents.
    ``positions3`` (3, B, S) has its batch on axis 1: -> (A, 3, B/A, S)."""
    def split(v):
        if v.dim() >= 1 and v.shape[0] % A == 0 and v.shape[0] >= A:
            return v.reshape((A, v.shape[0] // A) + tuple(v.shape[1:]))
        return v[None].expand((A,) + tuple(v.shape))

    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(v, device=device)
        out[k] = split(v.movedim(0, 1)).movedim(2, 1) \
            if k == "positions3" else split(v)
    return out


def make_train_step(model, tcfg: TrainConfig,
                    coupling_state: CouplingState, mesh=None) -> Callable:
    """Returns ``train_step(state, batch, mark=None) -> (state, metrics)``.

    ``batch`` leaves are (A * b, ...); metrics are ``loss`` (the agents'
    mean), ``loss_per_agent`` (A,), ``grad_norm``, ``ce`` and ``aux``
    (means), tensors on the parameters' device.  ``mark(name)``, when
    given, is called as each phase ends: ``forward_backward``, ``adamw``,
    ``ema``, ``coupling``.  The state is updated in place and returned.
    ``mesh`` (a ``launch.sim_mesh`` mesh of the agents) serves the gossip
    coupling schedule.
    """
    A = tcfg.n_agents
    couple = make_coupling(tcfg.coupling, coupling_state, mesh=mesh)
    ema = tcfg.anchor_ema
    f32 = torch.float32

    def train_step(state: TrainState, batch, mark=None):
        leaves, treedef = tree_flatten(state.params)
        device = leaves[0].device
        batch_a = _split_batch(batch, A, device)
        losses, ces, auxes, grads = [], [], [], []
        for a in range(A):
            mine = [leaf[a].detach().requires_grad_() for leaf in leaves]
            with torch.enable_grad():
                loss, metrics = model.loss(
                    tree_unflatten(treedef, mine),
                    {k: v[a] for k, v in batch_a.items()})
                grads.append(torch.autograd.grad(loss, mine))
            losses.append(loss.detach())
            ces.append(metrics["ce"].detach())
            auxes.append(metrics["aux"].detach())
        if mark:
            mark("forward_backward")
        lr_scale = cosine_schedule(state.step, tcfg.steps,
                                   warmup=max(1, min(100, tcfg.steps // 10)))
        ms, vs = (tree_leaves(state.opt_state[k]) for k in ("m", "v"))
        by_agent = [(leaf[a], grads[a][q], ms[q][a], vs[q][a])
                    for q, leaf in enumerate(leaves) for a in range(A)]
        state.opt_state["count"], gnorm = adamw_update_(
            *map(list, zip(*by_agent)), state.opt_state["count"],
            tcfg.optimizer, lr_scale)
        del grads, by_agent
        if mark:
            mark("adamw")
        # solitary anchor: EMA of each agent's own trajectory
        for s, p in zip(tree_leaves(state.solitary), leaves):
            for s_, p_ in slabs(s, p):
                s_.copy_(ema * s_.to(f32) + (1 - ema) * p_.to(f32))
        if mark:
            mark("ema")
        couple(state.params, state.solitary, state.step)
        if mark:
            mark("coupling")
        state.step = state.step + 1
        loss = torch.stack(losses)
        return state, {"loss": loss.mean(), "loss_per_agent": loss,
                       "grad_norm": gnorm, "ce": torch.stack(ces).mean(),
                       "aux": torch.stack(auxes).mean()}

    return train_step


def train_loop(model, tcfg: TrainConfig, coupling_state: CouplingState,
               batches, generator: Optional[torch.Generator] = None,
               state: Optional[TrainState] = None, device=None,
               log: Callable[[str], None] = print):
    """Run ``tcfg.steps`` steps (or as many as ``batches`` holds) from
    ``state``, or from ``init_train_state`` with ``generator`` (seed 0
    when None) on ``device`` (CUDA when None).  Returns ``(state,
    history)``: the scalar metrics as floats on every ``log_every``-th
    step and the last."""
    if state is None:
        device = resolve_device(device)
        generator = generator or torch.Generator(device=device).manual_seed(0)
        state = init_train_state(model, tcfg, generator, device=device)
    step_fn = make_train_step(model, tcfg, coupling_state)
    history = []
    t0 = time.time()
    for i, batch in enumerate(batches):
        if i >= tcfg.steps:
            break
        state, metrics = step_fn(state, batch)
        if i % tcfg.log_every == 0 or i == tcfg.steps - 1:
            m = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
            history.append({"step": i, **m})
            log(f"step {i:5d} loss {m['loss']:.4f} "
                f"ce {m['ce']:.4f} gnorm {m['grad_norm']:.2f} "
                f"({time.time() - t0:.1f}s)")
    return state, history
