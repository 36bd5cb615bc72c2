"""AdamW for personalized (agent-stacked) parameter trees (counterpart of
``repro.optim.adamw``).

Parameters, gradients and moments are tensors or trees of them (nested
dicts, tuples and lists; ``repro_torch.tree``).  The moments are kept in
``moment_dtype`` (bf16 by default, as in the JAX package) and the update
math runs in float32, in the JAX package's order of operations: bias
terms ``1 - b**count`` in float32, an optional clip by the global norm,
decoupled weight decay.  Adam is elementwise, so agent-stacked leaves
need no special handling.

:func:`adamw_update_` updates in place over flat lists of tensors, a
slab of at most ``CHUNK`` elements at a time, so that an update of a
model of billions of parameters holds no full-size float32 temporaries
(the LM trainer's path); :func:`adamw_update` runs it on copies and
returns new trees, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    """AdamW hyper-parameters; ``grad_clip=0`` turns the clip off and
    ``weight_decay=0`` the decay."""

    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: Any = torch.bfloat16


def adamw_init(params, cfg: AdamWConfig):
    """Zero moments shaped like ``params`` and a step count of 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_update(grads, opt_state, params, cfg: AdamWConfig,
                 lr_scale=1.0):
    """One AdamW step: ``(new_params, new_state, grad_norm)``
    (``grad_norm`` is 0 when the clip is off): :func:`adamw_update_` on
    copies of the parameters and moments."""
    def copy(t):
        return t.clone(memory_format=torch.contiguous_format)
    new_p = tree_map(copy, params)
    new_m, new_v = (tree_map(copy, opt_state[k]) for k in ("m", "v"))
    count, gn = adamw_update_(
        tree_leaves(new_p), [g.contiguous() for g in tree_leaves(grads)],
        tree_leaves(new_m), tree_leaves(new_v), opt_state["count"], cfg,
        lr_scale)
    return new_p, {"m": new_m, "v": new_v, "count": count}, gn


#: Elements a slab of :func:`adamw_update_` (and the trainer's EMA) holds:
#: its float32 temporaries stay at a few hundred MB whatever the leaf.
CHUNK = 1 << 25


def _local(t):
    """A ``DTensor``'s local shard (what this device holds and updates
    elementwise); any other tensor as it is."""
    return t.to_local() if hasattr(t, "to_local") else t


def _laid_out_as(g, p):
    """``g`` contiguous (autograd may give a strided gradient, as the
    audio head's einsum does); a ``DTensor`` gradient first redistributed
    to its parameter's placements (autograd may leave it partial or
    replicated)."""
    if hasattr(g, "redistribute") and \
            tuple(g.placements) != tuple(p.placements):
        g = g.redistribute(p.device_mesh, p.placements)
    return g.contiguous()


def slabs(*tensors, size: int = CHUNK):
    """Matching flat slices of at most ``size`` elements of contiguous
    tensors of one size: views, so writing a slab writes the tensor.  A
    ``DTensor``'s slabs are of its local shard (tensors laid out alike)."""
    flat = [_local(t).view(-1) for t in tensors]
    for lo in range(0, flat[0].numel(), size):
        yield [f[lo:lo + size] for f in flat]


def adamw_update_(params, grads, ms, vs, count, cfg: AdamWConfig,
                  lr_scale=1.0):
    """:func:`adamw_update` in place: ``params``, ``grads``, ``ms`` and
    ``vs`` are equal-length lists of contiguous tensors (the leaves, or
    slices of them, in any grouping), ``count`` the state's step count.
    Writes the new parameters and moments into ``params``, ``ms`` and
    ``vs`` and returns ``(count + 1, grad_norm)``: the same values as
    :func:`adamw_update` on the trees those lists make up, the norm over
    every gradient given.  ``DTensor`` leaves (the dry run's
    tensor-parallel shards) are updated shard by shard, the norm summed
    over every shard."""
    f = torch.float32
    count = count + 1
    grads = [_laid_out_as(g, p) for p, g in zip(params, grads)]
    if cfg.grad_clip:
        gn = torch.sqrt(sum(torch.sum(torch.square(g.to(f)))
                            for g in grads))
        # a tensor numerator: torch computes ``float / tensor`` as a
        # reciprocal times the float, which rounds differently
        scale = _local(torch.clamp(torch.full_like(gn, cfg.grad_clip)
                                   / torch.clamp(gn, min=1e-9), max=1.0))
    else:
        gn = torch.zeros((), dtype=f, device=count.device)
        scale = None
    b1, b2 = cfg.b1, cfg.b2
    c = count.to(f)
    bias1 = 1.0 - b1 ** c
    bias2 = 1.0 - b2 ** c
    lr = cfg.lr * lr_scale
    for p, g, m, v in zip(params, grads, ms, vs):
        for p_, g_, m_, v_ in slabs(p, g, m, v):
            g32 = g_.to(f) * scale if scale is not None else g_.to(f)
            m32 = b1 * m_.to(f) + (1 - b1) * g32
            v32 = b2 * v_.to(f) + (1 - b2) * (g32 * g32)
            step = (m32 / bias1) / (torch.sqrt(v32 / bias2) + cfg.eps)
            if cfg.weight_decay:
                step = step + cfg.weight_decay * p_.to(f)
            p_.copy_(p_.to(f) - lr * step)
            m_.copy_(m32)
            v_.copy_(v32)
    return count, gn


def adamw_rows(objective, theta0, steps: int, cfg: AdamWConfig):
    """``steps`` AdamW updates of the rows ``theta0`` (R, p) on a per-row
    objective ``objective(theta) -> (R,)``.  Rows are independent, so
    autograd of the summed objective gives each row its own gradient."""
    theta, state = theta0, adamw_init(theta0, cfg)
    for _ in range(steps):
        with torch.enable_grad():
            th = theta.detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(objective(th).sum(), th)
        theta, state, _ = adamw_update(grad, state, theta, cfg)
    return theta


def cosine_schedule(step, total_steps: int, warmup: int = 100,
                    min_frac: float = 0.1):
    """Linear warm-up to 1, then a cosine decay to ``min_frac``."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(warmup, 1), max=1.0)
    prog = torch.clamp((step - warmup) / max(total_steps - warmup, 1),
                       0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
