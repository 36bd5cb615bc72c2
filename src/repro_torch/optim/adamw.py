"""AdamW for personalized (agent-stacked) parameter trees (counterpart of
``repro.optim.adamw``).

Parameters, gradients and moments are tensors or trees of them (nested
dicts, tuples and lists; ``repro_torch.tree``).  The moments are kept in
``moment_dtype`` (bf16 by default, as in the JAX package) and the update
math runs in float32, in the JAX package's order of operations: bias
terms ``1 - b**count`` in float32, an optional clip by the global norm,
decoupled weight decay.  Adam is elementwise, so agent-stacked leaves
need no special handling.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.tree import tree_flatten, tree_leaves, tree_map, \
    tree_unflatten


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


def _global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(torch.float32)))
                          for leaf in tree_leaves(tree)))


def adamw_update(grads, opt_state, params, cfg: AdamWConfig,
                 lr_scale=1.0):
    """One AdamW step: ``(new_params, new_state, grad_norm)``
    (``grad_norm`` is 0 when the clip is off)."""
    f = torch.float32
    count = opt_state["count"] + 1
    if cfg.grad_clip:
        gn = _global_norm(grads)
        # a tensor numerator: torch computes ``float / tensor`` as a
        # reciprocal times the float, which rounds differently
        scale = torch.clamp(torch.full_like(gn, cfg.grad_clip)
                            / torch.clamp(gn, min=1e-9), max=1.0)
        grads = tree_map(lambda g: g.to(f) * scale, grads)
    else:
        gn = torch.zeros((), dtype=f, device=count.device)
        grads = tree_map(lambda g: g.to(f), grads)

    b1, b2 = cfg.b1, cfg.b2
    c = count.to(f)
    bias1 = 1.0 - b1 ** c
    bias2 = 1.0 - b2 ** c
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v):
        m32 = b1 * m.to(f) + (1 - b1) * g
        v32 = b2 * v.to(f) + (1 - b2) * (g * g)
        mhat = m32 / bias1
        vhat = v32 / bias2
        step = mhat / (torch.sqrt(vhat) + cfg.eps)
        if cfg.weight_decay:
            step = step + cfg.weight_decay * p.to(f)
        newp = p.to(f) - lr * step
        return (newp.to(p.dtype), m32.to(cfg.moment_dtype),
                v32.to(cfg.moment_dtype))

    leaves, treedef = tree_flatten(params)
    out = [upd(*xs) for xs in zip(leaves, tree_leaves(grads),
                                  tree_leaves(opt_state["m"]),
                                  tree_leaves(opt_state["v"]))]
    new_p, new_m, new_v = (tree_unflatten(treedef, [o[q] for o in out])
                           for q in range(3))
    return new_p, {"m": new_m, "v": new_v, "count": count}, gn


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
