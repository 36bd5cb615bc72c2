"""Flat slot-row parameter layout for neural agents (counterpart of
``repro.models.flatten``; DESIGN.md §18).

The collaborative engines treat every agent model as one float32 row of
width p.  :class:`ParamFlattener` maps a parameter tree onto such a row
and back, with the leaves in ``jax.tree_util``'s order (dict keys sorted,
``repro_torch.tree``), so a row carried across from the JAX package means
the same parameters here: an :class:`MLPAgent` layer ``{"w", "b"}`` lays
out as ``b`` then ``w``, a :class:`LoRAAgent` as ``a, b, bias, head``.

* :class:`MLPAgent` — a tiny fully-trainable MLP (the ``federated_moons``
  acceptance model);
* :class:`LoRAAgent` — a frozen random-feature layer with a trainable
  low-rank adapter and head; the consensus rows hold only the adapter and
  head.

Both are frozen dataclasses holding no tensors.  ``init`` draws from a
``torch.Generator`` (the JAX package draws with ``jax.random``, which
torch cannot replay: parity runs carry the JAX rows across instead), and
the LoRA base weights come from a numpy draw that ports exactly.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_flatten, tree_unflatten

_ACTIVATIONS = {"tanh": torch.tanh, "relu": torch.relu}


@dataclasses.dataclass(frozen=True)
class ParamFlattener:
    """Bijection between a fixed parameter tree and a flat float32 row.

    Built from a template tree (shapes and structure only, so it is
    hashable).  ``flatten`` and ``unflatten`` are row-local; under
    ``torch.func.vmap`` they map agent-stacked trees to the (n, p)
    slot-row block and back.
    """

    treedef: Any
    shapes: Tuple[Tuple[int, ...], ...]

    @classmethod
    def from_template(cls, tree) -> "ParamFlattener":
        """Build from any tree of arrays or tensors (values ignored)."""
        leaves, treedef = tree_flatten(tree)
        return cls(treedef, tuple(tuple(int(d) for d in np.shape(leaf))
                                  for leaf in leaves))

    @property
    def dim(self) -> int:
        """Total flat width p (the engines' model-row dimension)."""
        return sum(math.prod(s) for s in self.shapes)

    def flatten(self, tree) -> torch.Tensor:
        """Tree -> (dim,) float32 row, leaves in JAX's order."""
        leaves, _ = tree_flatten(tree)
        return torch.cat([torch.as_tensor(leaf).reshape(-1)
                          .to(torch.float32) for leaf in leaves])

    def unflatten(self, vec: torch.Tensor):
        """(dim,) row -> tree with the template's structure and shapes."""
        leaves, off = [], 0
        for shape in self.shapes:
            size = math.prod(shape)
            leaves.append(vec[off:off + size].reshape(shape))
            off += size
        return tree_unflatten(self.treedef, leaves)


@dataclasses.dataclass(frozen=True)
class MLPAgent:
    """Tiny per-agent MLP ``R^in_dim -> R`` (a scalar score head).

    Parameters are a tuple of ``{"w", "b"}`` layer dicts; ``apply`` maps a
    (m, in_dim) batch to (m,) scores whose sign is the predicted ±1 label.
    """

    in_dim: int
    hidden: Tuple[int, ...] = (8,)
    activation: str = "tanh"

    def _dims(self) -> Tuple[Tuple[int, int], ...]:
        sizes = (self.in_dim,) + tuple(self.hidden) + (1,)
        return tuple(zip(sizes[:-1], sizes[1:]))

    def init(self, generator: torch.Generator, scale: float = 1.0,
             device=None):
        """Glorot-style random parameters for one agent, drawn from
        ``generator`` (a CPU generator; the tensors go to ``device``)."""
        params = []
        for fan_in, fan_out in self._dims():
            w = torch.randn((fan_in, fan_out), generator=generator) \
                * (scale / math.sqrt(fan_in))
            params.append({"w": w.to(device),
                           "b": torch.zeros(fan_out, device=device)})
        return tuple(params)

    def apply(self, params, x) -> torch.Tensor:
        """(m, in_dim) -> (m,) scores."""
        act = _ACTIVATIONS[self.activation]
        h = x
        for layer in params[:-1]:
            h = act(h @ layer["w"] + layer["b"])
        out = h @ params[-1]["w"] + params[-1]["b"]
        return out[..., 0]

    def flattener(self) -> ParamFlattener:
        """The slot-row layout of this architecture's parameters."""
        return ParamFlattener.from_template(tuple(
            {"w": np.zeros((fi, fo), np.float32),
             "b": np.zeros((fo,), np.float32)}
            for fi, fo in self._dims()))


@functools.lru_cache(maxsize=None)
def _lora_base(in_dim: int, width: int, base_seed: int):
    """Frozen random-feature first layer shared by every LoRAAgent with the
    same config: the JAX package's numpy draw, as float32 arrays."""
    rng = np.random.default_rng(base_seed)
    w0 = rng.standard_normal((in_dim, width)) / math.sqrt(in_dim)
    b0 = rng.uniform(-1.0, 1.0, width)
    return w0.astype(np.float32), b0.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class LoRAAgent:
    """LoRA-shaped agent: frozen random-feature layer plus a trainable
    low-rank adapter and linear head.

    The first layer's weight is ``W0 + A @ B`` with frozen ``W0 (in_dim,
    width)`` from ``base_seed`` and trainable ``A (in_dim, rank)``, ``B
    (rank, width)``; the flat dimension is ``rank * (in_dim + width) +
    width + 1`` whatever ``width``.
    """

    in_dim: int
    width: int = 16
    rank: int = 2
    base_seed: int = 0
    activation: str = "tanh"

    def init(self, generator: torch.Generator, scale: float = 0.1,
             device=None):
        """Adapter (A random, B zero — standard LoRA init) and head."""
        a = torch.randn((self.in_dim, self.rank), generator=generator) \
            * (scale / math.sqrt(self.in_dim))
        head = torch.randn(self.width, generator=generator) \
            * (1.0 / math.sqrt(self.width))
        return {"a": a.to(device),
                "b": torch.zeros((self.rank, self.width), device=device),
                "head": head.to(device),
                "bias": torch.zeros((), device=device)}

    def apply(self, params, x) -> torch.Tensor:
        """(m, in_dim) -> (m,) scores through the adapted frozen layer."""
        w0, b0 = (torch.as_tensor(a, device=x.device)
                  for a in _lora_base(self.in_dim, self.width,
                                      self.base_seed))
        act = _ACTIVATIONS[self.activation]
        h = act(x @ (w0 + params["a"] @ params["b"]) + b0)
        return h @ params["head"] + params["bias"]

    def flattener(self) -> ParamFlattener:
        """The slot-row layout of the trainable (adapter and head) leaves."""
        return ParamFlattener.from_template({
            "a": np.zeros((self.in_dim, self.rank), np.float32),
            "b": np.zeros((self.rank, self.width), np.float32),
            "head": np.zeros((self.width,), np.float32),
            "bias": np.zeros((), np.float32)})
