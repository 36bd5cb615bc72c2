"""The decoder model (counterpart of ``repro.models.model``), dense
family, for serving and for training.

Serving: ``Model`` is an ``nn.Module`` holding the embedding, one
:class:`Block` per layer and the head, each weight laid out as in the JAX
package's parameter tree (``(d_in, d_out)``, ``x @ w``).  It runs the
layers in a Python loop.  The JAX package keeps float32 master weights and
casts them to ``compute_dtype`` on every call; for serving, this model
holds them already cast (``dtype``, by default ``cfg.compute_dtype``),
which gives the same values.

Training: :meth:`Model.loss` and :meth:`Model.apply` run over an explicit
parameter tree laid out as the JAX package's (``embed``, ``unembed``,
``final_norm`` and ``groups``: one dict per scan group whose ``b{i}``
leaves are stacked over the group's repetitions, ``(L, ...)``), float32
master weights cast to ``compute_dtype`` on every call, differentiable by
autograd.  ``cfg.remat`` recomputes each layer in the backward pass
(``torch.utils.checkpoint``, non-reentrant), as ``jax.checkpoint`` with
nothing saveable does.  The module's own weights are not read there: a
``Model`` on the ``meta`` device holds none and trains as well.

Logits are float32 (the head multiplies in float32, as the JAX package's
``preferred_element_type`` asks).  Vision, audio and MoE models wait for
ROADMAP queue 1 item 9.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.tree import (tree_flatten, tree_map, tree_paths,
                              tree_unflatten)

from .blocks import (NOT_PORTED, Block, Ctx, attn_init_cache,
                     block_apply_dec, block_apply_seq)
from .common import ModelConfig, cross_entropy, rms_norm


class _Params(dict):
    """A parameter dict read by attribute, as the blocks read a
    :class:`Block`'s weights."""

    __getattr__ = dict.__getitem__


def _as_block(tree):
    return _Params({k: _as_block(v) if isinstance(v, dict) else v
                    for k, v in tree.items()})


def _nest(named):
    """``{"a.b": x}`` -> ``{"a": {"b": x}}``."""
    out: Dict = {}
    for name, val in named:
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = val  # scatter: unique targets (parameter names)
    return out


class Model(nn.Module):
    """A decoder of ``cfg`` on ``device`` (CUDA when None) in ``dtype``.

    ``backend`` (a ``kernels.dispatch.ReproBackend``, auto when None)
    picks the ``attention`` op's implementation on the ``flash`` route:
    the CUDA kernel for a CUDA device unless it names another.  The
    weights are uninitialized until :meth:`init` or ``load_state_dict``.
    """

    def __init__(self, cfg: ModelConfig, *, device=None, dtype=None,
                 backend=None):
        super().__init__()
        if cfg.family in ("vlm", "audio"):
            raise NotImplementedError(f"family {cfg.family!r} {NOT_PORTED}")
        device = resolve_device(device)
        dtype = dtype or cfg.compute_dtype
        self.cfg, self.backend = cfg, backend
        dm, V = cfg.d_model, cfg.vocab_size

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device,
                                            dtype=dtype),
                                requires_grad=False)

        self.embed = param(V, dm)
        self.unembed = param(dm, V)
        self.final_norm = param(dm)
        self.layers = nn.ModuleList(Block(cfg, kind, device, dtype)
                                    for kind in cfg.layer_kinds)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Draw every weight from ``generator`` (on the model's device):
        ``normal * scale`` in float32, cast to the model's dtype, where
        scale is 0.02 for the embedding and ``1 / sqrt(fan_in)`` (the
        matrix's first dim) otherwise; the norms' (1-D) weights are zeros.
        The JAX package's rule (``_init_leaf``); its draws differ."""
        for name, p in self.named_parameters():
            if p.dim() == 1:
                p.zero_()
                continue
            scale = 0.02 if name == "embed" \
                else 1.0 / math.sqrt(max(p.shape[-2], 1))
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device).mul_(scale))
        return self

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def _head(self, x):
        return x.float() @ self.unembed.float()

    def _embed(self, tokens):
        return self.embed[tokens.to(self.device).long()]

    # -- sequence forward ----------------------------------------------------

    @torch.no_grad()
    def forward(self, batch: Dict, *, window="auto"):
        """``batch["tokens"]`` (B, S) -> logits (B, S, V) float32."""
        x = self._embed(batch["tokens"])
        Btot, S, _ = x.shape
        positions = torch.arange(S, device=x.device)[None].expand(Btot, S)
        ctx = Ctx(positions=positions, window=window, cache_len=0,
                  backend=self.backend)
        for layer in self.layers:
            x, _ = block_apply_seq(self.cfg, layer.kind, layer, x, ctx)
        return self._head(rms_norm(x, self.final_norm))

    # -- training: a forward over an explicit parameter tree ------------------

    def abstract_params(self) -> Dict:
        """The JAX package's parameter tree of this config as ``meta``
        tensors in ``cfg.param_dtype`` (shapes only): the blocks' weights
        stacked over their group's repetitions."""
        cfg = self.cfg
        dm, V = cfg.d_model, cfg.vocab_size

        def leaf(*shape):
            return torch.empty(shape, dtype=cfg.param_dtype, device="meta")

        groups = []
        for unit, reps in cfg.scan_groups():
            groups.append({f"b{i}": _nest(
                (name, leaf(reps, *p.shape)) for name, p in
                Block(cfg, kind, "meta", cfg.param_dtype).named_parameters())
                for i, kind in enumerate(unit)})
        return {"embed": leaf(V, dm), "unembed": leaf(dm, V),
                "final_norm": leaf(dm), "groups": groups}

    def init_params(self, generator: torch.Generator, device=None) -> Dict:
        """Master weights in ``cfg.param_dtype`` on ``device`` (CUDA when
        None), drawn from ``generator`` leaf by leaf in the tree's order:
        the JAX package's rule (``_init_leaf``) — norms (1-D before
        stacking) zero, the embedding ``0.02 * normal``, every other
        matrix ``normal / sqrt(fan_in)`` with fan_in its second-to-last
        dim; its draws differ."""
        device = resolve_device(device)
        abstract = self.abstract_params()
        _, treedef = tree_flatten(abstract)
        leaves = []
        for name, a in tree_paths(abstract):
            if a.dim() - name.startswith("groups/") == 1:
                leaf = torch.zeros(a.shape, device=device)
            else:
                scale = 0.02 if name == "embed" \
                    else 1.0 / math.sqrt(max(a.shape[-2], 1))
                leaf = torch.randn(a.shape, generator=generator,
                                   device=device).mul_(scale)
            leaves.append(leaf.to(a.dtype))
        return tree_unflatten(treedef, leaves)

    def apply(self, params: Dict, batch: Dict, *, window="auto"):
        """``batch["tokens"]`` (B, S) -> (logits (B, S, V) float32, aux),
        differentiable in ``params`` (a tree like :meth:`abstract_params`);
        aux is the MoE router loss, 0 for the dense family."""
        cfg = self.cfg
        if cfg.attn_impl == "flash":
            raise NotImplementedError(
                "attn_impl='flash' cannot train: the flash_attention kernel "
                "has no backward (neither has the JAX package's); train "
                "with attn_impl='chunked' or 'ref'")
        cdt = cfg.compute_dtype
        embed = params["embed"]
        # gather, then cast: the same values as casting the whole table
        x = embed[batch["tokens"].to(embed.device).long()].to(cdt)
        Btot, S, _ = x.shape
        positions = torch.arange(S, device=x.device)[None].expand(Btot, S)
        ctx = Ctx(positions=positions, window=window, cache_len=0,
                  backend=self.backend)

        def cast(a):
            return a.to(cdt) if a.dtype == cfg.param_dtype else a

        for (unit, reps), gp in zip(cfg.scan_groups(), params["groups"]):
            for r in range(reps):
                def unit_apply(x, r=r, unit=unit, gp=gp):
                    pr = tree_map(lambda a: cast(a[r]), gp)
                    for i, kind in enumerate(unit):
                        x, _ = block_apply_seq(cfg, kind,
                                               _as_block(pr[f"b{i}"]), x,
                                               ctx)
                    return x
                x = checkpoint(unit_apply, x, use_reentrant=False) \
                    if cfg.remat else unit_apply(x)
        x = rms_norm(x, params["final_norm"])
        logits = x.float() @ cast(params["unembed"]).float()
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)

    def loss(self, params: Dict, batch: Dict, *, window="auto"):
        """The training objective: (ce + router_aux_weight * aux,
        {"ce", "aux"}), ce the mean over labels >= 0."""
        logits, aux = self.apply(params, batch, window=window)
        ce = cross_entropy(logits, batch["labels"].to(logits.device))
        return ce + self.cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}

    # -- serving -------------------------------------------------------------

    def init_cache(self, Btot: int, cache_len: int, dtype=None) -> Dict:
        """Zero kv caches (one ``{"k", "v"}`` of (B, cache_len, K, hd) per
        layer) and positions (B,) int32."""
        dtype = dtype or self.embed.dtype
        return {"layers": [attn_init_cache(self.cfg, Btot, cache_len, dtype,
                                           self.device)
                           for _ in self.layers],
                "pos": torch.zeros(Btot, dtype=torch.int32,
                                   device=self.device)}

    @torch.no_grad()
    def prefill(self, batch: Dict, cache_len: int, *, window="auto"):
        """Run the prompts ``batch["tokens"]`` (B, S) and build their
        caches: returns (logits of the last position (B, 1, V), cache).
        A cache shorter than the prompt is a ring holding its last
        ``cache_len`` tokens."""
        x = self._embed(batch["tokens"])
        Btot, S, _ = x.shape
        positions = torch.arange(S, device=x.device)[None].expand(Btot, S)
        ctx = Ctx(positions=positions, window=window, cache_len=cache_len,
                  ring=cache_len < S, backend=self.backend)
        caches = []
        for layer in self.layers:
            x, c = block_apply_seq(self.cfg, layer.kind, layer, x, ctx)
            caches.append(c)
        logits = self._head(rms_norm(x[:, -1:], self.final_norm))
        return logits, {"layers": caches,
                        "pos": torch.full((Btot,), S, dtype=torch.int32,
                                          device=x.device)}

    @torch.no_grad()
    def decode_step(self, cache: Dict, batch: Dict, *, window="auto",
                    ring: bool = False, lockstep: bool = False):
        """One token per request: ``batch["token"]`` (B,) at positions
        ``cache["pos"]`` -> (logits (B, V) float32, cache).  The kv tensors
        of ``cache`` are written in place; the returned cache holds them
        and ``pos + 1``.  ``lockstep=True``: every request is at
        ``cache["pos"][0]``."""
        x = self._embed(batch["token"])
        pos = cache["pos"]
        ctx = Ctx(positions=pos[0] if lockstep else pos, window=window,
                  ring=ring, backend=self.backend)
        new = []
        for layer, c in zip(self.layers, cache["layers"]):
            x, c = block_apply_dec(self.cfg, layer.kind, layer, x, c, ctx)
            new.append(c)
        logits = self._head(rms_norm(x, self.final_norm))
        return logits, {"layers": new, "pos": pos + 1}
