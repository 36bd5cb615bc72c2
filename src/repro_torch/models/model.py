"""The decoder model (counterpart of ``repro.models.model``), every
family of the JAX package, for serving and for training.

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
``preferred_element_type`` asks).  The families differ at the ends as in
the JAX package: ``vlm`` prepends ``batch["patch_embeds"]`` (B, n_media,
d) to the text tokens' embeddings, rotates q and k by M-RoPE at
``batch["positions3"]`` (3, B, S) in sequence mode (RoPE at the cache's
positions in decode) and drops the patches' logits; ``audio`` embeds
(B, K, S) codebook tokens through (K, V, d) tables summed over the
codebooks, prepends ``batch["cond_embeds"]`` and has a (K, d, V) head:
logits (B, K, S, V), and ``decode_step`` takes (B, K) tokens.  MoE
blocks add their router loss to ``aux``.

Sharding: :meth:`Model.param_specs`, :meth:`Model.cache_specs` and
:meth:`Model.batch_specs` are the JAX package's ``param_pspecs``,
``cache_pspecs`` and ``batch_pspecs`` as tuples (``common.constrain``);
:meth:`Model.specs` keys the module's own weights' specs like
``named_parameters()``, and :meth:`Model.input_specs` gives every input
as a ``meta`` tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.tree import (tree_flatten, tree_map, tree_paths,
                              tree_unflatten)

from .blocks import (Block, Ctx, block_apply_dec, block_apply_seq,
                     block_cache_specs, block_init_cache, module_specs)
from .common import (AGENT_SLOT, ModelConfig, constrain, cross_entropy,
                     init_leaf, is_dtensor, rms_norm)


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


def _embed_tokens(cfg: ModelConfig, embed, tok, dtype):
    """Embeddings of ``tok`` in ``dtype``: (B, ...) ids, or (B, K, ...) for
    audio, whose K codebooks' embeddings are summed in the compute dtype in
    codebook order.  Each row is gathered, then cast (the same values as
    casting the whole table, as the JAX package does)."""
    tok = torch.as_tensor(tok, device=embed.device).long()

    def rows(table, ids):
        # a vocabulary-sharded DTensor table gathers through F.embedding
        # (torch.distributed.tensor's masked shards), summed over the
        # shards at once
        if is_dtensor(table):
            return constrain(F.embedding(ids, table), (None,) * (ids.dim()
                                                                 + 1))
        return table[ids]
    if cfg.family == "audio":
        return sum(rows(embed[k], tok[:, k]).to(dtype)
                   for k in range(cfg.n_codebooks))
    return rows(embed, tok).to(dtype)


def _embed_batch(cfg: ModelConfig, embed, batch: Dict, dtype):
    """The sequence input of ``batch`` in ``dtype``: (x (B, S, d), the
    M-RoPE ids (3, B, S) or None, the number of prefix positions whose
    logits are dropped)."""
    dev = embed.device
    x = _embed_tokens(cfg, embed, batch["tokens"], dtype)
    if cfg.family == "audio":
        cond = torch.as_tensor(batch["cond_embeds"], device=dev).to(dtype)
        return torch.cat([cond, x], dim=1), None, cfg.n_cond_tokens
    if cfg.family == "vlm":
        patches = torch.as_tensor(batch["patch_embeds"], device=dev).to(dtype)
        return (torch.cat([patches, x], dim=1),
                torch.as_tensor(batch["positions3"], device=dev),
                cfg.n_media_tokens)
    return x, None, 0


def _head(cfg: ModelConfig, x, unembed):
    """Float32 logits of x (B, S, d): (B, S, V), or (B, K, S, V) for
    audio."""
    if cfg.family == "audio":
        return torch.einsum("bsd,kdv->bksv", x.float(), unembed.float())
    return x.float() @ unembed.float()


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
        device = resolve_device(device)
        dtype = dtype or cfg.compute_dtype
        self.cfg, self.backend = cfg, backend
        dm, V = cfg.d_model, cfg.vocab_size

        def param(*shape):
            return nn.Parameter(torch.empty(shape, device=device,
                                            dtype=dtype),
                                requires_grad=False)

        K = (cfg.n_codebooks,) if cfg.family == "audio" else ()
        self.embed = param(*K, V, dm)
        self.unembed = param(*K, dm, V)
        self.final_norm = param(dm)
        self.layers = nn.ModuleList(Block(cfg, kind, device, dtype)
                                    for kind in cfg.layer_kinds)


    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Draw every weight from ``generator`` (on the model's device) in
        float32 by the JAX package's rule (``common.init_leaf``: ``normal
        * scale``, scale 0.02 for the embedding, the router and the mLSTM
        gates and ``1 / sqrt(fan_in)`` otherwise; 1-D weights zero but
        the RG-LRU's ``lam``), cast to the model's dtype; the draws
        differ from JAX's."""
        for name, p in self.named_parameters():
            p.copy_(init_leaf(name.rsplit(".", 1)[-1], p.shape, generator,
                              p.device))
        return self

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # -- sharding specs (the JAX package's pspecs, as tuples) ---------------

    def _top_specs(self) -> Dict:
        if self.cfg.family == "audio":
            return {"embed": (None, "model", None),
                    "unembed": (None, None, "model"), "final_norm": (None,)}
        return {"embed": ("model", None), "unembed": (None, "model"),
                "final_norm": (None,)}

    def specs(self) -> Dict:
        """The module's weights' specs, keyed like
        ``named_parameters()``."""
        top = self._top_specs()
        out = {name: top[name] for name in ("embed", "unembed",
                                            "final_norm")}
        for i, layer in enumerate(self.layers):
            out.update({f"layers.{i}.{k}": v
                        for k, v in module_specs(layer).items()})
        return out

    def param_specs(self) -> Dict:
        """The specs of the tree :meth:`abstract_params` lays out (the
        JAX package's ``param_pspecs``): a stacked leaf's spec has a
        ``None`` for its repetition dim."""
        cfg = self.cfg
        groups = []
        for unit, reps in cfg.scan_groups():
            groups.append({f"b{i}": _nest(
                (name, (None,) + spec) for name, spec in
                module_specs(Block(cfg, kind, "meta", cfg.param_dtype))
                .items()) for i, kind in enumerate(unit)})
        return {**self._top_specs(), "groups": groups}

    def cache_specs(self) -> Dict:
        """The JAX package's ``cache_pspecs``: one entry per scan group,
        its blocks' cache specs with a ``None`` for the repetition dim,
        and ``pos`` over the agent slot."""
        cfg = self.cfg
        layers = [{f"b{i}": {k: (None,) + v for k, v in
                             block_cache_specs(cfg, kind).items()}
                   for i, kind in enumerate(unit)}
                  for unit, _ in cfg.scan_groups()]
        return {"layers": layers, "pos": (AGENT_SLOT,)}

    def batch_specs(self, mode: str = "train") -> Dict:
        """The JAX package's ``batch_pspecs``: the batch dim over the
        agent slot (``positions3``'s batch is its dim 1)."""
        a = AGENT_SLOT
        fam = self.cfg.family
        if mode == "decode":
            return {"batch": {"token": (a,)}, "cache": self.cache_specs()}
        if fam == "audio":
            return {"tokens": (a, None, None), "labels": (a, None, None),
                    "cond_embeds": (a, None, None)}
        if fam == "vlm":
            return {"tokens": (a, None), "labels": (a, None),
                    "patch_embeds": (a, None, None),
                    "positions3": (None, a, None)}
        return {"tokens": (a, None), "labels": (a, None)}

    def input_specs(self, batch_size: int, seq_len: int, mode: str = "train",
                    cache_len=None) -> Dict:
        """Every input of a step as ``meta`` tensors (the JAX package's
        ``ShapeDtypeStruct`` stand-ins): mode "train" / "prefill" a batch
        of ``seq_len`` positions, the family's prefix included; mode
        "decode" ``{"batch": {"token"}, "cache"}``, the cache laid out as
        :meth:`init_cache` lays it out, ``cache_len`` (default
        ``seq_len``) deep."""
        cfg = self.cfg
        i32 = torch.int32

        def meta(*shape, dtype=i32):
            return torch.empty(shape, dtype=dtype, device="meta")

        if mode == "decode":
            tok = (batch_size, cfg.n_codebooks) if cfg.family == "audio" \
                else (batch_size,)
            cache = {"layers": [block_init_cache(
                cfg, kind, batch_size, cache_len or seq_len,
                cfg.compute_dtype, "meta") for kind in cfg.layer_kinds],
                "pos": meta(batch_size)}
            return {"batch": {"token": meta(*tok)}, "cache": cache}
        cdt = cfg.compute_dtype
        if cfg.family == "audio":
            S_a = seq_len - cfg.n_cond_tokens
            K = cfg.n_codebooks
            return {"tokens": meta(batch_size, K, S_a),
                    "labels": meta(batch_size, K, S_a),
                    "cond_embeds": meta(batch_size, cfg.n_cond_tokens,
                                        cfg.d_model, dtype=cdt)}
        if cfg.family == "vlm":
            S_t = seq_len - cfg.n_media_tokens
            return {"tokens": meta(batch_size, S_t),
                    "labels": meta(batch_size, S_t),
                    "patch_embeds": meta(batch_size, cfg.n_media_tokens,
                                         cfg.d_model, dtype=cdt),
                    "positions3": meta(3, batch_size, seq_len)}
        return {"tokens": meta(batch_size, seq_len),
                "labels": meta(batch_size, seq_len)}

    def _ctx(self, x, positions3, **kw) -> Ctx:
        Btot, S, _ = x.shape
        positions = torch.arange(S, device=x.device)[None].expand(Btot, S)
        return Ctx(positions=positions, positions3=positions3,
                   backend=self.backend, **kw)

    # -- sequence forward ----------------------------------------------------

    @torch.no_grad()
    def forward(self, batch: Dict, *, window="auto"):
        """``batch["tokens"]`` (B, S) (with the family's extra inputs) ->
        logits (B, S, V) float32 ((B, K, S, V) for audio)."""
        x, p3, n_prefix = _embed_batch(self.cfg, self.embed, batch,
                                       self.embed.dtype)
        x = constrain(x, (AGENT_SLOT, None, None))
        ctx = self._ctx(x, p3, window=window, cache_len=0)
        for layer in self.layers:
            x, _, _ = block_apply_seq(self.cfg, layer.kind, layer, x, ctx)
        x = constrain(rms_norm(x, self.final_norm), (AGENT_SLOT, None, None))
        return _head(self.cfg, x[:, n_prefix:], self.unembed)

    # -- training: a forward over an explicit parameter tree ------------------

    def abstract_params(self) -> Dict:
        """The JAX package's parameter tree of this config as ``meta``
        tensors in ``cfg.param_dtype`` (shapes only): the blocks' weights
        stacked over their group's repetitions."""
        cfg = self.cfg
        dm, V = cfg.d_model, cfg.vocab_size
        K = (cfg.n_codebooks,) if cfg.family == "audio" else ()

        def leaf(*shape):
            return torch.empty(shape, dtype=cfg.param_dtype, device="meta")

        groups = []
        for unit, reps in cfg.scan_groups():
            groups.append({f"b{i}": _nest(
                (name, leaf(reps, *p.shape)) for name, p in
                Block(cfg, kind, "meta", cfg.param_dtype).named_parameters())
                for i, kind in enumerate(unit)})
        return {"embed": leaf(*K, V, dm), "unembed": leaf(*K, dm, V),
                "final_norm": leaf(dm), "groups": groups}

    def init_params(self, generator: torch.Generator, device=None) -> Dict:
        """Master weights in ``cfg.param_dtype`` on ``device`` (CUDA when
        None), drawn from ``generator`` leaf by leaf in the tree's order
        by the JAX package's rule (``common.init_leaf``, reading a stacked
        leaf's shape without its repetition dim); its draws differ."""
        device = resolve_device(device)
        abstract = self.abstract_params()
        _, treedef = tree_flatten(abstract)
        leaves = [init_leaf(name.rsplit("/", 1)[-1], a.shape, generator,
                            device, stacked=int(name.startswith("groups/")))
                  .to(a.dtype) for name, a in tree_paths(abstract)]
        return tree_unflatten(treedef, leaves)

    def apply(self, params: Dict, batch: Dict, *, window="auto"):
        """``batch`` as :meth:`forward` takes it -> (float32 logits, aux),
        differentiable in ``params`` (a tree like :meth:`abstract_params`);
        aux is the MoE router loss summed over the layers (0 without
        experts).  While autograd records, ``attn_impl="flash"`` runs
        ``chunked_attention`` (the kernel has no backward), as the JAX
        package runs it off the TPU."""
        cfg = self.cfg
        if cfg.attn_impl == "flash" and torch.is_grad_enabled():
            cfg = dataclasses.replace(cfg, attn_impl="chunked")
        cdt = cfg.compute_dtype
        x, p3, n_prefix = _embed_batch(cfg, params["embed"], batch, cdt)
        x = constrain(x, (AGENT_SLOT, None, None))
        ctx = self._ctx(x, p3, window=window, cache_len=0)

        def cast(a):
            return a.to(cdt) if a.dtype == cfg.param_dtype else a

        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for (unit, reps), gp in zip(cfg.scan_groups(), params["groups"]):
            for r in range(reps):
                def unit_apply(x, r=r, unit=unit, gp=gp):
                    pr = tree_map(lambda a: cast(a[r]), gp)
                    a_sum = torch.zeros((), dtype=torch.float32,
                                        device=x.device)
                    for i, kind in enumerate(unit):
                        x, _, a = block_apply_seq(
                            cfg, kind, _as_block(pr[f"b{i}"]), x, ctx)
                        a_sum = a_sum + a
                    return x, a_sum
                x, a = checkpoint(unit_apply, x, use_reentrant=False) \
                    if cfg.remat else unit_apply(x)
                aux = aux + a
        x = constrain(rms_norm(x, params["final_norm"]),
                      (AGENT_SLOT, None, None))
        return _head(cfg, x[:, n_prefix:], cast(params["unembed"])), aux

    def loss(self, params: Dict, batch: Dict, *, window="auto"):
        """The training objective: (ce + router_aux_weight * aux,
        {"ce", "aux"}), ce the mean over labels >= 0."""
        logits, aux = self.apply(params, batch, window=window)
        ce = cross_entropy(logits, batch["labels"].to(logits.device))
        return ce + self.cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}

    # -- serving -------------------------------------------------------------

    def init_cache(self, Btot: int, cache_len: int, dtype=None) -> Dict:
        """Zero caches, one entry per layer by its kind (attention
        ``{"k", "v"}`` of (B, cache_len, K, hd); RG-LRU ``{"h", "conv"}``;
        mLSTM ``{"C", "n", "m"}``; sLSTM ``{"c", "n", "h", "m"}``; the
        recurrent states in float32), and positions (B,) int32."""
        dtype = dtype or self.embed.dtype
        return {"layers": [block_init_cache(self.cfg, layer.kind, Btot,
                                            cache_len, dtype, self.device)
                           for layer in self.layers],
                "pos": torch.zeros(Btot, dtype=torch.int32,
                                   device=self.device)}

    @torch.no_grad()
    def prefill(self, batch: Dict, cache_len: int, *, window="auto"):
        """Run the prompts ``batch["tokens"]`` (B, S) (with the family's
        extra inputs) and build their caches: returns (logits of the last
        position (B, 1, V), or (B, K, 1, V) for audio, cache).  A cache
        shorter than the sequence is a ring holding its last
        ``cache_len`` positions."""
        x, p3, _ = _embed_batch(self.cfg, self.embed, batch,
                                self.embed.dtype)
        Btot, S, _ = x.shape
        ctx = self._ctx(x, p3, window=window, cache_len=cache_len,
                        ring=cache_len < S)
        caches = []
        for layer in self.layers:
            x, c, _ = block_apply_seq(self.cfg, layer.kind, layer, x, ctx)
            caches.append(c)
        x = constrain(x, (AGENT_SLOT, None, None))
        logits = _head(self.cfg, rms_norm(x[:, -1:], self.final_norm),
                       self.unembed)
        return logits, {"layers": caches,
                        "pos": torch.full((Btot,), S, dtype=torch.int32,
                                          device=x.device)}

    @torch.no_grad()
    def decode_step(self, cache: Dict, batch: Dict, *, window="auto",
                    ring: bool = False, lockstep: bool = False):
        """One token per request: ``batch["token"]`` (B,), or (B, K) for
        audio, at positions ``cache["pos"]`` -> (logits (B, V) float32, or
        (B, K, V), cache).  The kv tensors of ``cache`` are written in
        place; the returned cache holds them, the recurrent states' new
        tensors and ``pos + 1``.  ``lockstep=True``: every request is at
        ``cache["pos"][0]``."""
        cfg = self.cfg
        x = _embed_tokens(cfg, self.embed, batch["token"], self.embed.dtype)
        pos = cache["pos"]
        ctx = Ctx(positions=pos[0] if lockstep else pos, window=window,
                  ring=ring, backend=self.backend)
        new = []
        for layer, c in zip(self.layers, cache["layers"]):
            x, c = block_apply_dec(cfg, layer.kind, layer, x, c, ctx)
            new.append(c)
        logits = _head(cfg, rms_norm(x, self.final_norm)[:, None],
                       self.unembed)[..., 0, :]
        return logits, {"layers": new, "pos": pos + 1}
