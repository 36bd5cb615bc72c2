"""The decoder model (counterpart of ``repro.models.model``), dense
family, for serving.

``Model`` is an ``nn.Module`` holding the embedding, one :class:`Block`
per layer and the head, each weight laid out as in the JAX package's
parameter tree (``(d_in, d_out)``, ``x @ w``).  It runs the layers in a
Python loop: the JAX package's scan over stacked groups and its remat are
compile-time and training devices with nothing to port for serving.

The JAX package keeps float32 master weights and casts them to
``compute_dtype`` on every call; for serving, this model holds them
already cast (``dtype``, by default ``cfg.compute_dtype``), which gives the
same values.  Logits are float32 (the head multiplies in float32, as the
JAX package's ``preferred_element_type`` asks).

Vision, audio and MoE models, the loss and training wait for ROADMAP
queue 1 item 9.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from repro_torch import resolve_device

from .blocks import (NOT_PORTED, Block, Ctx, attn_init_cache,
                     block_apply_dec, block_apply_seq)
from .common import ModelConfig, rms_norm


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
