"""Transformer blocks, dense subset (counterpart of
``repro.models.blocks``).

A block is norm -> mixer -> residual -> norm -> FFN -> residual.  Each
block kind has a sequence form (``*_apply_seq``: prefill or forward,
returning the kv cache entry when ``ctx.cache_len`` asks for one) and a
one-token decode form (``*_apply_dec``).  The weights live in
``nn.Module``s laid out as the JAX package's parameter tree —
``(d_in, d_out)`` matrices used as ``x @ w`` — so carrying weights across
is a copy (``convert.model_params_from_arrays``).

Kinds: ``attn`` and ``attn_local``.  The MoE FFN and the RG-LRU, mLSTM
and sLSTM mixers are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch import nn

from ..kernels import dispatch
from .attention import chunked_attention, decode_attention, ref_attention
from .common import ModelConfig, apply_rope, gelu, gelu_glu, rms_norm, swiglu

NOT_PORTED = ("is not ported yet: the MoE, RG-LRU, mLSTM and sLSTM blocks "
              "wait for ROADMAP queue 1 item 9")


class Ctx(NamedTuple):
    positions: Any = None        # (B, S) int (seq mode) or (B,) / () (decode)
    window: Any = None           # per-call window override ("auto" = cfg)
    cache_len: int = 0           # 0 => no cache wanted
    ring: bool = False           # decode cache is a ring buffer
    backend: Any = None          # dispatch.ReproBackend for the attention op


def _param(shape, device, dtype):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


class FFN(nn.Module):
    """``w_up`` and ``w_down`` (d, f) / (f, d), and ``w_gate`` (d, f)
    unless the kind is ``gelu``."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        if cfg.ffn_kind != "gelu":
            self.w_gate = _param((d, f), device, dtype)
        self.w_up = _param((d, f), device, dtype)
        self.w_down = _param((f, d), device, dtype)


def ffn_apply(cfg: ModelConfig, p: FFN, x):
    if cfg.ffn_kind == "gelu":
        return gelu(x @ p.w_up) @ p.w_down
    if cfg.ffn_kind == "geglu":
        return gelu_glu(x, p.w_gate, p.w_up, p.w_down)
    return swiglu(x, p.w_gate, p.w_up, p.w_down)


# ---------------------------------------------------------------------------
# Attention mixer
# ---------------------------------------------------------------------------


class Attention(nn.Module):
    """``wq`` (d, H hd), ``wk`` and ``wv`` (d, K hd), ``wo`` (H hd, d)."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.wq = _param((d, H * hd), device, dtype)
        self.wk = _param((d, K * hd), device, dtype)
        self.wv = _param((d, K * hd), device, dtype)
        self.wo = _param((H * hd, d), device, dtype)


def _window_of(cfg: ModelConfig, kind: str, ctx: Ctx) -> Optional[int]:
    if kind == "attn_local":
        return cfg.local_window
    if ctx.window != "auto":
        return ctx.window
    return cfg.window


def _qkv(cfg: ModelConfig, p: Attention, x, ctx: Ctx, decode: bool):
    B = x.shape[0]
    H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    S = 1 if decode else x.shape[1]
    xq = (x @ p.wq).reshape(B, S, H, hd)
    xk = (x @ p.wk).reshape(B, S, K, hd)
    xv = (x @ p.wv).reshape(B, S, K, hd)
    pos = ctx.positions
    if pos is None:
        pos = torch.arange(S, device=x.device)[None].expand(B, S)
    if decode:
        pos = torch.broadcast_to(torch.as_tensor(pos, device=x.device),
                                 (B,))[:, None]
    return (apply_rope(xq, pos, cfg.rope_theta),
            apply_rope(xk, pos, cfg.rope_theta), xv)


def attn_apply_seq(cfg: ModelConfig, kind: str, p: Attention, x, ctx: Ctx):
    """x (B, S, d) from position 0 -> (y (B, S, d), cache entry or None).

    The route of the JAX package: ``ref`` (or S not a multiple of
    ``attn_chunk``) -> ``ref_attention``; ``flash`` -> the ``attention``
    op (the CUDA kernel for CUDA tensors unless ``ctx.backend`` names
    another implementation); otherwise ``chunked_attention``.
    """
    B, S, d = x.shape
    window = _window_of(cfg, kind, ctx)
    xq, xk, xv = _qkv(cfg, p, x, ctx, decode=False)
    if cfg.attn_impl == "ref" or S % cfg.attn_chunk != 0:
        o = ref_attention(xq, xk, xv, window=window)
    elif cfg.attn_impl == "flash":
        o = dispatch.resolve("attention", ctx.backend, x.device)(
            xq, xk, xv, window=window)
    else:
        o = chunked_attention(xq, xk, xv, window=window, chunk=cfg.attn_chunk)
    y = o.reshape(B, S, cfg.n_heads * cfg.hd) @ p.wo
    cache = None
    if ctx.cache_len:
        Sc = ctx.cache_len
        shape = (B, Sc, cfg.n_kv_heads, cfg.hd)
        kc = torch.zeros(shape, dtype=x.dtype, device=x.device)
        vc = torch.zeros(shape, dtype=x.dtype, device=x.device)
        take = min(S, Sc)
        # token at absolute position p lives in slot p % Sc (ring
        # semantics; identity when Sc >= S); keep the last `take` tokens
        ps = torch.arange(S - take, S, device=x.device) % Sc
        kc[:, ps] = xk[:, S - take:]  # scatter: unique targets
        vc[:, ps] = xv[:, S - take:]  # scatter: unique targets
        cache = {"k": kc, "v": vc}
    return y, cache


def attn_apply_dec(cfg: ModelConfig, kind: str, p: Attention, x, cache,
                   ctx: Ctx):
    """x: (B, d), one token at position ``ctx.positions`` ((B,), or a
    scalar for lockstep decode).  Writes the token's k and v into the
    cache tensors in place (the JAX package returns new arrays; the values
    are the same) and returns ``(y (B, d), cache)``.  A slot past a
    non-ring cache's end is clamped to the last slot in lockstep (a
    dynamic_update_slice) and dropped per request (a scatter), as in JAX.
    """
    B, d = x.shape
    window = _window_of(cfg, kind, ctx)
    xq, xk, xv = _qkv(cfg, p, x[:, None, :], ctx, decode=True)
    kc, vc = cache["k"], cache["v"]
    Sc = kc.shape[1]
    pos = torch.as_tensor(ctx.positions, device=x.device)
    if pos.dim() == 0:
        # lockstep fleet decode: every request at the same position
        slot = (torch.remainder(pos, Sc) if ctx.ring
                else torch.clamp(pos, 0, Sc - 1)).long().reshape(1)
        kc.index_copy_(1, slot, xk)
        vc.index_copy_(1, slot, xv)
    else:
        slot = torch.remainder(pos, Sc) if ctx.ring else pos
        slot = torch.broadcast_to(slot, (B,))
        inside = (slot < Sc)[:, None, None]
        slot = torch.clamp(slot, 0, Sc - 1).long()
        rows = torch.arange(B, device=x.device)
        # scatter: unique targets (one slot per request row); a slot past
        # the cache's end writes its old value back
        kc[rows, slot] = torch.where(inside, xk[:, 0], kc[rows, slot])
        # scatter: unique targets (one slot per request row)
        vc[rows, slot] = torch.where(inside, xv[:, 0], vc[rows, slot])
    o = decode_attention(xq[:, 0], kc, vc, pos, window=window, ring=ctx.ring)
    y = o.reshape(B, cfg.n_heads * cfg.hd) @ p.wo
    return y, {"k": kc, "v": vc}


def attn_init_cache(cfg: ModelConfig, B: int, cache_len: int, dtype,
                    device):
    shape = (B, cache_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Block = norm -> mixer -> residual -> norm -> ffn -> residual
# ---------------------------------------------------------------------------

_MIXERS = ("attn", "attn_local")


def _check_kind(cfg: ModelConfig, kind: str) -> None:
    if kind not in _MIXERS:
        raise NotImplementedError(f"block kind {kind!r} {NOT_PORTED}")
    if cfg.n_experts > 0:
        raise NotImplementedError(f"the MoE FFN of {cfg.name!r} "
                                  f"{NOT_PORTED}")
    if cfg.family == "ssm":
        raise NotImplementedError(f"family {cfg.family!r} {NOT_PORTED}")


class Block(nn.Module):
    """One layer: ``norm1`` (d,), ``mixer`` (:class:`Attention`), ``norm2``
    (d,), ``ffn`` (:class:`FFN`)."""

    def __init__(self, cfg: ModelConfig, kind: str, device, dtype):
        super().__init__()
        _check_kind(cfg, kind)
        self.cfg, self.kind = cfg, kind
        self.norm1 = _param((cfg.d_model,), device, dtype)
        self.mixer = Attention(cfg, device, dtype)
        self.norm2 = _param((cfg.d_model,), device, dtype)
        self.ffn = FFN(cfg, device, dtype)


def block_apply_seq(cfg: ModelConfig, kind: str, p: Block, x, ctx: Ctx):
    """Returns (x, cache entry)."""
    h, cache = attn_apply_seq(cfg, kind, p.mixer, rms_norm(x, p.norm1), ctx)
    x = x + h
    x = x + ffn_apply(cfg, p.ffn, rms_norm(x, p.norm2))
    return x, cache


def block_apply_dec(cfg: ModelConfig, kind: str, p: Block, x, cache,
                    ctx: Ctx):
    h, cache = attn_apply_dec(cfg, kind, p.mixer, rms_norm(x, p.norm1),
                              cache, ctx)
    x = x + h
    x = x + ffn_apply(cfg, p.ffn, rms_norm(x, p.norm2))
    return x, cache
