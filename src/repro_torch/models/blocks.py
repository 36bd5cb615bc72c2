"""Transformer and recurrent blocks (counterpart of
``repro.models.blocks``).

A block is norm -> mixer -> residual [-> norm -> FFN or MoE ->
residual].  Each mixer kind has a sequence form (``*_apply_seq``:
prefill or forward, returning its cache entry when ``ctx.cache_len`` asks
for one) and a one-token decode form (``*_apply_dec``).  The weights live
in ``nn.Module``s laid out as the JAX package's parameter tree —
``(d_in, d_out)`` matrices used as ``x @ w``, expert stacks ``(E, d, f)``
— so carrying weights across is a copy
(``convert.model_params_from_arrays``).

Kinds: ``attn`` and ``attn_local`` (with the MoE FFN where the config has
experts), ``rglru`` (RecurrentGemma's RG-LRU), ``mlstm`` and ``slstm``
(xLSTM, whose blocks carry their own projections: no FFN).  The JAX
package's ``lax.scan`` over time becomes a Python loop (sLSTM, the mLSTM
``scan`` form) and its ``associative_scan`` a log-depth scan of torch ops
(RG-LRU); none of these reaches a Pallas kernel there, so none is a
kernel here.

Each weight's sharding spec is the JAX package's ``ParamDef.spec``: a
module class's ``SPECS`` maps its weights' names to them, and
:func:`module_specs` gives a module's specs keyed like its
``named_parameters()``.  ``constrain`` stands where the JAX package holds
activations to a spec (the queries, the residual stream when
``cfg.seq_shard``, the MoE expert buffers); it returns a plain tensor as
it is, so a run on one device computes what it did without it.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import dispatch
from .attention import chunked_attention, decode_attention, ref_attention
from .common import (AGENT_SLOT, ModelConfig, apply_mrope, apply_rope,
                     constrain, gelu, gelu_glu, is_dtensor, rms_norm, swiglu)


class Ctx(NamedTuple):
    positions: Any = None        # (B, S) int (seq mode) or (B,) / () (decode)
    positions3: Any = None       # (3, B, S) for M-RoPE (vlm), seq mode only
    window: Any = None           # per-call window override ("auto" = cfg)
    cache_len: int = 0           # 0 => no cache wanted
    ring: bool = False           # decode cache is a ring buffer
    backend: Any = None          # dispatch.ReproBackend for the attention op


def _param(shape, device, dtype):
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype),
                        requires_grad=False)


def module_specs(module: nn.Module):
    """``{name: spec}`` for ``module.named_parameters()``: each weight's
    spec from its owner's class ``SPECS`` (the JAX package's
    ``ParamDef.spec``)."""
    out = {}
    for name, _ in module.named_parameters():
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        out[name] = type(sub).SPECS[leaf]  # scatter: unique targets
    return out


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------


class FFN(nn.Module):
    """``w_up`` and ``w_down`` (d, f) / (f, d), and ``w_gate`` (d, f)
    unless the kind is ``gelu``."""

    SPECS = {"w_gate": (None, "model"), "w_up": (None, "model"),
             "w_down": ("model", None)}

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

    SPECS = {"wq": (None, "model"), "wk": (None, "model"),
             "wv": (None, "model"), "wo": ("model", None)}

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
        self.wq = _param((d, H * hd), device, dtype)
        self.wk = _param((d, K * hd), device, dtype)
        self.wv = _param((d, K * hd), device, dtype)
        self.wo = _param((H * hd, d), device, dtype)


def _heads(t, shape):
    """``t.reshape(shape)`` between (..., heads, hd) and (..., heads * hd)
    (``shape[-1]`` says which).  A ``DTensor`` comes out with its heads,
    or their merged dim, over "model" when the heads divide over it and
    whole otherwise (fewer heads than devices are replicated, as a
    tensor-parallel layer does), on both sides of the reshape, so that
    its gradient meets the reshape laid out the same way."""
    if not is_dtensor(t):
        return t.reshape(shape)
    split = len(shape) == t.dim() + 1
    heads = shape[-2] if split else t.shape[-2]
    if heads % t.device_mesh.size() != 0:
        return constrain(constrain(t, (None,) * t.dim()).reshape(shape),
                         (None,) * len(shape))
    at = len(shape) - (2 if split else 1)
    spec = tuple("model" if d == at else None for d in range(len(shape)))
    return constrain(t.reshape(shape), spec)


def _head_parallel(attend, q, k, v):
    """``attend(q, k, v)``; for ``DTensor`` inputs, on each device's own
    query heads: the queries as ``constrain`` laid them out (split over
    "model", or whole when the heads do not divide), the kv heads those
    query heads read taken from the whole k and v, and the output laid
    out as the queries.  Heads are independent, so this is the same
    function; it spares torch's sharding rules the head-flattening views
    of the attention's einsums."""
    if not is_dtensor(q):
        return attend(q, k, v)
    from torch.distributed.tensor import DTensor, Partial
    whole = (None,) * k.dim()
    k, v = constrain(k, whole), constrain(v, whole)
    ql = q.to_local()
    if not q.placements[0].is_shard():
        kl, vl = k.to_local(), v.to_local()
    else:
        # this device's query heads [h0, h0 + Hl) read kv heads h // G
        Hl, G = ql.shape[2], q.shape[2] // k.shape[2]
        h0 = q.device_mesh.get_local_rank() * Hl
        k0, k1 = h0 // G, (h0 + Hl + G - 1) // G

        def mine(t):
            # each device's heads add their share of the kv gradient
            t = t.to_local(grad_placements=[Partial()])[:, :, k0:k1]
            return t.repeat_interleave(G, dim=2)[:, :, h0 - k0 * G:
                                                 h0 - k0 * G + Hl]
        kl, vl = mine(k), mine(v)
    return DTensor.from_local(attend(ql, kl, vl), q.device_mesh,
                              q.placements, run_check=False)


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
    xq = _heads(x @ p.wq, (B, S, H, hd))
    xk = _heads(x @ p.wk, (B, S, K, hd))
    xv = _heads(x @ p.wv, (B, S, K, hd))
    if cfg.family == "vlm" and ctx.positions3 is not None:
        p3, sec = ctx.positions3, cfg.mrope_sections
        return (apply_mrope(xq, p3, cfg.rope_theta, sec),
                apply_mrope(xk, p3, cfg.rope_theta, sec), xv)
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
    xq = constrain(xq, (AGENT_SLOT, None, "model", None))
    if cfg.attn_impl == "ref" or S % cfg.attn_chunk != 0:
        def attend(q, k, v):
            return ref_attention(q, k, v, window=window)
    elif cfg.attn_impl == "flash":
        def attend(q, k, v):
            return dispatch.resolve("attention", ctx.backend, q.device)(
                q, k, v, window=window)
    else:
        def attend(q, k, v):
            return chunked_attention(q, k, v, window=window,
                                     chunk=cfg.attn_chunk)
    o = _head_parallel(attend, xq, xk, xv)
    y = _heads(o, (B, S, cfg.n_heads * cfg.hd)) @ p.wo
    cache = None
    if ctx.cache_len and is_dtensor(xk):
        cache = {"k": _ring_cache(xk, ctx.cache_len),
                 "v": _ring_cache(xv, ctx.cache_len)}
    elif ctx.cache_len:
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


def _ring_cache(kv, Sc: int):
    """The cache of a prefill's k or v (B, S, K, hd) as whole-tensor ops
    (the form a ``DTensor`` takes): position p in slot p % Sc, the last
    min(S, Sc) positions kept, the other slots zero."""
    S = kv.shape[1]
    if Sc >= S:
        return torch.cat([kv, kv.new_zeros((kv.shape[0], Sc - S)
                                           + tuple(kv.shape[2:]))], dim=1)
    return torch.roll(kv[:, S - Sc:], (S - Sc) % Sc, dims=1)


def _write_slot(cache, slot, new):
    """``cache`` (B, Sc, ...) with row b's slot ``slot[b]`` set to
    ``new[b]`` and slots past the end dropped, as a select over the whole
    cache (a ``DTensor``'s form of the in-place write)."""
    Sc = cache.shape[1]
    hit = (torch.arange(Sc, device=slot.device)[None, :] == slot[:, None])
    hit = hit.reshape(hit.shape + (1,) * (cache.dim() - 2))
    return torch.where(hit, new[:, None], cache)


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
    if is_dtensor(kc):
        slot = torch.remainder(pos, Sc) if ctx.ring else (
            torch.clamp(pos, 0, Sc - 1) if pos.dim() == 0 else pos)
        slot = torch.broadcast_to(slot, (B,))
        kc, vc = _write_slot(kc, slot, xk[:, 0]), _write_slot(vc, slot,
                                                              xv[:, 0])
    elif pos.dim() == 0:
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
    y = _heads(o, (B, cfg.n_heads * cfg.hd)) @ p.wo
    return y, {"k": kc, "v": vc}


def attn_init_cache(cfg: ModelConfig, B: int, cache_len: int, dtype,
                    device):
    shape = (B, cache_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MoE FFN (token-choice top-k with capacity)
# ---------------------------------------------------------------------------


class MoE(nn.Module):
    """``router`` (d, E), expert stacks ``w_gate`` and ``w_up`` (E, d, f)
    and ``w_down`` (E, f, d)."""

    SPECS = {"router": (None, None), "w_gate": ("model", None, None),
             "w_up": ("model", None, None), "w_down": ("model", None, None)}

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = _param((d, E), device, dtype)
        self.w_gate = _param((E, d, f), device, dtype)
        self.w_up = _param((E, d, f), device, dtype)
        self.w_down = _param((E, f, d), device, dtype)


def moe_route(gates, k: int):
    """The top ``k`` of the (T, E) gates: (values, expert ids), each (T, k),
    by a stable descending sort (``jax.lax.top_k`` breaks ties by the
    lower index; ``torch.topk`` promises no order)."""
    topv, topi = torch.sort(gates, dim=-1, descending=True, stable=True)
    return topv[:, :k], topi[:, :k]


def moe_apply(cfg: ModelConfig, p: MoE, x):
    """x (B, S, d) -> (y (B, S, d), aux float32): token-choice top-k
    routing into (E, C, d) expert buffers of capacity
    ``C = min(ceil(T k / E * cf), T)``; a token's choices past its
    expert's capacity are dropped.  aux is the Switch load-balance loss.

    Top-k is :func:`moe_route`.  A choice's position in its expert's
    queue is the exclusive integer cumsum of the one-hots in token order,
    exact on every device.  ``cfg.moe_impl``:
    ``gather`` scatters token ids into the slots and gathers the tokens,
    ``scatter`` adds every choice's token, times 0 or 1, into its slot.
    Both give the same buffers (up to the sign of a zero), so the same
    output bit for bit.
    """
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, d)
    gates = torch.softmax((xt @ p.router).float(), dim=-1)        # (T, E)
    topv, topi = moe_route(gates, k)                               # (T, k)
    topv = topv / torch.clamp_min(topv.sum(-1, keepdim=True), 1e-9)

    C = min(int(math.ceil(T * k / E * cfg.capacity_factor)), T)
    onehot = F.one_hot(topi.reshape(-1), E)                        # (T k, E)
    pos_flat = torch.cumsum(onehot, dim=0) - onehot                # exclusive
    pos = torch.gather(pos_flat, 1, topi.reshape(-1, 1)).reshape(T, k)
    keep = pos < C
    slot = (topi * C + torch.clamp_max(pos, C - 1)).reshape(-1)    # (T k,)

    if cfg.moe_impl == "gather":
        src = torch.full((E * C + 1,), T, dtype=torch.long, device=x.device)
        write = torch.where(keep.reshape(-1), slot, E * C)  # dropped: spill
        tok = torch.arange(T * k, device=x.device) // k
        # scatter: unique targets — kept choices own distinct slots; the
        # dropped ones meet only on the spill slot E*C, cut off below
        src.index_put_((write,), tok)
        xt_pad = torch.cat([xt, xt.new_zeros(1, d)])
        buf = xt_pad[src[:E * C]]                                  # (E C, d)
    else:
        # each dropped choice lands on its expert's last slot (kept by an
        # earlier token) with its token times 0: an exact zero, so the
        # sum is exact whatever order index_add_ adds in on the card
        contrib = keep.to(x.dtype)
        buf = xt.new_zeros(E * C, d).index_add_(
            0, slot, (xt[:, None, :] * contrib[:, :, None]).reshape(T * k, d))
    expert_in = constrain(buf.reshape(E, C, d), ("model", None, None))
    h = F.silu(torch.bmm(expert_in, p.w_gate)) \
        * torch.bmm(expert_in, p.w_up)
    expert_out = constrain(torch.bmm(h, p.w_down), ("model", None, None)) \
        .reshape(E * C, d)
    gathered = expert_out[slot].reshape(T, k, d)
    y = torch.sum(gathered * (topv * keep).to(x.dtype)[..., None], dim=1)

    me = gates.mean(dim=0)                                         # (E,)
    ce = F.one_hot(topi[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(me * ce)
    return y.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# RG-LRU mixer (RecurrentGemma / Griffin)
# ---------------------------------------------------------------------------


class RGLRU(nn.Module):
    """``w_x`` and ``w_gate`` (d, r), ``conv_w`` (cw, r), ``lam`` (r,),
    ``w_inp`` and ``w_rec`` (r, r), ``w_out`` (r, d)."""

    SPECS = {"w_x": (None, "model"), "w_gate": (None, "model"),
             "conv_w": (None, "model"), "lam": ("model",),
             "w_inp": (None, "model"), "w_rec": (None, "model"),
             "w_out": ("model", None)}

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d, r, cw = cfg.d_model, cfg.r_dim, cfg.conv_width
        self.w_x = _param((d, r), device, dtype)
        self.w_gate = _param((d, r), device, dtype)
        self.conv_w = _param((cw, r), device, dtype)
        self.lam = _param((r,), device, dtype)
        self.w_inp = _param((r, r), device, dtype)
        self.w_rec = _param((r, r), device, dtype)
        self.w_out = _param((r, d), device, dtype)


_LRU_C = 8.0


def _rglru_gates(p: RGLRU, xb):
    """a_t and the gated input b_t of the recurrence, in xb's dtype."""
    r_t = torch.sigmoid(xb @ p.w_rec)
    i_t = torch.sigmoid(xb @ p.w_inp)
    log_a = -_LRU_C * r_t * F.softplus(p.lam)                 # log a_t < 0
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    b = mult * (i_t * xb)
    return a.to(xb.dtype), b.to(xb.dtype)


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 over axis 1, by a
    Hillis–Steele scan of the pairs (a, b) under (a1, b1) . (a2, b2) =
    (a1 a2, a2 b1 + b2): log2(S) passes of whole-tensor ops.  The same
    operator as the JAX package's ``associative_scan``, applied in
    another order, so equal within rounding."""
    S = a.shape[1]
    step = 1
    while step < S:
        a_prev, b_prev = a[:, :-step], b[:, :-step]
        b = torch.cat([b[:, :step], a[:, step:] * b_prev + b[:, step:]], 1)
        a = torch.cat([a[:, :step], a[:, step:] * a_prev], 1)
        step *= 2
    return b


def rglru_apply_seq(cfg: ModelConfig, kind: str, p: RGLRU, x, ctx: Ctx):
    B, S, d = x.shape
    cw = cfg.conv_width
    xb = x @ p.w_x                                             # (B, S, r)
    gate = gelu(x @ p.w_gate)
    pad = F.pad(xb, (0, 0, cw - 1, 0))       # causal depthwise conv
    conv = sum(pad[:, i:i + S] * p.conv_w[i] for i in range(cw))
    a, b = _rglru_gates(p, conv)
    h = linear_scan(a, b)
    y = (h * gate) @ p.w_out
    cache = None
    if ctx.cache_len:
        cache = {"h": h[:, -1].float(),
                 "conv": pad[:, pad.shape[1] - (cw - 1):]}
    return y, cache


def rglru_apply_dec(cfg: ModelConfig, kind: str, p: RGLRU, x, cache,
                    ctx: Ctx):
    xb = x @ p.w_x                                             # (B, r)
    gate = gelu(x @ p.w_gate)
    hist = torch.cat([cache["conv"], xb[:, None]], dim=1)      # (B, cw, r)
    conv = torch.einsum("bcr,cr->br", hist, p.conv_w)
    a, b = _rglru_gates(p, conv)
    h = a * cache["h"].to(a.dtype) + b
    y = (h * gate) @ p.w_out
    return y, {"h": h.float(), "conv": hist[:, 1:]}


def rglru_init_cache(cfg: ModelConfig, B: int, cache_len: int, dtype,
                     device):
    return {"h": torch.zeros((B, cfg.r_dim), device=device),
            "conv": torch.zeros((B, cfg.conv_width - 1, cfg.r_dim),
                                dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# mLSTM mixer (xLSTM): matrix memory
# ---------------------------------------------------------------------------


class MLSTM(nn.Module):
    """``w_up`` (d, 2 di), ``wq``/``wk``/``wv`` (di, di), ``w_igate`` and
    ``w_fgate`` (di, H), ``skip_gamma`` (di,), ``w_down`` (di, d)."""

    SPECS = {"w_up": (None, "model"), "wq": (None, "model"),
             "wk": (None, "model"), "wv": (None, "model"),
             "w_igate": (None, None), "w_fgate": (None, None),
             "skip_gamma": ("model",), "w_down": ("model", None)}

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d, di, H = cfg.d_model, cfg.mlstm_inner, cfg.n_heads
        self.w_up = _param((d, 2 * di), device, dtype)
        self.wq = _param((di, di), device, dtype)
        self.wk = _param((di, di), device, dtype)
        self.wv = _param((di, di), device, dtype)
        self.w_igate = _param((di, H), device, dtype)
        self.w_fgate = _param((di, H), device, dtype)
        self.skip_gamma = _param((di,), device, dtype)
        self.w_down = _param((di, d), device, dtype)


def _log_sigmoid(x):
    """``F.logsigmoid``; a ``DTensor`` (which has no sharding rule for its
    backward) takes the same function as ``-softplus(-x)``."""
    return -F.softplus(-x) if is_dtensor(x) else F.logsigmoid(x)


def _mlstm_cell(q, k, v, igate, fgate, state):
    """One step; q, k, v (B, H, hd), gate pre-activations (B, H), state
    (C, n, m).  Stabilized exponential gating (xLSTM eqs. 19-27):
    m_t = max(f + m, i), f' = exp(f + m - m_t), i' = exp(i - m_t),
    C_t = f' C + i' v k^T, n_t = f' n + i' k, h = C_t q / max(|n_t q|, 1).
    """
    C, n, m = state
    k = k / math.sqrt(q.shape[-1])
    m_new = torch.maximum(fgate + m, igate)
    fp = torch.exp(fgate + m - m_new)
    ip = torch.exp(igate - m_new)
    C_new = fp[..., None, None] * C + ip[..., None, None] * (
        v[..., :, None] * k[..., None, :])
    n_new = fp[..., None] * n + ip[..., None] * k
    denom = torch.clamp_min(torch.abs(torch.einsum("bhd,bhd->bh", n_new, q)),
                            1.0)
    h = torch.einsum("bhde,bhe->bhd", C_new, q) / denom[..., None]
    return h, (C_new, n_new, m_new)


def _mlstm_state0(B, H, hd, device):
    return (torch.zeros((B, H, hd, hd), device=device),
            torch.zeros((B, H, hd), device=device),
            torch.zeros((B, H), device=device))


def _mlstm_parallel(q, k, v, ig, fg):
    """The quadratic form of the mLSTM over a sequence, with the scan's
    running-max stabilizer m_i = F_i + max(0, cummax_{j<=i}(i_j - F_j)),
    F the cumulative log forget gate (the zero initial state is a virtual
    j = -1 with i = 0, F = 0).  Returns (h (B, S, H, hd), the state after
    the last step)."""
    B, S, H, hd = q.shape
    k = k / math.sqrt(hd)
    Fc = torch.cumsum(fg, dim=1)                                # (B, S, H)
    m = Fc + torch.clamp_min(torch.cummax(ig - Fc, dim=1).values, 0.0)
    logD = Fc[:, :, None, :] - Fc[:, None, :, :] + ig[:, None, :, :] \
        - m[:, :, None, :]                                      # (B, Si, Sj, H)
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    D = torch.where(causal[None, :, :, None], torch.exp(logD), 0.0)
    del logD
    scores = torch.einsum("bihd,bjhd->bijh", q, k) * D
    del D
    denom = torch.clamp_min(torch.abs(scores.sum(dim=2)), 1.0)  # (B, S, H)
    h = torch.einsum("bijh,bjhd->bihd", scores, v) / denom[..., None]
    wC = torch.exp(Fc[:, -1:, :] - Fc + ig - m[:, -1:, :])      # (B, S, H)
    C = torch.einsum("bjh,bjhd,bjhe->bhde", wC, v, k)
    n = torch.einsum("bjh,bjhd->bhd", wC, k)
    return h, (C, n, m[:, -1])


def _mlstm_inputs(cfg: ModelConfig, p: MLSTM, x, shape):
    """(xb, z, q, k, v, igate, log forget gate), the last five float32."""
    up = x @ p.w_up
    xb, z = up.chunk(2, dim=-1)
    q, k, v = (_heads(xb @ w, shape).float() for w in (p.wq, p.wk, p.wv))
    ig = (xb @ p.w_igate).float()
    fg = _log_sigmoid((xb @ p.w_fgate).float())
    return xb, z, q, k, v, ig, fg


def mlstm_apply_seq(cfg: ModelConfig, kind: str, p: MLSTM, x, ctx: Ctx):
    B, S, d = x.shape
    di, H = cfg.mlstm_inner, cfg.n_heads
    hd = di // H
    xb, z, q, k, v, ig, fg = _mlstm_inputs(cfg, p, x, (B, S, H, hd))
    if cfg.mlstm_impl == "parallel":
        h, state = _mlstm_parallel(q, k, v, ig, fg)
        h = _heads(h, (B, S, di)).to(x.dtype)
    else:
        state = _mlstm_state0(B, H, hd, x.device)
        hs = []
        for t in range(S):
            ht, state = _mlstm_cell(q[:, t], k[:, t], v[:, t], ig[:, t],
                                    fg[:, t], state)
            hs.append(ht)
        h = _heads(torch.stack(hs, dim=1), (B, S, di)).to(x.dtype)
    h = rms_norm(h, p.skip_gamma) + xb                          # skip
    y = (h * F.silu(z)) @ p.w_down
    cache = None
    if ctx.cache_len:
        cache = {"C": state[0], "n": state[1], "m": state[2]}
    return y, cache


def mlstm_apply_dec(cfg: ModelConfig, kind: str, p: MLSTM, x, cache,
                    ctx: Ctx):
    B, d = x.shape
    di, H = cfg.mlstm_inner, cfg.n_heads
    xb, z, q, k, v, ig, fg = _mlstm_inputs(cfg, p, x, (B, H, di // H))
    h, state = _mlstm_cell(q, k, v, ig, fg,
                           (cache["C"], cache["n"], cache["m"]))
    h = rms_norm(_heads(h, (B, di)).to(x.dtype), p.skip_gamma) + xb
    y = (h * F.silu(z)) @ p.w_down
    return y, {"C": state[0], "n": state[1], "m": state[2]}


def mlstm_init_cache(cfg: ModelConfig, B: int, cache_len: int, dtype,
                     device):
    C, n, m = _mlstm_state0(B, cfg.n_heads, cfg.mlstm_inner // cfg.n_heads,
                            device)
    return {"C": C, "n": n, "m": m}


# ---------------------------------------------------------------------------
# sLSTM mixer (xLSTM): scalar memory, head-block-diagonal recurrence
# ---------------------------------------------------------------------------

_GATES = ("z", "i", "f", "o")


class SLSTM(nn.Module):
    """``w_z``/``w_i``/``w_f``/``w_o`` (d, d), ``r_z``/``r_i``/``r_f``/
    ``r_o`` (H, hd, hd), the GeGLU ``w_ff_gate`` and ``w_ff_up`` (d, f),
    ``w_ff_down`` (f, d) and ``norm_ff`` (d,)."""

    SPECS = {**{f"w_{g}": (None, "model") for g in _GATES},
             **{f"r_{g}": (None, "model", None) for g in _GATES},
             "w_ff_gate": (None, "model"), "w_ff_up": (None, "model"),
             "w_ff_down": ("model", None), "norm_ff": (None,)}

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d, H = cfg.d_model, cfg.n_heads
        hd, f = d // H, cfg.slstm_hidden
        for g in _GATES:
            setattr(self, f"w_{g}", _param((d, d), device, dtype))
        for g in _GATES:
            setattr(self, f"r_{g}", _param((H, hd, hd), device, dtype))
        self.w_ff_gate = _param((d, f), device, dtype)
        self.w_ff_up = _param((d, f), device, dtype)
        self.w_ff_down = _param((f, d), device, dtype)
        self.norm_ff = _param((d,), device, dtype)


def _slstm_cell(p: SLSTM, xz, xi, xf, xo, state, H, hd):
    """One step; x* (B, d) float32 gate pre-activations from the input,
    state (c, n, h, m) float32."""
    c, n, h, m = state
    hh = h.reshape(h.shape[0], H, hd)

    def rec(r):           # float32, as JAX promotes a bf16 weight here
        return torch.einsum("bhd,hde->bhe", hh, r.float()).reshape(h.shape)
    z = torch.tanh(xz + rec(p.r_z))
    o = torch.sigmoid(xo + rec(p.r_o))
    i_t = xi + rec(p.r_i)
    f_t = _log_sigmoid(xf + rec(p.r_f))
    m_new = torch.maximum(f_t + m, i_t)
    ip = torch.exp(i_t - m_new)
    fp = torch.exp(f_t + m - m_new)
    c_new = fp * c + ip * z
    n_new = fp * n + ip
    h_new = o * c_new / torch.clamp_min(n_new, 1.0)
    return h_new, (c_new, n_new, h_new, m_new)


def _slstm_out(p: SLSTM, h):
    return h + gelu_glu(rms_norm(h, p.norm_ff), p.w_ff_gate, p.w_ff_up,
                        p.w_ff_down)


def slstm_apply_seq(cfg: ModelConfig, kind: str, p: SLSTM, x, ctx: Ctx):
    B, S, d = x.shape
    H = cfg.n_heads
    xz, xi, xf, xo = ((x @ getattr(p, f"w_{g}")).float() for g in _GATES)
    state = tuple(torch.zeros((B, d), device=x.device) for _ in range(4))
    hs = []
    for t in range(S):                       # the JAX package's lax.scan
        ht, state = _slstm_cell(p, xz[:, t], xi[:, t], xf[:, t], xo[:, t],
                                state, H, d // H)
        hs.append(ht)
    y = _slstm_out(p, torch.stack(hs, dim=1).to(x.dtype))
    cache = None
    if ctx.cache_len:
        cache = dict(zip(("c", "n", "h", "m"), state))
    return y, cache


def slstm_apply_dec(cfg: ModelConfig, kind: str, p: SLSTM, x, cache,
                    ctx: Ctx):
    d = x.shape[1]
    H = cfg.n_heads
    xz, xi, xf, xo = ((x @ getattr(p, f"w_{g}")).float() for g in _GATES)
    h, state = _slstm_cell(p, xz, xi, xf, xo,
                           tuple(cache[n] for n in ("c", "n", "h", "m")),
                           H, d // H)
    return _slstm_out(p, h.to(x.dtype)), dict(zip(("c", "n", "h", "m"),
                                                   state))


def slstm_init_cache(cfg: ModelConfig, B: int, cache_len: int, dtype,
                     device):
    return {name: torch.zeros((B, cfg.d_model), device=device)
            for name in ("c", "n", "h", "m")}


# ---------------------------------------------------------------------------
# Block = norm -> mixer -> residual [-> norm -> ffn -> residual]
# ---------------------------------------------------------------------------

# kind -> (module, apply_seq, apply_dec, init_cache)
_MIXER = {
    "attn": (Attention, attn_apply_seq, attn_apply_dec, attn_init_cache),
    "attn_local": (Attention, attn_apply_seq, attn_apply_dec,
                   attn_init_cache),
    "rglru": (RGLRU, rglru_apply_seq, rglru_apply_dec, rglru_init_cache),
    "mlstm": (MLSTM, mlstm_apply_seq, mlstm_apply_dec, mlstm_init_cache),
    "slstm": (SLSTM, slstm_apply_seq, slstm_apply_dec, slstm_init_cache),
}


def _mixer(kind: str) -> str:
    return kind if kind in _MIXER else "attn"


def _has_ffn(cfg: ModelConfig, kind: str) -> bool:
    return cfg.family != "ssm"               # xLSTM blocks are self-contained


def _ffn_is_moe(cfg: ModelConfig, kind: str) -> bool:
    return cfg.n_experts > 0 and kind.startswith("attn")


class Block(nn.Module):
    """One layer: ``norm1`` (d,), ``mixer`` (the kind's module) and, unless
    the family is ``ssm``, ``norm2`` (d,) and ``ffn`` (:class:`FFN`, or
    :class:`MoE` for an attention block of a config with experts)."""

    SPECS = {"norm1": (None,), "norm2": (None,)}

    def __init__(self, cfg: ModelConfig, kind: str, device, dtype):
        super().__init__()
        self.cfg, self.kind = cfg, kind
        self.norm1 = _param((cfg.d_model,), device, dtype)
        self.mixer = _MIXER[_mixer(kind)][0](cfg, device, dtype)
        if _has_ffn(cfg, kind):
            self.norm2 = _param((cfg.d_model,), device, dtype)
            self.ffn = (MoE if _ffn_is_moe(cfg, kind) else FFN)(
                cfg, device, dtype)

    def specs(self):
        """The weights' specs, keyed like ``named_parameters()``."""
        return module_specs(self)


#: the residual stream (B, S, d) between blocks when ``cfg.seq_shard``
_SEQ_SPEC = (AGENT_SLOT, "model", None)


def _scattered(cfg: ModelConfig, h):
    """A mixer's or FFN's output laid out as the residual stream (the
    reduce-scatter of its partial sums when ``cfg.seq_shard``), so that
    its gradient comes back whole for the projections' backward; a plain
    tensor as it is."""
    return constrain(h, _SEQ_SPEC) if cfg.seq_shard else h


def _gathered(x):
    """A mixer's or FFN's input (B, S, d) whole over "model" (the
    all-gather a sequence-sharded residual stream needs before the
    tensor-parallel projections, which GSPMD inserts in the JAX package);
    a plain tensor as it is."""
    return constrain(x, (AGENT_SLOT,) + (None,) * (x.dim() - 1))


def block_apply_seq(cfg: ModelConfig, kind: str, p: Block, x, ctx: Ctx):
    """Returns (x, cache entry, aux float32 0-d: the MoE router loss, 0
    without experts)."""
    if cfg.seq_shard:
        x = constrain(x, _SEQ_SPEC)
    h, cache = _MIXER[_mixer(kind)][1](cfg, kind, p.mixer,
                                       _gathered(rms_norm(x, p.norm1)), ctx)
    x = x + _scattered(cfg, h)
    if cfg.seq_shard:
        x = constrain(x, _SEQ_SPEC)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if _has_ffn(cfg, kind):
        hin = _gathered(rms_norm(x, p.norm2))
        if _ffn_is_moe(cfg, kind):
            h2, aux = moe_apply(cfg, p.ffn, hin)
        else:
            h2 = ffn_apply(cfg, p.ffn, hin)
        x = x + _scattered(cfg, h2)
    return x, cache, aux


def block_apply_dec(cfg: ModelConfig, kind: str, p: Block, x, cache,
                    ctx: Ctx):
    # the inputs whole, as in block_apply_seq: a DTensor residual stream
    # is left a pending sum by the row-parallel projections, which
    # DTensor's index_add_ rule (the MoE dispatch) does not sum right
    h, cache = _MIXER[_mixer(kind)][2](cfg, kind, p.mixer,
                                       _gathered(rms_norm(x, p.norm1)),
                                       cache, ctx)
    x = x + h
    if _has_ffn(cfg, kind):
        hin = _gathered(rms_norm(x, p.norm2))
        if _ffn_is_moe(cfg, kind):
            h2 = moe_apply(cfg, p.ffn, hin[:, None, :])[0][:, 0]
        else:
            h2 = ffn_apply(cfg, p.ffn, hin)
        x = x + h2
    return x, cache


def block_init_cache(cfg: ModelConfig, kind: str, B: int, cache_len: int,
                     dtype, device):
    return _MIXER[_mixer(kind)][3](cfg, B, cache_len, dtype, device)


# ---------------------------------------------------------------------------
# Cache specs (the JAX package's *_cache_pspecs)
# ---------------------------------------------------------------------------


def block_cache_specs(cfg: ModelConfig, kind: str):
    """The specs of one layer's cache entry: batch over the agent slot;
    the kv cache's sequence (``kv_shard="seq"``, split-KV) or head dim
    (``"heads"``) over "model"; the recurrent states' width over
    "model"."""
    a = AGENT_SLOT
    mixer = _mixer(kind)
    if mixer in ("attn", "attn_local"):
        s = (a, None, None, "model") if cfg.kv_shard == "heads" \
            else (a, "model", None, None)
        return {"k": s, "v": s}
    if mixer == "rglru":
        return {"h": (a, "model"), "conv": (a, None, "model")}
    if mixer == "mlstm":
        return {"C": (a, None, "model", None), "n": (a, None, "model"),
                "m": (a, None)}
    return {name: (a, "model") for name in ("c", "n", "h", "m")}
