"""Attention forms in plain PyTorch (counterpart of
``repro.models.attention``).

* ``ref_attention``     — dense softmax attention (small shapes, oracle);
* ``chunked_attention`` — online softmax over kv chunks, O(S * chunk)
                          memory;
* ``decode_attention``  — one query token against a (possibly
                          ring-buffered) kv cache.

All take grouped kv heads (K | H; query head h reads kv head h // (H // K))
and an optional sliding window, and compute what their JAX namesakes
compute: logits in float32 scaled by ``hd ** -0.5``, masked pairs at
``NEG_INF``, softmax in float32, the weights rounded to v's dtype before
they multiply v.  The causal prefill of the ``flash`` route goes through
the ``attention`` op instead (``kernels.dispatch``).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _expand_kv(k, n_heads: int):
    """(B, S, K, hd) -> (B, S, H, hd) by repeating each kv head H/K times."""
    n_kv = k.shape[-2]
    if n_kv == n_heads:
        return k
    return k.repeat_interleave(n_heads // n_kv, dim=-2)


def _mask(q_pos, k_pos, window: Optional[int]):
    """Causal (+ optional sliding window) mask: True = attend."""
    m = k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m


def ref_attention(q, k, v, *, q_pos=None, k_pos=None,
                  window: Optional[int] = None, causal: bool = True):
    """q: (B, Sq, H, hd), k/v: (B, Sk, K, hd) -> (B, Sq, H, hd)."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * hd ** -0.5
    if causal or window is not None:
        dev = q.device
        qp = torch.arange(Sq, device=dev) if q_pos is None else q_pos
        kp = torch.arange(Sk, device=dev) if k_pos is None else k_pos
        m = _mask(qp, kp, window) if causal else (
            kp[None, :] > qp[:, None] - window)
        logits = torch.where(m[None, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def chunked_attention(q, k, v, *, window: Optional[int] = None,
                      chunk: int = 512):
    """Causal self-attention by online softmax over kv chunks; equal to
    ``ref_attention(causal=True)``, which it falls back to when
    ``S % chunk != 0``."""
    B, S, H, hd = q.shape
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    if S % chunk != 0:
        return ref_attention(q, k, v, window=window)
    scale = hd ** -0.5
    dev = q.device
    q_pos = torch.arange(S, device=dev)
    qf = q.float()
    o = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    for idx in range(S // chunk):
        kb = k[:, idx * chunk:(idx + 1) * chunk]
        vb = v[:, idx * chunk:(idx + 1) * chunk]
        k_pos = idx * chunk + torch.arange(chunk, device=dev)
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float()) * scale
        msk = _mask(q_pos, k_pos, window)                # (S, chunk)
        logits = torch.where(msk[None, None], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = (o * alpha.transpose(1, 2)[..., None]
             + torch.einsum("bhqk,bkhd->bqhd", p.to(vb.dtype), vb))
        m = m_new
    l = torch.clamp_min(l, 1e-20)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def decode_attention(q, k_cache, v_cache, pos, *,
                     window: Optional[int] = None, ring: bool = False):
    """One-token decode: q (B, H, hd) against a cache (B, Sc, K, hd).

    ``pos`` is the (scalar or (B,)) absolute position of the new token.
    ``ring=True``: the cache is a ring buffer of size Sc holding the last Sc
    tokens — slot s holds absolute position ``pos - ((pos - s) mod Sc)``,
    valid if it is >= 0 and > ``pos - window``.  Query heads are grouped
    over their kv head instead of repeating the cache (the same sums).
    """
    B, Sc, K, hd = k_cache.shape
    H = q.shape[1]
    G = H // K
    qg = q.reshape(B, K, G, hd).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) \
        .reshape(B, H, Sc) * hd ** -0.5
    pos = torch.as_tensor(pos, device=q.device)
    pos_b = torch.broadcast_to(pos, (B,))[:, None]               # (B, 1)
    slots = torch.arange(Sc, device=q.device)[None, :]           # (1, Sc)
    if ring:
        abs_pos = pos_b - torch.remainder(pos_b - slots, Sc)
    else:
        abs_pos = slots * torch.ones_like(pos_b)
    valid = (abs_pos >= 0) & (abs_pos <= pos_b)
    if window is not None:
        valid &= abs_pos > pos_b - window
    logits = torch.where(valid[:, None, :], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgs,bskd->bkgd", w.reshape(B, K, G, Sc), v_cache)
    return out.reshape(B, H, hd)
