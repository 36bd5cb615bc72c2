"""Shared model machinery: the config and the basic layers
(counterpart of ``repro.models.common``).

``ModelConfig`` is a copy of the JAX package's, field for field and default
for default, with torch dtypes in place of ``jnp`` ones.  The layers are
plain functions on tensors and compute what their JAX namesakes compute:
``rms_norm``, ``apply_rope`` and ``apply_mrope`` in float32, cast back to
the input's dtype, and the training loss ``cross_entropy``.
``init_leaf`` is the JAX package's initialisation rule (``_init_leaf``)
drawn from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    rope_theta: float = 10000.0
    # attention windowing: None = full causal
    window: Optional[int] = None
    long_ctx_window: int = 4096
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_seq_shard: bool = False
    moe_impl: str = "scatter"
    # hybrid (recurrentgemma / griffin)
    pattern: Tuple[str, ...] = ()    # per-layer mixer kinds; () -> all "attn"
    local_window: int = 2048
    conv_width: int = 4
    lru_dim: Optional[int] = None
    # ssm (xlstm)
    mlstm_proj_factor: float = 2.0
    slstm_ff: int = 0
    mlstm_impl: str = "scan"
    # vlm
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    n_media_tokens: int = 0
    # audio
    n_codebooks: int = 1
    n_cond_tokens: int = 0
    # ffn
    ffn_kind: str = "swiglu"         # swiglu | geglu | gelu
    # numerics / implementation
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    attn_impl: str = "chunked"       # ref | chunked | flash
    attn_chunk: int = 512
    remat: bool = True
    scan_layers: bool = True
    seq_shard: bool = True
    kv_shard: str = "seq"

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None \
            else self.d_model // self.n_heads

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        if self.pattern:
            assert len(self.pattern) == self.n_layers
            return self.pattern
        return ("attn",) * self.n_layers

    @property
    def r_dim(self) -> int:
        return self.lru_dim if self.lru_dim is not None else self.d_model

    @property
    def mlstm_inner(self) -> int:
        return int(self.mlstm_proj_factor * self.d_model)

    @property
    def slstm_hidden(self) -> int:
        if self.slstm_ff:
            return self.slstm_ff
        return int(math.ceil(self.d_model * 4 / 3 / 128) * 128)

    def scan_groups(self) -> Tuple[Tuple[Tuple[str, ...], int], ...]:
        """Decompose the layer stack into (unit, repetitions) groups: the
        shortest repeating unit, and a non-multiple tail as its own group
        (the JAX package stacks each group's weights over repetitions)."""
        kinds = self.layer_kinds
        L = len(kinds)
        for ulen in range(1, L + 1):
            unit = kinds[:ulen]
            reps = L // ulen
            if kinds[:ulen * reps] == unit * reps:
                tail = kinds[ulen * reps:]
                groups = [(unit, reps)]
                if tail:
                    groups.append((tail, 1))
                return tuple(groups)
        return ((kinds, 1),)


# ---------------------------------------------------------------------------
# Parameter initialisation
# ---------------------------------------------------------------------------

#: leaves whose normal draw is scaled by a constant, not 1/sqrt(fan_in)
#: (the ``scale=`` of the JAX package's ParamDefs; ``embed`` of every
#: family, the MoE router and the mLSTM gates)
INIT_SCALE = {"embed": 0.02, "router": 0.02, "w_igate": 0.02,
              "w_fgate": 0.02}
#: leaves of other init kinds: the RG-LRU's Lambda; every other 1-D leaf
#: (the norms' gammas, ``skip_gamma``, ``norm_ff``) is zero
LRU_LAMBDA = "lam"


def init_leaf(name: str, shape, generator: torch.Generator, device,
              stacked: int = 0):
    """One float32 leaf by the JAX package's rule (``_init_leaf``), drawn
    from ``generator`` on ``device``: ``name`` is the leaf's last key and
    ``stacked`` the number of leading repetition dims (the rule reads the
    shape without them).  ``lam`` (RG-LRU): ``log(u / (1 - u))`` with u
    uniform in [0.9, 0.999], so that ``sigmoid(lam)`` is; other 1-D leaves
    zero; ``normal * scale`` otherwise, scale from :data:`INIT_SCALE` or
    ``1 / sqrt(fan_in)`` with fan_in the second-to-last dim.  The draws
    differ from ``jax.random``'s."""
    if name == LRU_LAMBDA:
        u = torch.rand(shape, generator=generator, device=device) \
            * (0.999 - 0.9) + 0.9
        return torch.log(u / (1.0 - u))
    if len(shape) - stacked == 1:
        return torch.zeros(shape, device=device)
    scale = INIT_SCALE.get(name, 1.0 / math.sqrt(max(shape[-2], 1)))
    return torch.randn(shape, generator=generator, device=device).mul_(scale)


# ---------------------------------------------------------------------------
# Basic layers
# ---------------------------------------------------------------------------


def rms_norm(x, gamma, eps: float = 1e-6):
    """RMS norm in float32 with scale ``1 + gamma``, cast back to x's
    dtype."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps))
            * (1.0 + gamma.float())).to(x.dtype)


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def gelu_glu(x, w_gate, w_up, w_down):
    return (gelu(x @ w_gate) * (x @ w_up)) @ w_down


def rope_freqs(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x, positions, theta: float):
    """Rotary embedding, rotate-half split form, in float32.

    x: (..., S, H, hd); positions: broadcastable to (..., S).
    """
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # (hd/2,)
    ang = positions[..., None].float() * freqs                 # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, theta: float, sections: Tuple[int, int, int]):
    """Qwen2-VL multimodal RoPE, in float32.

    x: (B, S, H, hd); positions3: (3, B, S), the temporal, height and
    width position ids.  The hd/2 frequency slots are split into
    ``sections`` (summing to hd/2), and each takes its angle from its own
    plane's ids; text tokens carry the same id in all three planes, so for
    them it is RoPE.
    """
    hd = x.shape[-1]
    assert sum(sections) == hd // 2, (sections, hd)
    freqs = rope_freqs(hd, theta, x.device)                    # (hd/2,)
    ang_all = positions3[..., None].float() * freqs            # (3, B, S, hd/2)
    owner = torch.repeat_interleave(
        torch.arange(3, device=x.device),
        torch.as_tensor(sections, device=x.device))            # (hd/2,)
    slot = torch.arange(hd // 2, device=x.device)
    ang = ang_all[owner, ..., slot].movedim(0, -1)             # (B, S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def cross_entropy(logits, labels, mask=None):
    """Mean cross-entropy over valid positions, in float32; labels < 0
    (and positions where ``mask`` is False) are ignored."""
    valid = labels >= 0 if mask is None else mask & (labels >= 0)
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = torch.where(valid, logz - gold, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)
