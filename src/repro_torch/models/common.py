"""Shared model machinery: the config and the basic layers
(counterpart of ``repro.models.common``).

``ModelConfig`` is a copy of the JAX package's, field for field and default
for default, with torch dtypes in place of ``jnp`` ones.  The layers are
plain functions on tensors and compute what their JAX namesakes compute:
``rms_norm``, ``apply_rope`` and ``apply_mrope`` in float32, cast back to
the input's dtype, and the training loss ``cross_entropy``.
``init_leaf`` is the JAX package's initialisation rule (``_init_leaf``)
drawn from a ``torch.Generator``.

Sharding specs: a spec is a plain tuple with one entry per tensor dim,
each ``None``, a mesh axis name or a tuple of axis names (the JAX
package's ``PartitionSpec`` read as a tuple).  The specs of the model's
leaves are written against the multi-pod axes ("pod", "data", "model");
``adapt_spec`` drops the axes a mesh lacks, and ``constrain`` is the
counterpart of ``with_sharding_constraint``: it redistributes a
``DTensor`` to a spec's placements and returns a plain tensor as it is.
"""

from __future__ import annotations

import contextlib
import contextvars
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
        torch.as_tensor(sections, device=x.device),
        output_size=hd // 2)                                   # (hd/2,)
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
    (and positions where ``mask`` is False) are ignored.

    Logits that are a ``DTensor`` (the dry run's vocabulary-sharded head)
    go through ``F.cross_entropy``, which torch's ``loss_parallel``
    computes on the shards; the caller enters that context, around the
    backward pass too."""
    valid = labels >= 0 if mask is None else mask & (labels >= 0)
    if is_dtensor(logits):
        lab = torch.where(valid, labels, -100).long()
        total = F.cross_entropy(logits.float().flatten(0, -2),
                                lab.flatten(), ignore_index=-100,
                                reduction="sum")
        return total / valid.sum().clamp(min=1)
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = torch.where(valid, logz - gold, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)


# ---------------------------------------------------------------------------
# Sharding specs (counterpart of the JAX package's PartitionSpecs)
# ---------------------------------------------------------------------------

#: the agent (batch) slot of the specs: the axes agents are laid out over
AGENT_SLOT = ("pod", "data")

# Which mesh axes the agent (batch) slot of an activation constraint maps
# to: ("pod", "data") when the batch spans the agents; () inside a
# per-agent program, where each device holds one agent's batch
_BATCH_AXES = contextvars.ContextVar("repro_torch_batch_axes",
                                     default=AGENT_SLOT)


@contextlib.contextmanager
def batch_axes(names):
    """Map the agent slot of ``constrain``'s specs to ``names`` inside
    the block (``()``: the per-agent program, the slot unsharded)."""
    token = _BATCH_AXES.set(tuple(names))
    try:
        yield
    finally:
        _BATCH_AXES.reset(token)


def resolve_agent_slot(spec, agent):
    """``spec`` with its agent slot mapped to the axes ``agent`` (``()``:
    the slot unsharded)."""
    return tuple((agent or None) if entry == AGENT_SLOT else entry
                 for entry in spec)


def adapt_spec(spec, axis_names):
    """Drop the axes ``axis_names`` lacks from ``spec``: an entry of one
    kept axis becomes that name, of none ``None`` (so ("pod", "data")
    becomes "data" on a one-pod mesh)."""
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in axis_names)
            out.append(kept[0] if len(kept) == 1 else (kept or None))
        else:
            out.append(entry if entry in axis_names else None)
    return tuple(out)


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed.tensor.DTensor`` (without
    importing torch.distributed)."""
    return hasattr(x, "device_mesh") and hasattr(x, "to_local")


def split_local(x):
    """``(local, like)``: a ``DTensor``'s local shard and the ``DTensor``
    itself, or ``(x, None)`` for any other tensor."""
    return (x.to_local(), x) if is_dtensor(x) else (x, None)


def like_local(local, like):
    """``local`` laid out as ``like`` (:func:`split_local`'s second
    value): a ``DTensor`` on ``like``'s mesh and placements, or ``local``
    itself when ``like`` is None."""
    if like is None:
        return local
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False)


def spec_placements(spec, mesh_dim_names):
    """The DTensor placements of ``spec`` on a mesh with these dim names:
    ``Shard(d)`` on each mesh dim an entry of dim d names, ``Replicate()``
    on the others."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, entry in enumerate(spec):
        names = entry if isinstance(entry, (tuple, list)) else (entry,)
        for name in names:
            if name is not None:
                where[name] = d  # scatter: unique targets (one dim an axis)
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in mesh_dim_names)


def constrain(x, spec):
    """Hold ``x`` to ``spec`` (the JAX package's sharding constraint): a
    ``DTensor`` is redistributed to the spec's placements on its own mesh
    (the agent slot resolved by :func:`batch_axes`, axes the mesh lacks
    dropped, a dim its axes do not divide left whole); any other tensor
    is returned as it is."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.mesh.shape))
    spec = adapt_spec(resolve_agent_slot(spec, _BATCH_AXES.get()), names)

    def divides(n, entry):
        axes = entry if isinstance(entry, tuple) else (entry,)
        return n % math.prod(sizes[a] for a in axes) == 0
    spec = tuple(e if e is None or divides(n, e) else None
                 for n, e in zip(x.shape, spec))
    # redistributed even when already laid out so: its backward lays the
    # gradient out the same way
    return x.redistribute(mesh, spec_placements(spec, names))
