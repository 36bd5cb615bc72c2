"""Collective traffic and roofline terms of a dry-run step (counterpart of
``repro.launch.hlo_analysis``, named for what it does here).

The JAX package parses the compiled HLO text for its collectives; the
port's dry run records each collective where it is dispatched (kind,
count, result bytes; ``launch.dryrun``), and :func:`collective_stats`
sums those records.  Wire bytes per device use the ring-algorithm
factors; the roofline, the model-FLOP counts and the score-traffic
estimate keep the JAX package's formulas.

Hardware constants: one NVIDIA H100 SXM (a DGX H100 node holds eight):

* ``PEAK_FLOPS`` 989e12 bf16 FLOP/s, dense (NVIDIA H100 data sheet,
  SXM5, "BF16 Tensor Core 1,979 teraFLOPS" with sparsity, half without);
* ``HBM_BW`` 3.35e12 B/s (the data sheet's HBM3 bandwidth, SXM5);
* ``LINK_BW`` 50e9 B/s (one 400 Gb/s ConnectX-7 InfiniBand NDR port a
  GPU in a DGX H100).

A 16-wide "model" axis spans two 8-GPU nodes, and the agent axes span
nodes too, so a ring over either is held to the network's rate, not to
NVLink 4's 450e9 B/s a direction inside a node.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Tuple

PEAK_FLOPS = 989e12          # bf16 dense / GPU
HBM_BW = 3.35e12             # bytes / s / GPU
LINK_BW = 50e9               # bytes / s / GPU across nodes

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# ring-algorithm wire factor per unit of *result* bytes
WIRE_FACTOR = {
    "all-gather": 1.0,          # each device receives (n-1)/n of the result
    "all-reduce": 2.0,          # reduce-scatter + all-gather
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def collective_stats(records: Iterable[Tuple[str, float]]
                     ) -> Dict[str, Dict[str, float]]:
    """Per-kind result bytes, wire-model bytes and counts of the
    collectives ``records`` lists as ``(kind, result_bytes)``."""
    stats = {k: {"count": 0, "result_bytes": 0.0, "wire_bytes": 0.0}
             for k in COLLECTIVES}
    for kind, b in records:
        stats[kind]["count"] += 1
        stats[kind]["result_bytes"] += b
        stats[kind]["wire_bytes"] += b * WIRE_FACTOR[kind]
    return stats


@dataclasses.dataclass
class Roofline:
    flops: float                 # per device
    hbm_bytes: float
    collective_bytes: float      # wire-model bytes, per device
    n_devices: int
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    def as_dict(self):
        return {**dataclasses.asdict(self), "dominant": self.dominant}


def roofline_terms(cost: Dict[str, float], coll: Dict[str, Dict[str, float]],
                   n_devices: int, links_per_chip: float = 1.0) -> Roofline:
    """Three roofline terms in seconds from per-device ``cost``
    (``flops``, ``bytes accessed``) and collective stats, at an H100's
    rates."""
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    wire = sum(v["wire_bytes"] for v in coll.values())
    return Roofline(
        flops=flops, hbm_bytes=hbm, collective_bytes=wire,
        n_devices=n_devices,
        compute_s=flops / PEAK_FLOPS,
        memory_s=hbm / HBM_BW,
        collective_s=wire / (LINK_BW * links_per_chip),
    )


def score_traffic_estimate(cfg, shape, n_agents: int, tp: int = 16) -> float:
    """Per-device HBM bytes of materialized attention / mLSTM score
    matrices: one float32 score tensor written and read about 3x in the
    forward pass, and about 3x more in a rematerialized backward (train
    only).  A kernel that keeps the scores on chip (``flash_attention``)
    saves them; ``cost_bytes_flash`` is ``cost_bytes`` less this."""
    S = shape.seq_len
    B_dev = max(shape.global_batch // n_agents, 1)
    mult = {"train": 6.0, "prefill": 3.0, "decode": 0.0}[shape.mode]
    if mult == 0.0:
        return 0.0
    total = 0.0
    for kind in cfg.layer_kinds:
        if kind.startswith("attn"):
            w = cfg.local_window if kind == "attn_local" else cfg.window
            kdim = min(S, w) if w else S
            h_dev = max(cfg.n_heads // tp, 1)
            total += B_dev * h_dev * S * kdim * 4.0 * mult
        elif kind == "mlstm":
            # logD + D + scores: ~3 (B,S,S,H) f32 tensors, heads unsharded
            total += B_dev * cfg.n_heads * S * S * 4.0 * mult * 2.0
    return total


def model_flops_train(n_params: int, n_tokens: int,
                      active_params: int = 0) -> float:
    """6 N D (dense) / 6 N_active D (MoE): forward and backward a token."""
    n = active_params or n_params
    return 6.0 * n * n_tokens


def model_flops_decode(n_params: int, n_tokens: int,
                       active_params: int = 0) -> float:
    """2 N D for a forward pass (decode or prefill)."""
    n = active_params or n_params
    return 2.0 * n * n_tokens
