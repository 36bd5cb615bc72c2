"""The assigned input shapes and the per-(arch, shape) serving plan
(counterpart of ``repro.launch.shapes``).

Decode shapes run ``decode_step`` (one token against a seq_len-deep cache
or recurrent state); train and prefill shapes run a training step or
``prefill``.

long_500k: recurrent and hybrid archs decode natively with O(1) state;
attention archs use their sliding window (native for starcoder2 and
recurrentgemma, ``cfg.long_ctx_window`` otherwise), so the kv ring buffer
is window-sized.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                     # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ServePlan:
    """How an (arch, decode-shape) pair is served."""
    cache_len: int
    ring: bool
    window: Optional[int]         # attention window override


def plan_decode(cfg: ModelConfig, shape: InputShape) -> ServePlan:
    assert shape.mode == "decode"
    native_w = cfg.window
    if shape.seq_len > 65536:
        # long context: attention archs take their sliding-window variant
        w = native_w if native_w is not None else cfg.long_ctx_window
        has_attn = any(k.startswith("attn") for k in cfg.layer_kinds)
        if not has_attn:
            return ServePlan(cache_len=1, ring=False, window=None)
        return ServePlan(cache_len=min(shape.seq_len, w), ring=True, window=w)
    if native_w is not None and native_w < shape.seq_len:
        return ServePlan(cache_len=native_w, ring=True, window=native_w)
    return ServePlan(cache_len=shape.seq_len, ring=False, window=native_w)


def train_seq_len(cfg: ModelConfig, shape: InputShape) -> int:
    """The total sequence (the media or conditioning prefix included) is
    the assigned seq_len."""
    return shape.seq_len
