"""Phi-3.5-MoE (42B total / 6.6B active) — 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=6400, vocab_size=32064,
    n_experts=16, top_k=2, capacity_factor=1.25,
    rope_theta=10000.0, ffn_kind="swiglu")

REDUCED = ModelConfig(
    name="phi3.5-moe-reduced", family="moe", n_layers=2, d_model=256,
    n_heads=8, n_kv_heads=2, d_ff=256, vocab_size=512,
    n_experts=4, top_k=2, capacity_factor=1.25,
    rope_theta=10000.0, ffn_kind="swiglu", attn_impl="ref", remat=False)
