"""OLMoE-1B-7B — MoE, 64 experts top-8, per-expert d_ff=1024
[arXiv:2409.02060]."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="olmoe-1b-7b", family="moe", n_layers=16, d_model=2048,
    n_heads=16, n_kv_heads=16, d_ff=1024, vocab_size=50304,
    n_experts=64, top_k=8, capacity_factor=1.25,
    rope_theta=10000.0, ffn_kind="swiglu")

REDUCED = ModelConfig(
    name="olmoe-1b-7b-reduced", family="moe", n_layers=2, d_model=256,
    n_heads=8, n_kv_heads=8, d_ff=128, vocab_size=512,
    n_experts=4, top_k=2, capacity_factor=1.25,
    rope_theta=10000.0, ffn_kind="swiglu", attn_impl="ref", remat=False)
