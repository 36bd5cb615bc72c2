"""Llama-3-8B — dense, GQA kv=8, 128k vocab [arXiv:2407.21783]."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="llama3-8b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=128256,
    rope_theta=500000.0, ffn_kind="swiglu")

REDUCED = ModelConfig(
    name="llama3-8b-reduced", family="dense", n_layers=2, d_model=256,
    n_heads=8, n_kv_heads=2, d_ff=512, vocab_size=512,
    rope_theta=500000.0, ffn_kind="swiglu", attn_impl="ref", remat=False)
