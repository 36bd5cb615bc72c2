"""Minitron-8B — width/depth-pruned Nemotron-4, GQA kv=8, 256k vocab
[arXiv:2407.14679]."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="minitron-8b", family="dense", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=16384, vocab_size=256000,
    rope_theta=10000.0, ffn_kind="swiglu")

REDUCED = ModelConfig(
    name="minitron-8b-reduced", family="dense", n_layers=2, d_model=256,
    n_heads=8, n_kv_heads=2, d_ff=512, vocab_size=512,
    rope_theta=10000.0, ffn_kind="swiglu", attn_impl="ref", remat=False)
