"""StarCoder2-15B — dense, GQA kv=4, RoPE, native 4k sliding window
[arXiv:2402.19173]."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="starcoder2-15b", family="dense", n_layers=40, d_model=6144,
    n_heads=48, n_kv_heads=4, d_ff=24576, vocab_size=49152,
    rope_theta=100000.0, ffn_kind="gelu", window=4096)

REDUCED = ModelConfig(
    name="starcoder2-15b-reduced", family="dense", n_layers=2, d_model=256,
    n_heads=8, n_kv_heads=2, d_ff=512, vocab_size=512,
    rope_theta=100000.0, ffn_kind="gelu", window=16, attn_impl="ref",
    remat=False)
