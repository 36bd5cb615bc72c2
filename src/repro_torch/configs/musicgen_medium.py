"""MusicGen-medium — decoder-only over EnCodec tokens, 4 codebooks with
delay pattern, text conditioning as prefix embeddings (stub frontend)
[arXiv:2306.05284]."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="musicgen-medium", family="audio", n_layers=48, d_model=1536,
    n_heads=24, n_kv_heads=24, d_ff=6144, vocab_size=2048,
    rope_theta=10000.0, ffn_kind="gelu", n_codebooks=4, n_cond_tokens=64)

REDUCED = ModelConfig(
    name="musicgen-medium-reduced", family="audio", n_layers=2, d_model=256,
    n_heads=8, n_kv_heads=8, d_ff=512, vocab_size=128,
    rope_theta=10000.0, ffn_kind="gelu", n_codebooks=4, n_cond_tokens=8,
    attn_impl="ref", remat=False)
