"""Qwen2-VL-7B — VLM backbone with M-RoPE, GQA kv=4, dynamic resolution
[arXiv:2409.12191]. Vision encoder (ViT) is a sanctioned stub: the batch
carries precomputed patch embeddings (DESIGN.md §5)."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="qwen2-vl-7b", family="vlm", n_layers=28, d_model=3584,
    n_heads=28, n_kv_heads=4, d_ff=18944, vocab_size=152064,
    rope_theta=1000000.0, ffn_kind="swiglu",
    mrope_sections=(16, 24, 24), n_media_tokens=256)

REDUCED = ModelConfig(
    name="qwen2-vl-7b-reduced", family="vlm", n_layers=2, d_model=256,
    n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=512,
    rope_theta=1000000.0, ffn_kind="swiglu",
    mrope_sections=(8, 12, 12), n_media_tokens=8, attn_impl="ref",
    remat=False)
