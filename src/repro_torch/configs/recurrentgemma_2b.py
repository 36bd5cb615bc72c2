"""RecurrentGemma-2B — Griffin: RG-LRU + local attention, 1 attn : 2 rec,
MQA (kv=1), head_dim 256, GeGLU d_ff=7680, local window 2048
[arXiv:2402.19427]. 26L = (rec,rec,attn) x 8 + (rec,rec)."""
from repro_torch.models.common import ModelConfig

_PATTERN = ("rglru", "rglru", "attn_local") * 8 + ("rglru", "rglru")

FULL = ModelConfig(
    name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, d_ff=7680, vocab_size=256000,
    rope_theta=10000.0, ffn_kind="geglu", pattern=_PATTERN,
    local_window=2048, conv_width=4, lru_dim=2560)

REDUCED = ModelConfig(
    name="recurrentgemma-2b-reduced", family="hybrid", n_layers=3,
    d_model=256, n_heads=2, n_kv_heads=1, d_ff=512, vocab_size=512,
    rope_theta=10000.0, ffn_kind="geglu",
    pattern=("rglru", "rglru", "attn_local"),
    local_window=16, conv_width=4, lru_dim=256, attn_impl="ref", remat=False)
