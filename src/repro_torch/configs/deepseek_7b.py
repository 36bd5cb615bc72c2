"""DeepSeek-LLM 7B — dense llama-arch, MHA (kv=heads) [arXiv:2401.02954]."""
from repro_torch.models.common import ModelConfig

FULL = ModelConfig(
    name="deepseek-7b", family="dense", n_layers=30, d_model=4096,
    n_heads=32, n_kv_heads=32, d_ff=11008, vocab_size=102400,
    rope_theta=10000.0, ffn_kind="swiglu")

REDUCED = ModelConfig(
    name="deepseek-7b-reduced", family="dense", n_layers=2, d_model=256,
    n_heads=8, n_kv_heads=8, d_ff=512, vocab_size=512,
    rope_theta=10000.0, ffn_kind="swiglu", attn_impl="ref", remat=False)
