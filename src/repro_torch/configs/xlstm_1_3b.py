"""xLSTM-1.3B — sLSTM + mLSTM blocks, ratio 7:1 per the paper's xLSTM[7:1]
[arXiv:2405.04517]. d_ff=0: blocks carry their own projections."""
from repro_torch.models.common import ModelConfig

# 48 layers = 6 x (7 mLSTM + 1 sLSTM)
_PATTERN = (("mlstm",) * 7 + ("slstm",)) * 6

# mlstm_impl="parallel": training uses the quadratic parallel form (exactly
# equivalent to the recurrent scan -- tests/test_parallel_forms.py). Backprop
# through a 4096-step materialized-state scan checkpoints every step's
# (B,H,hd,hd) matrix memory: measured 23 TB/device temp in the dry-run
# (EXPERIMENTS.md #Perf B0). Decode always uses the O(1)-state recurrent cell.
FULL = ModelConfig(
    name="xlstm-1.3b", family="ssm", n_layers=48, d_model=2048,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=50304,
    pattern=_PATTERN, mlstm_proj_factor=2.0, mlstm_impl="parallel")

REDUCED = ModelConfig(
    name="xlstm-1.3b-reduced", family="ssm", n_layers=2, d_model=128,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=512,
    pattern=("mlstm", "slstm"), mlstm_proj_factor=2.0, remat=False)
