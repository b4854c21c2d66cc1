"""xlstm-350m — sLSTM + mLSTM block stack [arXiv:2405.04517; unverified].

24 blocks, d_model=1024, 4 heads, vocab=50304, no FFN (d_ff=0 — xLSTM
blocks carry their own up/down projections). Every 8th block is sLSTM
(scalar memory, exponential gating); the rest mLSTM (matrix memory,
linear-attention-like). Attention-free ⇒ the sort technique is in-layer
inapplicable (DESIGN.md §Arch-applicability); sub-quadratic ⇒ long_500k runs.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    slstm_every=8,
    param_sharding="dp",  # §Perf A2 regime: replicate 0.3B, shard batch
))
