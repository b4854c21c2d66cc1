"""tinyllama-1.1b — small llama2-arch LM [arXiv:2401.02385; hf].

22L, d_model=2048, 32 heads, GQA kv=4, d_ff=5632, vocab=32000.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=5632, vocab=32000,
    param_sharding="dp", remat=False,  # §Perf A2/A3: pure-DP + no remat
))
