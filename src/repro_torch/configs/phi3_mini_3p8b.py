"""phi3-mini-3.8b — dense RoPE/SwiGLU/GQA LM [arXiv:2404.14219; unverified].

32L, d_model=3072, 32 heads (kv=32), d_ff=8192, vocab=32064.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32064,
    param_sharding="1d",
))
