"""internlm2-20b — dense GQA LM [arXiv:2403.17297; hf].

48L, d_model=6144, 48 heads, GQA kv=8, d_ff=16384, vocab=92544.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92544,
    param_sharding="2d", microbatches=2,
))
