"""deepseek-7b — dense llama-arch LM [arXiv:2401.02954; hf].

30L, d_model=4096, 32 heads (GQA kv=32 ⇒ effectively MHA), d_ff=11008,
vocab=102400. BSP-sort technique applies outside the layer stack only
(data-pipeline bucketing, serving top-k) — see DESIGN.md §Arch-applicability.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=102400,
    param_sharding="2d", microbatches=2,
))
