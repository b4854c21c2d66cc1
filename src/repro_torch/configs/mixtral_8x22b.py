"""mixtral-8x22b — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088; hf].

56L, d_model=6144, 48 heads (GQA kv=8), d_ff=16384 per expert, vocab=32768,
MoE 8e top-2 every layer, SWA window 4096. E=8 < model-axis 16 ⇒ TP-MoE
path: experts replicated, FFN hidden dim TP-sharded, tokens grouped by the
BSP integer sort (grouped-GEMM dispatch). SWA ⇒ sub-quadratic ⇒ long_500k.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=32768,
    moe_experts=8, moe_top_k=2,
    sliding_window=4096,
    param_sharding="2d", microbatches=1,  # §Perf B2: fewer FSDP re-gathers
))
