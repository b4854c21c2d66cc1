"""granite-moe-1b-a400m — 32-expert top-8 MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

24L, d_model=1024, 16 heads (GQA kv=8), d_ff=512 per expert, vocab=49155,
MoE 32e top-8 on every layer. EP dispatch: 2 experts per model shard, BSP
sort routing (the paper technique, first-class).
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab=49155,
    moe_experts=32, moe_top_k=8,
    param_sharding="1d",
))
