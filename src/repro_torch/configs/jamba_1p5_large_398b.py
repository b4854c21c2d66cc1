"""jamba-1.5-large-398b — Mamba+attention 1:7 hybrid MoE [arXiv:2403.19887; hf].

72L, d_model=8192, 64 heads (GQA kv=8), d_ff=24576, vocab=65536; MoE 16
experts top-2 on every second layer; attention every 8th layer (1:7
interleave), the rest Mamba (S6) blocks. Sub-quadratic ⇒ long_500k runs.

The BSP sort is first-class here twice: EP token dispatch (16 experts over
the 16-way model axis) and the Mamba-free attention layers' decode path.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=24576, vocab=65536,
    moe_experts=16, moe_top_k=2, moe_every=2,
    attn_period=8, mamba_d_state=16, mamba_expand=2, mamba_d_conv=4,
    param_sharding="2d", microbatches=2,  # §Perf C2: fewer FSDP re-gathers
))
