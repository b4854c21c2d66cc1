"""internvl2-76b — InternViT + InternLM2 VLM backbone [arXiv:2404.16821; unverified].

80L, d_model=8192, 64 heads (GQA kv=8), d_ff=28672, vocab=128256. Per the
brief the modality frontend is a STUB: input_specs() provides precomputed
patch embeddings (vision_tokens × d_model) prepended to the text sequence.
Full attention ⇒ long_500k skipped.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256,
    vision_tokens=256,
    param_sharding="2d", microbatches=4,
))
