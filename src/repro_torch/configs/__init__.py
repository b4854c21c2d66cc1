"""Assigned architecture configs (--arch <id>). Exact constants per brief.

The port's own copy of the JAX package's ``repro.configs``: pure data, the
same fields, the same derived counts, the same registry.
"""
from .base import ArchConfig, ShapeConfig, SHAPES, all_archs, get_arch, register

from . import (  # noqa: F401  — importing populates the registry
    deepseek_7b,
    internlm2_20b,
    phi3_mini_3p8b,
    tinyllama_1p1b,
    jamba_1p5_large_398b,
    xlstm_350m,
    internvl2_76b,
    granite_moe_1b_a400m,
    mixtral_8x22b,
    whisper_tiny,
)

ALL = [
    deepseek_7b.CONFIG,
    internlm2_20b.CONFIG,
    phi3_mini_3p8b.CONFIG,
    tinyllama_1p1b.CONFIG,
    jamba_1p5_large_398b.CONFIG,
    xlstm_350m.CONFIG,
    internvl2_76b.CONFIG,
    granite_moe_1b_a400m.CONFIG,
    mixtral_8x22b.CONFIG,
    whisper_tiny.CONFIG,
]
