"""whisper-tiny — encoder-decoder audio backbone [arXiv:2212.04356; unverified].

4+4L, d_model=384, 6 heads, d_ff=1536, vocab=51865. The conv frontend is a
STUB per the brief: input_specs() provides precomputed (1500, 384) frame
embeddings. Decoder cross-attends to encoder output; decode shapes exercise
the decoder KV cache. Full attention ⇒ long_500k skipped.
"""
from .base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865,
    enc_layers=4, enc_positions=1500,
    param_sharding="dp",  # §Perf A2 regime: replicate 61M, shard batch
))
