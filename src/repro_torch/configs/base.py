"""Architecture + shape configuration schema.

One ``ArchConfig`` per assigned architecture (exact constants from the brief,
sources cited in each ``configs/<id>.py``), plus a ``reduced()`` variant used
by CPU smoke tests. ``ShapeConfig`` enumerates the four assigned input shapes;
``runnable()`` encodes the brief's skip rules (long_500k only for
sub-quadratic archs; decode only for archs with a decoder).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

# ----------------------------------------------------------------- shapes
@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_every: int = 1  # MoE MLP every k-th layer (jamba: 2)
    # hybrid (jamba): attention layer every `attn_period` layers, else mamba
    attn_period: int = 0
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_d_conv: int = 4
    # sliding-window attention (mixtral)
    sliding_window: int = 0
    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_positions: int = 1500  # whisper audio frames after conv stub
    # vlm
    vision_tokens: int = 0  # stub patch embeddings prepended to the text
    # xlstm
    slstm_every: int = 0  # sLSTM block every k-th layer, else mLSTM
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # distribution policy
    param_sharding: str = "2d"  # "2d" = FSDP(data)×TP(model); "1d" = TP only
    remat: bool = True
    seq_shard_activations: bool = True  # Megatron-SP style residual sharding
    microbatches: int = 1

    # ------------------------------------------------------------ derived
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: SSM/hybrid or sliding-window attention."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs autoregress (whisper via its decoder)

    def runnable(self, shape: ShapeConfig) -> Tuple[bool, str]:
        """(runs?, reason-if-skipped) per the brief's skip rules."""
        if shape.name == "long_500k" and not self.sub_quadratic:
            return False, (
                "long_500k skipped: pure full-attention arch (O(S^2) prefill "
                "and O(S) KV decode at 512k exceeds any quadratic budget); "
                "see DESIGN.md §Arch-applicability"
            )
        if shape.kind == "decode" and not self.has_decoder:
            return False, "decode skipped: encoder-only architecture"
        return True, ""

    def is_attn_layer(self, i: int) -> bool:
        if self.family == "hybrid":
            return (i % self.attn_period) == self.attn_period // 2
        return self.family != "ssm"

    def is_moe_layer(self, i: int) -> bool:
        return self.moe_experts > 0 and (i % self.moe_every) == self.moe_every - 1

    # analytic parameter count (embedding included once)
    def param_count(self) -> int:
        D, F, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        H, KV, hd = self.n_heads, self.n_kv_heads, self.hd
        total = V * D + D * V  # embed + lm head
        for i in range(L):
            if self.is_attn_layer(i):
                total += D * H * hd + 2 * D * KV * hd + H * hd * D
            elif self.family == "hybrid":  # mamba layer
                di = self.mamba_expand * D
                total += D * 2 * di + di * self.mamba_d_conv + di * (
                    2 * self.mamba_d_state + 1
                ) + di * D
            elif self.family == "ssm":  # xlstm block
                total += 4 * D * D + 2 * D * 2 * D
            if F:
                if self.is_moe_layer(i):
                    total += D * self.moe_experts + self.moe_experts * 3 * D * F
                else:
                    total += 3 * D * F
            total += 2 * D  # norms
        if self.enc_layers:
            for _ in range(self.enc_layers):
                total += 4 * D * D + 3 * D * F + 2 * D  # enc self-attn + mlp
            total += self.n_layers * (4 * D * D + D)  # decoder cross-attn
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k of experts)."""
        if not self.moe_experts:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        dense = self.param_count()
        moe_layers = sum(self.is_moe_layer(i) for i in range(self.n_layers))
        unused = moe_layers * (self.moe_experts - self.moe_top_k) * 3 * D * F
        return dense - unused

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU smoke tests."""
        return dataclasses.replace(
            self,
            n_layers=max(2, min(4, self.n_layers)),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) or 2,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            moe_experts=min(self.moe_experts, 4),
            moe_top_k=min(self.moe_top_k, 2),
            enc_layers=min(self.enc_layers, 2),
            enc_positions=min(self.enc_positions, 64) if self.enc_layers else self.enc_positions,
            vision_tokens=min(self.vision_tokens, 16),
            slstm_every=min(self.slstm_every, 2) if self.slstm_every else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            attn_period=self.attn_period,
            mamba_d_state=8,
            param_sharding="1d",
            microbatches=1,
        )


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:
        from . import ALL  # noqa: F401  (populates the registry)
    return _REGISTRY[name]


def all_archs() -> Dict[str, ArchConfig]:
    if not _REGISTRY:
        from . import ALL  # noqa: F401
    return dict(_REGISTRY)
