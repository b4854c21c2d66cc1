"""The port's roofline (``roofline.analysis``) and the dry-run's model
surface (``Model.param_shapes``, ``Model.input_specs``) against the JAX
package's ``repro.roofline.analysis`` and ``repro.models.Model``.

``model_flops``, the parameter shapes and the input specs are compared
exactly, for every architecture (and shape, where one applies), without
allocating a full-width parameter on either side (``meta`` tensors in the
port, ``jax.eval_shape`` in the reference). The counted FLOPs and bytes
(``count_step``) equal the reference's ``parse_dot_stats`` of a jitted
matmul, and a hand count of a prefill's matrix products: the projections,
the attention chunk pairs that the port's ``flash_attention`` computes
(it skips the pairs a causal mask hides wholly; the reference computes
them) and the head at the last position.
"""
from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, all_archs, get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import Model
from repro_torch.roofline import HBM_BW, PEAK_FLOPS, analyze, count_step, model_flops
from test_torch_harness import port_config, ref_lm

ARCHS = sorted(all_archs())


def ref_roofline():
    ref_lm()
    return importlib.import_module("repro.roofline.analysis")


def specs_of(tree, prefix=""):
    """``{path: (shape, dtype name)}`` of a nested tree of dicts and tuples
    whose leaves are ``meta`` tensors or ``jax.ShapeDtypeStruct``s."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        name = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, (dict, tuple, list)):
            out.update(specs_of(v, name))
        else:
            dtype = str(v.dtype).removeprefix("torch.") if isinstance(v, torch.Tensor) else np.dtype(v.dtype).name
            out[name] = (tuple(v.shape), dtype)
    return out


def test_constants_are_the_h100_sxm_published_peaks():
    assert PEAK_FLOPS == 989e12 and HBM_BW == 3.35e12


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_reference(arch):
    r = ref_roofline()
    rcfg = ref_lm().configs.get_arch(arch)
    for name, shape in SHAPES.items():
        assert model_flops(get_arch(arch), shape) == r.model_flops(rcfg, ref_lm().configs.SHAPES[name]), name


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_equal_the_reference_parameters(arch):
    """Reduced: every name, shape and dtype of ``params_from_reference`` of
    the reference's parameters (zeros of its ``param_shapes``). Full width:
    the total element count of the reference's ``jax.eval_shape``, and
    every tensor on ``meta``."""
    import jax

    from repro_torch.core import params_from_reference

    r = ref_lm()
    rcfg = r.configs.get_arch(arch).reduced()
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), r.models.Model(rcfg).param_shapes())
    want = {k: (tuple(t.shape), t.dtype) for k, t in params_from_reference(zeros, device="cpu").items()}
    got = Model.param_shapes(port_config(rcfg))
    assert {k: (tuple(t.shape), t.dtype) for k, t in got.items()} == want
    assert all(t.device.type == "meta" for t in got.values())

    full = Model.param_shapes(get_arch(arch))
    rfull = r.models.Model(r.configs.get_arch(arch)).param_shapes()
    assert sum(t.numel() for t in full.values()) == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(rfull))
    assert all(t.device.type == "meta" for t in full.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch):
    r = ref_lm()
    rmodel = r.models.Model(r.configs.get_arch(arch))
    model = Model(get_arch(arch), device="meta")
    for name, shape in SHAPES.items():
        got, want = model.input_specs(shape), rmodel.input_specs(r.configs.SHAPES[name])
        assert specs_of(got) == specs_of(want), name
        assert all(t.device.type == "meta" for t in meta_leaves(got)), name


def meta_leaves(tree):
    for v in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(v, (dict, tuple, list)):
            yield from meta_leaves(v)
        else:
            yield v


def test_count_of_a_matmul_equals_parse_dot_stats():
    """One 128 x 128 float32 matmul: the reference's ``parse_dot_stats`` of
    the jitted dot's optimized HLO, and the port's count of ``torch.mm``."""
    import jax
    import jax.numpy as jnp

    r = ref_roofline()
    a = jnp.ones((128, 128), jnp.float32)
    text = jax.jit(lambda x, y: x @ y).lower(a, a).compile().as_text()
    want = r.parse_dot_stats(text)
    t = torch.ones((128, 128))
    counts = count_step(torch.mm, t, t)
    assert counts["dot_flops"] == want["dot_flops"] == 2 * 128**3
    assert counts["dot_bytes"] == want["dot_bytes"] == 3 * 128 * 128 * 4
    assert counts["args_bytes"] == 2 * 128 * 128 * 4


def test_count_of_batched_and_biased_products():
    """``bmm``, ``addmm`` and ``baddbmm`` (the bias is not an operand of the
    product), on ``meta`` tensors."""
    m = dict(device="meta")
    a, b = torch.empty((3, 8, 16), **m), torch.empty((3, 16, 4), **m)
    counts = count_step(lambda: (torch.bmm(a, b), torch.baddbmm(torch.empty((3, 8, 4), **m), a, b),
                                 torch.addmm(torch.empty((4,), **m), a[0], b[0])))
    assert counts["dot_flops"] == 2 * (2 * 3 * 8 * 4 * 16) + 2 * 8 * 4 * 16
    assert counts["dot_bytes"] == 4 * (2 * (3 * 8 * 16 + 3 * 16 * 4 + 3 * 8 * 4) + (8 * 16 + 16 * 4 + 8 * 4))
    assert counts["args_bytes"] == 0


@pytest.mark.parametrize("op", ["_scaled_dot_product_flash_attention", "_scaled_dot_product_efficient_attention"])
def test_count_of_a_fused_attention(op):
    """A fused attention kernel counts its two products (QK^T and PV:
    4 · B · H · S · S' · hd) and reads q, k, v and writes its output."""
    q = torch.empty((2, 3, 16, 8), device="meta", dtype=torch.bfloat16)
    args = (q, q, q, None, False) if "efficient" in op else (q, q, q)
    counts = count_step(lambda: getattr(torch.ops.aten, op)(*args))
    assert counts["dot_flops"] == 4 * 2 * 3 * 16 * 16 * 8
    assert counts["dot_bytes"] == 4 * q.numel() * 2


def attention_pairs(s: int, sk: int, causal: bool, chunk: int = 1024) -> int:
    """The (q chunk, kv chunk) pairs ``flash_attention`` computes."""
    from repro_torch.models.attention import _divisor_chunk

    qc, kc = _divisor_chunk(s, chunk), _divisor_chunk(sk, chunk)
    return sum(1 for i in range(s // qc) for j in range(sk // kc) if not (causal and j * kc > i * qc + qc - 1))


def hand_prefill_flops(cfg, b: int, s: int) -> float:
    """The prefill's matrix products counted by hand: 2 · m · n · k each."""
    from repro_torch.models.attention import _divisor_chunk

    D, H, KV, hd, F, V = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab

    def attention(q_len, k_len, causal):
        qc, kc = _divisor_chunk(q_len, 1024), _divisor_chunk(k_len, 1024)
        return attention_pairs(q_len, k_len, causal) * 2 * (2 * b * H * qc * kc * hd)  # QK^T and PV

    def mlp(n):
        return 3 * 2 * b * n * D * F

    def self_attention(n, causal):
        return 2 * b * n * D * (2 * H * hd + 2 * KV * hd) + attention(n, n, causal)

    head = 2 * b * D * V  # the last position only
    if cfg.family != "audio":
        return cfg.n_layers * (self_attention(s, True) + mlp(s)) + head
    T = cfg.enc_positions
    enc = cfg.enc_layers * (self_attention(T, False) + mlp(T))
    cross = 2 * b * T * D * 2 * KV * hd + 2 * b * s * D * 2 * H * hd + attention(s, T, False)
    return enc + cfg.n_layers * (self_attention(s, True) + cross + mlp(s)) + head


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-tiny"])
def test_counted_prefill_flops_equal_a_hand_count(arch):
    """A prefill of 2 x 2048 tokens on ``meta`` tensors: 2 q chunks of
    1024, of whose 4 pairs with the 2 kv chunks the causal mask leaves 3
    (whisper's cross-attention: 2 pairs with its one chunk of frames)."""
    cfg = get_arch(arch).reduced()
    model = Model(cfg, device="meta")
    assert attention_pairs(2048, 2048, True) == 3
    batch = model.input_specs(ShapeConfig("prefill", 2048, 2, "prefill"))
    with torch.no_grad():
        counts = count_step(lambda b: model.prefill(b, cache_len=2048), batch)
    assert counts["dot_flops"] == hand_prefill_flops(cfg, 2, 2048)


def test_analyze_terms_are_the_counts_over_the_constants():
    cfg, shape = get_arch("tinyllama-1.1b"), SHAPES["train_4k"]
    counts = {"dot_flops": 4.2e15, "dot_bytes": 6.1e12, "args_bytes": 2.0 * 2**30, "aten_ops": 10}
    info = analyze(counts, cfg=cfg, shape=shape)
    mf = model_flops(cfg, shape)
    assert info["devices"] == 1 and info["mem_args_gb"] == 2.0 and info["t_collective_s"] == 0.0
    assert info["dot_flops_per_dev"] == 4.2e15 and info["dot_bytes_per_dev"] == 6.1e12
    assert info["t_compute_s"] == 4.2e15 / PEAK_FLOPS and info["t_memory_s"] == 6.1e12 / HBM_BW
    assert info["model_flops_total"] == mf and info["t_compute_model_s"] == mf / PEAK_FLOPS
    assert info["useful_flops_ratio"] == round(mf / 4.2e15, 4)
    assert info["roofline_fraction"] == round((mf / PEAK_FLOPS) / (4.2e15 / PEAK_FLOPS + 6.1e12 / HBM_BW), 4)
    assert info["dominant"] == ("compute" if max(4.2e15, mf) / PEAK_FLOPS > 6.1e12 / HBM_BW else "memory")
    assert set(info) >= set(ref_keys())


def ref_keys():
    return ("devices", "dot_flops_per_dev", "dot_bytes_per_dev", "model_flops_total", "t_compute_s",
            "t_compute_model_s", "t_memory_s", "t_collective_s", "dominant", "useful_flops_ratio",
            "roofline_fraction", "mem_args_gb")


def test_remat_train_step_counts_the_recompute():
    """With remat each block's forward runs twice: the counted FLOPs of a
    train step exceed those without remat, and the useful share
    (``model_flops`` over the counted FLOPs) is at most 1."""
    from repro_torch.launch.dryrun import lower_cell

    cfg = dataclasses.replace(get_arch("tinyllama-1.1b").reduced(), remat=True)
    shape = ShapeConfig("train_4k", 512, 4, "train")
    with_remat = lower_cell(cfg, shape)
    without = lower_cell(dataclasses.replace(cfg, remat=False), shape)
    assert with_remat["status"] == without["status"] == "ok"
    assert with_remat["dot_flops_per_dev"] > without["dot_flops_per_dev"]
    assert with_remat["useful_flops_ratio"] <= 1
