"""The port's LM (``models.transformer`` through ``models.Model``) against
the JAX package's on the same weights (``params_from_reference``) for the
reduced tinyllama, granite-moe, mixtral (sliding window 64, prompts past
it) and internvl2 (patch-embedding prefix): prefill and decode logits,
cache position, the training loss and the MoE aux terms.

float32 is held at 1e-4. bfloat16 is held at the reference's own 6e-2
(``tests/test_models_smoke.py``), measured against the largest logit
magnitude: under ``jit`` XLA keeps float32 inside its fusions where an
op-by-op run rounds to bfloat16, and on these weights the reference's own
jitted and op-by-op prefills differ by up to 0.11 in one element
(granite-moe, logits up to 3.0); the port rounds where the op-by-op
reference does.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.models import Model
from test_torch_harness import lm_pair, to_numpy

ARCHS = ("tinyllama-1.1b", "granite-moe-1b-a400m", "mixtral-8x22b", "internvl2-76b")
DTYPES = ("float32", "bfloat16")


def assert_logits(port, ref, dtype, what):
    p, r = to_numpy(port), to_numpy(ref)
    assert p.shape == r.shape, what
    if dtype == "float32":
        np.testing.assert_allclose(p, r, rtol=1e-4, atol=1e-4, err_msg=what)
    else:
        err, scale = np.abs(p - r).max(), np.abs(r).max()
        assert err <= 6e-2 * scale, f"{what}: max error {err} against 6e-2 x {scale}"


def prompt(cfg, rng, b=2):
    """Tokens (and patch embeddings for the VLM) in both packages' forms: a
    prompt past mixtral's window of 64, past internvl2's 16 patch tokens."""
    import jax.numpy as jnp

    s = 96 if cfg.sliding_window else max(40, cfg.vision_tokens + 8)
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal((b, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    rbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if "patch_embeds" in rbatch:
        rbatch["patch_embeds"] = rbatch["patch_embeds"].astype(cfg.dtype)
        batch["patch_embeds"] = torch.from_numpy(batch["patch_embeds"]).to(getattr(torch, cfg.dtype))
    return batch, rbatch


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_loss_equal_reference(arch, dtype):
    import jax.numpy as jnp

    rmodel, rparams, model = lm_pair(arch, dtype)
    cfg = model.cfg
    rng = np.random.default_rng(len(arch))
    batch, rbatch = prompt(cfg, rng)
    s = batch["tokens"].shape[1]
    rcache, rlogits = rmodel.prefill(rparams, rbatch, cache_len=s + 8)
    cache, logits = model.prefill(batch, cache_len=s + 8)
    assert logits.dtype == getattr(torch, dtype)
    assert_logits(logits, rlogits, dtype, "prefill")
    assert int(cache["pos"]) == int(rcache["pos"]) == s - 1
    assert tuple(cache["k"].shape) == tuple(rcache["k"].shape)

    nxt = rng.integers(0, cfg.vocab, (2,)).astype(np.int32)
    rlogits2, rcache2 = rmodel.decode_step(rparams, rcache, jnp.asarray(nxt))
    logits2, cache2 = model.decode_step(cache, nxt)
    assert_logits(logits2, rlogits2, dtype, "decode")
    assert int(cache2["pos"]) == int(rcache2["pos"]) == s

    labels = np.roll(np.asarray(rbatch["tokens"]), -1, axis=1)
    rloss, raux = rmodel.train_loss(rparams, dict(rbatch, labels=jnp.asarray(labels)))
    loss, aux = model.train_loss(dict(batch, labels=labels))
    tol = 1e-4 if dtype == "float32" else 6e-2
    np.testing.assert_allclose(float(loss), float(rloss), rtol=tol, atol=tol)
    assert sorted(aux) == sorted(raux)
    for key in aux:
        if key == "overflow":
            assert bool(aux[key]) == bool(raux[key])
        else:
            np.testing.assert_allclose(float(aux[key]), float(raux[key]), rtol=tol, err_msg=key)


def test_moe_drops_on_a_long_prompt_equal_reference():
    """Past 512 records a layer the capacity rule drops records: 300 tokens
    of the reduced granite (600 records, cap 188 an expert) overflow in
    both packages alike, and the logits still agree at 1e-4."""
    import jax.numpy as jnp

    rmodel, rparams, model = lm_pair("granite-moe-1b-a400m", "float32")
    toks = np.random.default_rng(9).integers(0, model.cfg.vocab, (1, 300)).astype(np.int32)
    _, rlogits = rmodel.prefill(rparams, {"tokens": jnp.asarray(toks)})
    _, logits = model.prefill({"tokens": toks})
    assert_logits(logits, rlogits, "float32", "prefill")
    labels = np.roll(toks, -1, axis=1)
    _, raux = rmodel.train_loss(rparams, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    _, aux = model.train_loss({"tokens": toks, "labels": labels})
    assert bool(aux["overflow"]) and bool(raux["overflow"])


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_equals_prefill(arch):
    """Decoding token t through the cache reproduces the prefill logits at
    position t: the flash prefill against the cached decode attention."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    model = Model(cfg, device="cpu", seed=2)
    rng = np.random.default_rng(3)
    s = 96 if cfg.sliding_window else max(40, cfg.vision_tokens + 8)
    toks = rng.integers(0, cfg.vocab, (2, s)).astype(np.int32)
    extras = {}
    if cfg.family == "vlm":
        extras["patch_embeds"] = torch.from_numpy(rng.standard_normal((2, cfg.vision_tokens, cfg.d_model))).float()
    cache, _ = model.prefill({"tokens": toks[:, :-1], **extras}, cache_len=s + 8)
    dec, _ = model.decode_step(cache, toks[:, -1])
    _, full = model.prefill({"tokens": toks, **extras}, cache_len=s + 8)
    err, scale = (dec - full).abs().max().item(), full.abs().max().item()
    assert err <= 1e-4 * scale, (err, scale)


def test_parameters_carry_the_reference_leaf_names():
    _, rparams, model = lm_pair("granite-moe-1b-a400m")
    names = set(dict(model.named_parameters()))
    want = {k for k in rparams if k != "layers"}
    want |= {f"layers.{i}.{leaf}" for leaf in rparams["layers"] for i in range(model.cfg.n_layers)}
    assert names == want
    for leaf, stacked in rparams["layers"].items():
        np.testing.assert_array_equal(to_numpy(model.layers[1][leaf]), to_numpy(np.asarray(stacked)[1]))


def test_harness_checks_feed_the_vlm_patch_embeds():
    """``test_torch_harness.check_forward`` on the reduced internvl2 in
    float32: its ``extras_for`` draws the 16 patch embeddings from the
    seed and feeds the same bytes to both packages."""
    from test_torch_harness import check_forward, extras_for

    cfg = get_arch("internvl2-76b").reduced()
    extras, rextras = extras_for(cfg, np.random.default_rng(0), 2)
    assert tuple(extras["patch_embeds"].shape) == (2, cfg.vision_tokens, cfg.d_model)
    assert to_numpy(extras["patch_embeds"]).tobytes() == to_numpy(rextras["patch_embeds"]).tobytes()
    check_forward("internvl2-76b", "float32")


def test_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(get_arch("tinyllama-1.1b").reduced())


def test_cache_shapes():
    model = Model(get_arch("tinyllama-1.1b").reduced(), device="cpu")
    shapes = model.cache_shapes(3, 48)
    cfg = model.cfg
    assert tuple(shapes["k"].shape) == (cfg.n_layers, 3, 48, cfg.n_kv_heads, cfg.hd)
    assert shapes["k"].dtype == torch.bfloat16 and shapes["pos"].dtype == torch.int32
    assert shapes["k"].device.type == "meta"
