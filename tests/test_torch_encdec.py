"""The port's encoder-decoder (``models.encdec`` through ``models.Model``)
against the JAX package's on the same weights (``params_from_reference``),
on the reduced whisper-tiny: 2 encoder and 4 decoder layers, d_model 128,
4 heads of 32, vocab 512, 64 frames; the frames drawn with numpy from a
seed and fed to both (``test_torch_harness.extras_for``).

Tolerances (``test_torch_harness``'s checks): loss, logits and caches at
1e-4 in float32 and 6e-2 in bfloat16 (or twice the reference's own jitted
against op-by-op spread); every float32 gradient leaf within 1e-4 of its
largest magnitude; three train steps, and three at ``microbatches=2``,
at ``test_torch_train.py``'s tolerances; greedy ``generate()`` streams,
remat against no remat, the driver's restart and the converter's round
trip exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.models import Model
from test_torch_harness import (check_convert_round_trip, check_forward, check_generate, check_gradients,
                                check_resume, check_train_steps, lm_pair, ref_lm)

ARCH = "whisper-tiny"


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread per test: the reduced model's ops are small, and
    beside the other workers of a parallel run eight threads a process
    spend far longer waiting on each other than the ops take."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_reduced_config():
    cfg = get_arch(ARCH).reduced()
    assert (cfg.family, cfg.enc_layers, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.hd, cfg.vocab,
            cfg.enc_positions) == ("audio", 2, 4, 128, 4, 32, 512, 64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_prefill_cache_decode_equal_reference(dtype):
    """Loss; prefill logits and every cache leaf (``k``, ``v`` zero-padded
    past the prompt, ``xk``, ``xv``, ``pos``); three decode steps."""
    check_forward(ARCH, dtype)


def test_gradients_equal_reference():
    check_gradients(ARCH)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_three_train_steps_equal_reference(microbatches):
    """From one state, the frames split with the tokens at microbatches=2."""
    check_train_steps(ARCH, microbatches=microbatches)


def test_remat_equals_no_remat_bit_for_bit():
    """Each decoder block rematerialized (its cross K/V included) gives the
    loss and gradients of no remat, bit for bit on the CPU."""
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype="float32")
    model = Model(cfg, device="cpu", seed=4)
    assert model.cfg.remat
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 24)).astype(np.int32))
    frames = torch.from_numpy(rng.standard_normal((2, cfg.enc_positions, cfg.d_model)).astype(np.float32))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1), "frames": frames}
    model.requires_grad_(True)
    runs = []
    for remat in (True, False):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        loss, aux = model.train_loss(batch)
        assert aux == {}
        runs.append((loss.item(), torch.autograd.grad(loss, list(model.parameters()))))
    assert runs[0][0] == runs[1][0]
    for (name, _), a, b in zip(model.named_parameters(), runs[0][1], runs[1][1]):
        assert torch.equal(a, b), name


def test_generate_streams_equal_reference():
    check_generate(ARCH)


def test_teacher_forced_decode_equals_prefill():
    """A prefill of S then decode steps through the cache reproduce the
    last logits of prefills of S + 1 .. S + 3 on the same frames."""
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype="float32")
    model = Model(cfg, device="cpu", seed=2)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 23)).astype(np.int32)
    frames = torch.from_numpy(rng.standard_normal((2, cfg.enc_positions, cfg.d_model)).astype(np.float32))
    cache, _ = model.prefill({"tokens": toks[:, :20], "frames": frames}, cache_len=32)
    for j in range(20, 23):
        dec, cache = model.decode_step(cache, toks[:, j])
        _, full = model.prefill({"tokens": toks[:, :j + 1], "frames": frames}, cache_len=32)
        assert (dec - full).abs().max().item() <= 1e-4 * full.abs().max().item(), j


def test_serve_refuses_audio_in_both_packages():
    """``serve()`` prefills with tokens alone (the reference's
    ``engine.py:170-181``), so whisper, which needs its frames, is refused
    by both engines; the port's error names the missing ``frames``."""
    r = ref_lm().serve
    from repro_torch.serve import ServeConfig, ServeEngine

    rmodel, rparams, model = lm_pair(ARCH, "float32")
    prompts = [np.arange(5, 13, dtype=np.int32)]
    with pytest.raises(KeyError, match="frames"):
        r.ServeEngine(rmodel, rparams, r.ServeConfig(max_new_tokens=2)).serve(prompts)
    with pytest.raises(KeyError, match="frames"):
        ServeEngine(model, ServeConfig(max_new_tokens=2)).serve(prompts)


def test_launch_train_resumes_as_an_uninterrupted_run(tmp_path):
    """``launch.train.train`` on synthetic batches (``synthetic_batch``
    draws the frames with the tokens)."""
    check_resume(tmp_path, get_arch(ARCH).reduced())


def test_parameter_names_and_convert_round_trip():
    """``enc.<i>.<leaf>`` and ``dec.<i>.<leaf>`` (the cross-attention's
    ``xw*`` among them), one parameter per layer; and back to the
    reference's stacked tree byte for byte."""
    _, rparams, model = lm_pair(ARCH, "float32")
    want = {k for k in rparams if k not in ("enc", "dec")}
    assert want == {"embed", "enc_final_norm", "final_norm", "lm_head"}
    want |= {f"enc.{i}.{leaf}" for leaf in rparams["enc"] for i in range(2)}
    want |= {f"dec.{i}.{leaf}" for leaf in rparams["dec"] for i in range(4)}
    assert set(dict(model.named_parameters())) == want
    assert {"xwq", "xwk", "xwv", "xwo", "cross_norm"} <= set(model.dec[3].keys())
    np.testing.assert_array_equal(model.dec[3]["xwk"].numpy(), np.asarray(rparams["dec"]["xwk"])[3])
    check_convert_round_trip(ARCH)


def test_optimizer_tree_order_is_the_reference_flatten_order():
    """``global_norm`` sums leaf by leaf in ``jax.tree.flatten``'s order:
    ``dec`` < ``embed`` < ``enc`` < ``enc_final_norm`` < ``final_norm`` <
    ``lm_head``, each stacked leaf's layers together."""
    import jax

    from repro_torch.core import tree_to_reference
    from repro_torch.optim.adamw import _tree_order

    _, rparams, model = lm_pair(ARCH, "float32")
    names = _tree_order(dict(model.named_parameters()))
    tops = list(dict.fromkeys(n.split(".")[0] for n in names))
    assert tops == ["dec", "embed", "enc", "enc_final_norm", "final_norm", "lm_head"]
    leaves = jax.tree_util.tree_flatten_with_path(rparams)[0]
    want = ["/".join(str(k.key) for k in path) for path, _ in leaves]
    got = list(dict.fromkeys("/".join(s for s in n.split(".") if not s.isdigit()) for n in names))
    assert got == want
    assert set(flat_names(tree_to_reference(dict(model.named_parameters())))) == set(want)


def flat_names(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}/{k}" if prefix else k
        yield from (flat_names(v, name) if isinstance(v, dict) else [name])


def test_decode_position_is_row_pos_of_the_reference_table():
    """The decode step adds row ``pos`` of ``sinusoidal_positions(cache_len,
    D)``: the port's table has the reference's values, row by row."""
    from repro_torch.models.layers import sinusoidal_positions

    r = ref_lm().layers
    want = np.asarray(r.sinusoidal_positions(96, 128))
    got = sinusoidal_positions(96, 128).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_meta_model_builds_and_decodes_without_memory():
    """The full whisper-tiny on ``meta`` tensors: its parameters have the
    published widths (61.07 M: ``param_count`` and the two final norms it
    leaves out) and a decode step runs at decode_32k's shapes, reading
    nothing."""
    cfg = get_arch(ARCH)
    model = Model(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.param_count() + 2 * cfg.d_model == 61_074_432
    assert all(p.device.type == "meta" for p in model.parameters())
    cache = {k: torch.empty_like(v) for k, v in model.cache_shapes(128, 32768).items()}
    logits, cache = model.decode_step(cache, torch.empty((128,), dtype=torch.int32, device="meta"))
    assert tuple(logits.shape) == (128, cfg.vocab) and tuple(cache["xk"].shape) == (4, 128, 1500, 6, 64)


@pytest.mark.cuda
def test_whisper_on_the_card_equals_the_cpu():
    """The reduced whisper in float32, one set of weights and frames on
    both devices: prefill logits within 1e-4 of the CPU's largest, and
    the card's greedy ``generate()`` streams equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = dataclasses.replace(get_arch(ARCH).reduced(), dtype="float32")
    cpu = Model(cfg, device="cpu", seed=1)
    card = Model(cfg, device="cuda", params=cpu.state_dict())
    rng = np.random.default_rng(22)
    prompts = rng.integers(0, cfg.vocab, (4, 12)).astype(np.int32)
    frames = torch.from_numpy(rng.standard_normal((4, cfg.enc_positions, cfg.d_model)).astype(np.float32))
    _, lg_cpu = cpu.prefill({"tokens": prompts, "frames": frames})
    _, lg_card = card.prefill({"tokens": prompts, "frames": frames})
    assert (lg_card.cpu() - lg_cpu).abs().max().item() <= 1e-4 * lg_cpu.abs().max().item()
    kw = dict(max_new_tokens=8, temperature=0.0, eos_id=cfg.vocab)  # no EOS: every budget runs out
    streams = [ServeEngine(m, ServeConfig(**kw)).generate(prompts, extras={"frames": frames}).cpu()
               for m in (card, cpu)]
    assert torch.equal(streams[0], streams[1])
