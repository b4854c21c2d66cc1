"""The port's xLSTM (``models.xlstm`` through ``models.Model``) against the
JAX package's on the same weights (``params_from_reference``), on the
reduced xlstm-350m: 4 blocks, mLSTM at 0 and 2, sLSTM at 1 and 3
(``slstm_every=2``).

Tolerances (``test_torch_harness``'s checks): logits, loss and states at
1e-4 in float32 and 6e-2 in bfloat16; every float32 gradient leaf within
1e-4 of its largest magnitude (floored for mLSTM's ``b_i``, whose
gradient is rounding noise: ``leaf_errors``); three train steps at
``test_torch_train.py``'s tolerances; greedy streams, the driver's restart
and the converter's round trip exactly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.models import Model
from test_torch_harness import (check_convert_round_trip, check_forward, check_gradients, check_resume,
                                check_serve, check_train_steps, lm_pair)

ARCH = "xlstm-350m"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_prefill_decode_equal_reference(dtype):
    check_forward(ARCH, dtype)


def test_gradients_equal_reference():
    check_gradients(ARCH)


def test_three_train_steps_equal_reference():
    check_train_steps(ARCH)


def test_serve_streams_equal_reference():
    check_serve(ARCH)


def test_launch_train_resumes_as_an_uninterrupted_run(tmp_path, capsys):
    from repro_torch.launch.train import main

    main(["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu"])
    assert "step     1" in capsys.readouterr().out
    check_resume(tmp_path, get_arch(ARCH).reduced())


def test_parameter_names_and_convert_round_trip():
    """``mlstm.<i>.<leaf>`` and ``slstm.<i>.<leaf>``, one parameter per
    block; and back to the reference's stacked tree byte for byte."""
    _, rparams, model = lm_pair(ARCH, "float32")
    want = {k for k in rparams if k not in ("mlstm", "slstm")}
    want |= {f"{kind}.{i}.{leaf}" for kind in ("mlstm", "slstm") for leaf in rparams[kind] for i in range(2)}
    assert set(dict(model.named_parameters())) == want
    np.testing.assert_array_equal(model.slstm[1]["w_zifo"].numpy(), np.asarray(rparams["slstm"]["w_zifo"])[1])
    check_convert_round_trip(ARCH)


def test_cache_is_the_recurrent_state_only():
    """The decode state does not grow with the context: ``cache_shapes``
    and a prefill's cache at two lengths, as the reference's."""
    rmodel, _, model = lm_pair(ARCH, "float32")
    for n in (3, 300):
        shapes = model.cache_shapes(2, n)
        rshapes = rmodel.cache_shapes(2, n)
        assert [tuple(t.shape) for t in shapes["mlstm"] + shapes["slstm"]] == \
            [tuple(t.shape) for t in rshapes["mlstm"] + rshapes["slstm"]]
        assert all(t.dtype == torch.float32 and t.device.type == "meta" for t in shapes["mlstm"] + shapes["slstm"])
    cache, _ = model.prefill({"tokens": np.arange(10, dtype=np.int32)[None]}, cache_len=4096)
    assert set(cache) == {"mlstm", "slstm", "pos"} and tuple(cache["mlstm"][0].shape) == (2, 1, 4, 32, 32)


def test_no_slstm_blocks():
    """``slstm_every=0``: an mLSTM-only stack, with an empty sLSTM state."""
    cfg = dataclasses.replace(get_arch(ARCH).reduced(), slstm_every=0, dtype="float32")
    model = Model(cfg, device="cpu", seed=2)
    assert len(model.slstm) == 0 and len(model.mlstm) == 4
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (1, 9)).astype(np.int32)
    cache, _ = model.prefill({"tokens": toks[:, :-1]})
    dec, _ = model.decode_step(cache, toks[:, -1])
    _, full = model.prefill({"tokens": toks})
    assert tuple(cache["slstm"][0].shape) == (0, 1, cfg.d_model)
    assert (dec - full).abs().max().item() <= 1e-4 * full.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("arch,overrides", [(ARCH, {}), ("jamba-1.5-large-398b", {"n_layers": 16})])
def test_recurrent_models_serve_on_the_card_as_on_the_cpu(arch, overrides):
    """The reduced xlstm and two-block jamba in float32, one set of weights
    on both devices: prefill logits within 1e-4 of the CPU's largest, and
    the card's greedy ``serve()`` streams equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32", **overrides)
    cpu = Model(cfg, device="cpu", seed=1)
    card = Model(cfg, device="cuda", params=cpu.state_dict())
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32) for n in rng.integers(8, 40, 6)]
    _, lg_cpu = cpu.prefill({"tokens": prompts[0][None]})
    _, lg_card = card.prefill({"tokens": prompts[0][None]})
    assert (lg_card.cpu() - lg_cpu).abs().max().item() <= 1e-4 * lg_cpu.abs().max().item()
    kw = dict(max_new_tokens=8, temperature=0.0, eos_id=cfg.vocab)  # no EOS: every budget runs out
    streams = [[s.tolist() for s in ServeEngine(m, ServeConfig(**kw)).serve(prompts, slots=3)] for m in (card, cpu)]
    assert streams[0] == streams[1]
