"""The port's serving step factories (``launch.steps``) and one-device
dry-run (``launch.dryrun``).

The mesh-free steps are the model's own prefill and decode, bit for bit,
and a mesh is refused. ``lower_cell`` traces a cell's train, prefill or
decode step on ``meta`` tensors: every reduced architecture at every
shape kind (the shapes cut to 256 positions and 4 rows, their names kept,
so ``runnable`` skips as for the full shapes), and the full whisper-tiny
at every shape the reference runs (the full tinyllama-1.1b in
``test_torch_dryrun_tinyllama.py``); a cell is ``ok`` or skipped for the
reference's reason. No full-width xlstm or jamba cell
runs here: their scans are Python loops over time, ~10^6 ops a step at
4096 positions. ``repro.launch.dryrun`` is not imported (its first lines
set ``XLA_FLAGS`` for every later JAX test of the process): the
reference's ``runnable`` comes from its configs, and its
``opt_config_for`` is restated.
"""
from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, all_archs, get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import Model
from test_torch_harness import ref_lm

REDUCED_SHAPES = {name: dataclasses.replace(s, seq_len=min(s.seq_len, 256), global_batch=min(s.global_batch, 4))
                  for name, s in SHAPES.items()}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "whisper-tiny"])
def test_mesh_free_steps_are_the_model_steps(arch):
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    model = Model(cfg, device="cpu", seed=3)
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32))}
    if cfg.family == "audio":
        batch["frames"] = torch.from_numpy(rng.standard_normal((2, cfg.enc_positions, cfg.d_model)).astype(np.float32))
    cache, logits = make_prefill_step(model, None, cache_len=16, batch_shapes=batch)(batch)
    want_cache, want = model.prefill(batch, cache_len=16)
    assert torch.equal(logits, want) and cache.keys() == want_cache.keys()
    assert all(torch.equal(cache[k], want_cache[k]) for k in cache)
    token = torch.from_numpy(rng.integers(0, cfg.vocab, (2,)).astype(np.int32))
    logits, cache = make_decode_step(model, None, batch=2, cache_len=16)(cache, token)
    want, want_cache = model.decode_step(want_cache, token)
    assert torch.equal(logits, want) and all(torch.equal(cache[k], want_cache[k]) for k in cache)
    assert int(cache["pos"]) == 12


def test_steps_refuse_a_mesh():
    model = Model(get_arch("tinyllama-1.1b").reduced(), device="meta")
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md, queue 1 item 6"):
        make_prefill_step(model, object(), cache_len=8)
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md, queue 1 item 6"):
        make_decode_step(model, object(), batch=2, cache_len=8)


def test_opt_config_and_shapes():
    """The reference's ``opt_config_for``, restated: bfloat16 state and
    accumulation above 10^11 parameters (jamba only), float32 below."""
    for name, cfg in all_archs().items():
        big = cfg.param_count() > 1e11
        oc = dryrun.opt_config_for(cfg)
        assert (oc.state_dtype, oc.grad_accum_dtype) == (("bfloat16",) * 2 if big else ("float32",) * 2), name
    pshapes = Model.param_shapes(get_arch("whisper-tiny"))
    opt = dryrun.opt_shapes(pshapes, dryrun.opt_config_for(get_arch("whisper-tiny")))
    assert opt["m"].keys() == opt["v"].keys() == pshapes.keys()
    assert all(t.shape == pshapes[k].shape and t.dtype == torch.float32 and t.device.type == "meta"
               for k, t in opt["m"].items())
    assert opt["step"].dtype == torch.int32 and opt["step"].shape == ()


def assert_cell(info, arch, shape_name):
    """``ok`` with finite terms, or skipped for the reference's reason."""
    r = ref_lm().configs
    runnable, reason = r.get_arch(arch).runnable(r.SHAPES[shape_name])
    if not runnable:
        assert info == {"status": "skipped", "reason": reason}
        return
    assert info["status"] == "ok", info
    for k in ("dot_flops_per_dev", "dot_bytes_per_dev", "t_compute_s", "t_memory_s"):
        assert math.isfinite(info[k]) and info[k] > 0, (k, info)
    assert info["mem_args_gb"] >= 0 and info["aten_ops"] > 0
    assert info["dominant"] in ("compute", "memory") and info["t_collective_s"] == 0.0


@pytest.mark.parametrize("arch", sorted(all_archs()))
def test_lower_cell_on_every_reduced_arch(arch):
    for name, shape in REDUCED_SHAPES.items():
        assert_cell(dryrun.lower_cell(get_arch(arch).reduced(), shape), arch, name)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ["whisper-tiny"])
def test_lower_cell_at_full_width(arch, shape):
    """On ``meta`` tensors: the step's inputs of the published widths, the
    prefill of 32 x 32 768 tokens and the decode step on a 32 768-position
    cache of 128 rows, with nothing allocated."""
    info = dryrun.lower_cell(arch, shape)
    assert_cell(info, arch, shape)
    if info["status"] == "ok" and SHAPES[shape].kind == "decode":
        # a decode step reads the whole cache: its bytes dominate
        cache_bytes = sum(t.numel() * t.element_size() for k, t in
                          Model(get_arch(arch), device="meta").cache_shapes(128, 32768).items() if k != "pos")
        assert info["dominant"] == "memory" and info["dot_bytes_per_dev"] >= cache_bytes


def test_main_writes_its_json(tmp_path, capsys):
    out = tmp_path / "cells.json"
    assert dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k", "--out", str(out)]) == 0
    cells = json.loads(out.read_text())
    assert list(cells) == ["whisper-tiny|decode_32k|1"] and cells["whisper-tiny|decode_32k|1"]["status"] == "ok"
    assert "dry-run summary: 1 ok, 0 skipped, 0 errors" in capsys.readouterr().out


def test_a_cell_that_fails_is_reported_not_dropped(tmp_path, monkeypatch, capsys):
    def fail(arch, shape):
        raise RuntimeError("cannot trace")

    monkeypatch.setattr(dryrun, "lower_cell", fail)
    out = tmp_path / "cells.json"
    assert dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "train_4k", "--out", str(out)]) == 1
    info = json.loads(out.read_text())["tinyllama-1.1b|train_4k|1"]
    assert info["status"] == "error" and info["error"] == "RuntimeError: cannot trace"
    assert "0 ok, 0 skipped, 1 errors" in capsys.readouterr().out
