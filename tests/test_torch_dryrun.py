"""The port's serving step factories (``launch.steps``) and one-device
dry-run (``launch.dryrun``).

The mesh-free steps are the model's own prefill and decode, bit for bit,
and a mesh that is not a ``DeviceMesh`` is refused. The mesh cells run as
rank 0 of the production mesh in a world of torch's ``fake`` backend. ``lower_cell`` traces a cell's train, prefill or
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
    """A mesh that is not a ``DeviceMesh`` is refused."""
    model = Model(get_arch("tinyllama-1.1b").reduced(), device="meta")
    with pytest.raises(TypeError, match="DeviceMesh"):
        make_prefill_step(model, object(), cache_len=8)
    with pytest.raises(TypeError, match="DeviceMesh"):
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


# ------------------------------------------------------------ the mesh cells
def test_mesh_cells_on_the_fake_world(capsys):
    """``--mesh`` and ``--multi-pod``: rank 0 of the production mesh in a
    world of torch's ``fake`` backend. tinyllama's train_4k under its dp
    policy runs one of the 256 rows on each of the 16 x 16 ranks: its
    per-device matrix-product FLOPs are the one-device cell's / 256; on
    the multi-pod mesh the batch splits over (pod, data) only (the
    reference's sanitized spec; the model axis's ranks hold the same
    rows): / 32. Both move gradients (ZeRO-1's reduce-scatters and
    gathers). granite's decode_32k on the multi-pod mesh is ``ok`` with
    collective bytes (the flash-decode combine, the expert sums)."""
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    one = dryrun.lower_cell("tinyllama-1.1b", "train_4k")
    for multi_pod, n, split in ((False, 256, 256), (True, 512, 32)):
        with fake_world(n):
            mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
            info = dryrun.lower_cell("tinyllama-1.1b", "train_4k", mesh)
            assert info["status"] == "ok" and info["devices"] == n
            assert math.isclose(info["dot_flops_per_dev"], one["dot_flops_per_dev"] / split, rel_tol=1e-12)
            assert info["t_collective_s"] > 0 and info["collectives"]["reduce-scatter"] > 0
            if multi_pod:
                dec = dryrun.lower_cell("granite-moe-1b-a400m", "decode_32k", mesh)
                assert dec["status"] == "ok" and dec["t_collective_s"] > 0, dec
                assert dec["dominant"] in ("memory", "collective")


def test_collective_bytes_of_a_toy_sharded_matmul():
    """The counter's collective bytes against a hand count on a 16-rank
    fake world: a (64, 32) float32 weight sharded on rows and gathered
    (an all-gather: 15 x its 4 x 32 x 4 B shard), the (16, 32) product's
    all-reduce (2 x 2048 B x 15/16) and reduce-scatter over the rows
    (2048 B x 15/16)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.launch.mesh import fake_world, make_mesh
    from repro_torch.roofline.analysis import count_step

    with fake_world(16):
        mesh = make_mesh((16,), ("model",), "cpu")
        w = DTensor.from_local(torch.empty(4, 32, device="meta"), mesh, [Shard(0)], run_check=False)

        def step(w, x):
            full = w.redistribute(mesh, [Replicate()]).to_local()
            y = x @ full
            partial = DTensor.from_local(y, mesh, [Partial()], run_check=False)
            partial.redistribute(mesh, [Replicate()])
            DTensor.from_local(y, mesh, [Partial()], run_check=False).redistribute(mesh, [Shard(0)])

        counts = count_step(step, w, torch.empty(16, 64, device="meta"))
    assert counts["dot_flops"] == 2 * 16 * 32 * 64
    assert counts["collectives"] == {"all-gather": 15 * 4 * 32 * 4, "all-reduce": 2 * 2048 * 15 / 16,
                                     "reduce-scatter": 2048 * 15 / 16}
    assert counts["collective_ops"] == 3


def test_summary_counts_no_cell_not_ported(tmp_path, capsys):
    """Every cell has a mesh step: jamba's train_4k on the (16, 16) mesh is
    ``ok``, the summary names no other status than ok, skipped and errors;
    a dense arch's long_500k keeps the reference's skip."""
    out = tmp_path / "cells.json"
    arch = dataclasses.replace(get_arch("jamba-1.5-large-398b").reduced(), n_layers=8)
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    with fake_world(256):
        mesh = make_production_mesh(device_type="cpu")
        info = dryrun.lower_cell(arch, REDUCED_SHAPES["train_4k"], mesh)
    assert info["status"] == "ok", info
    assert not hasattr(dryrun, "NOT_PORTED") and not hasattr(dryrun, "mesh_ported")
    for arch_name, shape in (("whisper-tiny", "decode_32k"), ("xlstm-350m", "decode_32k")):
        assert dryrun.main(["--arch", arch_name, "--shape", shape, "--multi-pod"]) == 0
        printed = capsys.readouterr().out
        assert "dry-run summary: 1 ok, 0 skipped, 0 errors ===" in printed and "not ported" not in printed
    assert dryrun.main(["--arch", "deepseek-7b", "--shape", "long_500k", "--mesh", "--out", str(out)]) == 0
    info = json.loads(out.read_text())["deepseek-7b|long_500k|16x16"]
    assert info["status"] == "skipped" and info["reason"] == ref_lm().configs.get_arch("deepseek-7b").runnable(
        ref_lm().configs.SHAPES["long_500k"])[1]


#: the formerly refused families' mesh cells: (arch, overrides, shape);
#: jamba at one super-block (its reduced config's 4 layers make none)
FAMILY_CELLS = [("jamba-1.5-large-398b", dict(n_layers=8), "train_4k"),
                ("jamba-1.5-large-398b", dict(n_layers=8), "prefill_32k"),
                ("jamba-1.5-large-398b", dict(n_layers=8), "decode_32k"),
                ("xlstm-350m", {}, "prefill_32k"), ("xlstm-350m", {}, "decode_32k"),
                ("whisper-tiny", {}, "prefill_32k"), ("whisper-tiny", {}, "decode_32k")]


@pytest.mark.parametrize("arch,over,shape", FAMILY_CELLS, ids=[f"{a.split('-')[0]}-{s}" for a, _, s in FAMILY_CELLS])
def test_family_mesh_cells_trace_with_collectives(arch, over, shape):
    """Each family's reduced cell (shapes cut to 256 positions and 4 rows)
    on the multi-pod mesh of the fake world: ``ok``, with collective bytes
    (the sequence gathers, the row-parallel sums, jamba's Mamba regroup
    and EP or FFN-split experts, the flash-decode combine)."""
    from repro_torch.launch.mesh import fake_world, make_production_mesh

    cfg = dataclasses.replace(get_arch(arch).reduced(), **over)
    with fake_world(512):
        mesh = make_production_mesh(multi_pod=True, device_type="cpu")
        info = dryrun.lower_cell(cfg, REDUCED_SHAPES[shape], mesh)
    assert info["status"] == "ok", info
    assert info["devices"] == 512 and info["t_collective_s"] > 0 and info["aten_ops"] > 0, info
    if cfg.family == "hybrid":  # the Mamba regroup (MB, rounded: a decode step moves under 0.01)
        assert "all-to-all" in info["collectives"], info["collectives"]
