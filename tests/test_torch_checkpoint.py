"""The port's ``train/checkpoint`` against the JAX package's
``repro.train.checkpoint``: the on-disk layout and manifest, atomic
writes with a keep window, integrity checks, bfloat16 as its 16 bits, and
an exact restart of the reduced granite-moe (the reference's
``test_checkpoint_restart_is_exact``), compared byte for byte."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import synthetic_batch
from repro_torch.models import Model
from repro_torch.optim import OptConfig
from repro_torch.train import checkpoint, init_all, make_train_step
from test_torch_harness import ref_lm

SHAPE = ShapeConfig("tiny", 32, 4, "train")


def ref_checkpoint():
    import importlib

    ref_lm()
    return importlib.import_module("repro.train.checkpoint")


def same_bytes(a, b) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and a.cpu().view(torch.uint8).equal(b.cpu().view(torch.uint8)) \
        if a.dim() else a.item() == b.item() and a.dtype == b.dtype


def assert_same_state(a, b):
    flat_a, flat_b = checkpoint._flatten(a), checkpoint._flatten(b)
    assert [k for k, _ in flat_a] == [k for k, _ in flat_b]
    for (k, x), (_, y) in zip(flat_a, flat_b):
        assert same_bytes(x, y), k


def test_checkpoint_restart_is_exact(tmp_path):
    """3 steps, save, 2 more; restore the save and take the same 2 steps:
    parameters and optimizer state equal byte for byte (bfloat16 weights,
    float32 moments, the int32 step)."""
    cfg = get_arch("granite-moe-1b-a400m").reduced()
    model = Model(cfg, device="cpu", seed=0)
    oc = OptConfig(total_steps=10)
    params, opt = init_all(model, oc)
    step = make_train_step(model, oc)
    for s in range(3):
        params, opt, _ = step(params, opt, synthetic_batch(cfg, SHAPE, s, device="cpu"))
    checkpoint.save(str(tmp_path), 3, {"params": params, "opt": opt})
    for s in range(3, 5):
        params, opt, _ = step(params, opt, synthetic_batch(cfg, SHAPE, s, device="cpu"))
    done = {"params": {k: p.detach().clone() for k, p in params.items()}, "opt": opt}

    assert checkpoint.latest_step(str(tmp_path)) == 3
    state = checkpoint.restore(str(tmp_path), 3, {"params": params, "opt": opt})
    model.load_state_dict(state["params"])
    opt = state["opt"]
    assert int(opt["step"]) == 3
    for s in range(3, 5):
        params, opt, _ = step(params, opt, synthetic_batch(cfg, SHAPE, s, device="cpu"))
    assert_same_state({"params": params, "opt": opt}, done)


def test_integrity_check_detects_a_corrupt_save(tmp_path):
    checkpoint.save(str(tmp_path), 1, {"w": torch.arange(1000, dtype=torch.float32)})
    blob = tmp_path / "ckpt_00000001.npz"
    raw = bytearray(blob.read_bytes())
    raw[-200] ^= 0xFF
    blob.write_bytes(bytes(raw))
    with pytest.raises(IOError, match="integrity"):
        checkpoint.restore(str(tmp_path), 1, {"w": torch.zeros(1000)})


def test_keep_window_collects_old_saves(tmp_path):
    for s in range(1, 6):
        checkpoint.save(str(tmp_path), s, {"w": torch.full((3,), float(s))}, keep=3)
    assert checkpoint.all_steps(str(tmp_path)) == [3, 4, 5]
    assert sorted(os.listdir(tmp_path)) == [f"ckpt_{s:08d}.{e}" for s in (3, 4, 5) for e in ("json", "npz")]
    assert float(checkpoint.restore(str(tmp_path), 4, {"w": torch.zeros(3)})["w"][0]) == 4.0


def test_bfloat16_bits_round_trip(tmp_path):
    """bfloat16 leaves (with -0.0, infinities and a NaN payload) come back
    with their bits, in the dtype and on the device of ``like``; other
    dtypes as they were."""
    bits = torch.tensor([0x0000, 0x8000, 0x7F80, 0xFF80, 0x7FC1, 0xFFFF, 0x3F80, 0x0001], dtype=torch.int32)
    tree = {"a": {"bf": bits.to(torch.int16).view(torch.bfloat16), "f": torch.tensor([-0.0, 1.5])},
            "step": torch.tensor(7, dtype=torch.int32)}
    checkpoint.save(str(tmp_path), 2, tree)
    with np.load(tmp_path / "ckpt_00000002.npz") as data:
        assert data["leaf_0"].dtype == np.uint16  # the sorted first leaf: a/bf
        assert data["leaf_0"].tolist() == bits.tolist()
    like = {"a": {"bf": torch.zeros(8, dtype=torch.bfloat16), "f": torch.zeros(2)},
            "step": torch.zeros((), dtype=torch.int32)}
    out = checkpoint.restore(str(tmp_path), 2, like)
    assert_same_state(out, tree)


def test_layout_and_manifest_match_reference(tmp_path):
    """The same tree saved by both packages: the same file names, the same
    manifest keys, step and leaf count, and npz members of the same names,
    dtypes and bytes (bfloat16 as uint16 bits on both sides)."""
    import jax.numpy as jnp
    import ml_dtypes

    rc = ref_checkpoint()
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    b = rng.standard_normal(5).astype(ml_dtypes.bfloat16)
    rtree = {"params": {"w": jnp.asarray(w), "b": jnp.asarray(b)}, "opt": {"step": jnp.asarray(3, jnp.int32)}}
    tree = {"params": {"w": torch.from_numpy(w), "b": torch.from_numpy(b.view(np.int16)).view(torch.bfloat16)},
            "opt": {"step": torch.tensor(3, dtype=torch.int32)}}
    rdir, pdir = tmp_path / "ref", tmp_path / "port"
    rc.save(str(rdir), 3, rtree, extra={"arch": "x"})
    checkpoint.save(str(pdir), 3, tree, extra={"arch": "x"})
    assert sorted(os.listdir(rdir)) == sorted(os.listdir(pdir)) == ["ckpt_00000003.json", "ckpt_00000003.npz"]
    rman, man = (json.loads((d / "ckpt_00000003.json").read_text()) for d in (rdir, pdir))
    assert sorted(man) == sorted(rman) == ["extra", "nleaves", "sha256", "step", "treedef"]
    assert (man["step"], man["nleaves"], man["extra"]) == (rman["step"], rman["nleaves"], rman["extra"])
    with np.load(rdir / "ckpt_00000003.npz") as r, np.load(pdir / "ckpt_00000003.npz") as p:
        assert sorted(r.files) == sorted(p.files)
        for k in r.files:
            assert r[k].dtype == p[k].dtype and r[k].tobytes() == p[k].tobytes(), k
    assert rc.latest_step(str(rdir)) == checkpoint.latest_step(str(pdir)) == 3
