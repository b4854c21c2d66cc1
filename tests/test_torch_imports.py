"""Every module of the port imports on its own, in a fresh interpreter,
and imports neither JAX nor the JAX package.

A module that only imports after some other module of the package (a
circular import that the usual import order hides) fails here, and so
does one that leaves ``jax`` or ``repro`` (or a submodule of either) in
``sys.modules``. The modules are found by walking the package; one
subprocess imports each in a fresh interpreter of its own, four at a
time, and reports the failures.
"""
from __future__ import annotations

import os
import subprocess
import sys

import pytest

from test_torch_harness import SRC

_EACH_ALONE = r"""
import pkgutil, subprocess, sys
from concurrent.futures import ThreadPoolExecutor
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]

CHECK = '''
import sys
import {name}
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "repro"))
sys.exit("imports " + ", ".join(bad[:5]) if bad else 0)
'''

def alone(name):
    p = subprocess.run([sys.executable, "-c", CHECK.format(name=name)], capture_output=True, text=True,
                       timeout=120)
    return name + ": " + (p.stderr.strip().splitlines() or ["?"])[-1] if p.returncode else None

with ThreadPoolExecutor(4) as pool:  # four interpreters at a time
    bad = [b for b in pool.map(alone, names) if b]
print(len(names), "modules")
print("\n".join(bad))
sys.exit(1 if bad else 0)
"""


def test_every_module_imports_alone():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", _EACH_ALONE], env=env, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 89, proc.stdout  # the audio family, roofline, dry-run, meshes included
    for name in ("repro_torch.configs.granite_moe_1b_a400m", "repro_torch.models.moe", "repro_torch.serve.engine",
                 "repro_torch.data.pipeline", "repro_torch.optim.adamw", "repro_torch.optim.compress",
                 "repro_torch.train.train_step", "repro_torch.train.checkpoint", "repro_torch.launch.train",
                 "repro_torch.models.ssm", "repro_torch.models.hybrid", "repro_torch.models.xlstm",
                 "repro_torch.models.encdec", "repro_torch.roofline.analysis", "repro_torch.launch.steps",
                 "repro_torch.launch.dryrun", "repro_torch.launch.mesh", "repro_torch.models.sharding"):
        assert name in _module_names(), name


def test_the_runner_modules_import_alone_and_start_no_group():
    """The multi-process runner's modules (the mesh, the processor groups,
    the sharded sort and the MoE's mesh paths) and the mesh steps' (the
    specs, the transformer, the train step, checkpoints, the serving
    steps, the drivers and the roofline), each alone: no JAX, no JAX
    package, and no process group started by an import."""
    check = ("import sys, importlib, torch.distributed as dist\n"
             "importlib.import_module(sys.argv[1])\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
             "sys.exit('imports ' + ', '.join(bad[:5]) if bad else ('started a group' if dist.is_initialized() else 0))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    for name in ("repro_torch.launch.mesh", "repro_torch.core.primitives", "repro_torch.core.api",
                 "repro_torch.core.routing", "repro_torch.models.moe", "repro_torch.models.sharding",
                 "repro_torch.models.transformer", "repro_torch.train.train_step", "repro_torch.train.checkpoint",
                 "repro_torch.launch.steps", "repro_torch.launch.dryrun", "repro_torch.launch.train",
                 "repro_torch.roofline.analysis"):
        proc = subprocess.run([sys.executable, "-c", check, name], env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, f"{name}: {proc.stdout}{proc.stderr[-2000:]}"


def _module_names():
    import pkgutil

    import repro_torch

    return [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]


@pytest.mark.cuda
def test_lm_serves_on_the_card_as_on_the_cpu():
    """The reduced granite-moe in float32, one set of weights on both
    devices: the card's greedy ``serve()`` streams equal the CPU's, and its
    prefill logits are within 1e-4 of the CPU's."""
    import dataclasses

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_arch
    from repro_torch.models import Model
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = dataclasses.replace(get_arch("granite-moe-1b-a400m").reduced(), dtype="float32")
    cpu = Model(cfg, device="cpu", seed=1)
    card = Model(cfg, device="cuda", params=cpu.state_dict())
    rng = np.random.default_rng(19)
    prompts = [rng.integers(0, cfg.vocab, int(n)).astype(np.int32) for n in rng.integers(8, 40, 6)]
    _, lg_cpu = cpu.prefill({"tokens": prompts[0][None]})
    _, lg_card = card.prefill({"tokens": prompts[0][None]})
    assert (lg_card.cpu() - lg_cpu).abs().max().item() <= 1e-4 * lg_cpu.abs().max().item()
    kw = dict(max_new_tokens=8, temperature=0.0, eos_id=cfg.vocab)  # no EOS: every budget runs out
    streams = [[s.tolist() for s in ServeEngine(m, ServeConfig(**kw)).serve(prompts, slots=3)] for m in (card, cpu)]
    assert streams[0] == streams[1]
