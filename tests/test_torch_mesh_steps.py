"""The mesh steps (``make_train_step``, ``make_prefill_step``,
``make_decode_step``, ``launch.train.train`` and checkpoints on a
``DeviceMesh``) on 8 gloo ranks of the host in the reference's own (data
2, model 4) mesh, in float32, against the JAX package's mesh steps on 8
host devices and against the port's one-process steps.

Three processes do the work, once for the module: this one writes the
batches; the JAX package runs in a subprocess with
``--xla_force_host_platform_device_count=8`` (its 64-bit scope aliased as
``tests/test_torch_harness.py::reference`` does), draws each case's
reduced model from ``key(0)``, takes one mesh train step, a prefill and
three decode steps, and writes its parameters and results; then
``python tests/test_torch_mesh_steps.py DIR`` starts the 8 ranks
(``repro_torch.launch.mesh.spawn``, never from a test function), each
building the port's model from the reference's parameters.

What must hold, at the stated tolerances:

* the loss equals the reference's mesh step and the port's one-process
  step at rtol 1e-5, and every updated leaf is within 1e-5 of that leaf's
  largest magnitude of both. The step's AdamW has ``eps=1``: Adam's first
  update is about ``lr · sign(g)`` whatever ``|g|``, so with the default
  eps an element whose gradient is rounding noise moves by the learning
  rate in either direction; at eps 1 the update is about ``lr · g`` and
  the leaves show the gradients' agreement;
* MoE archs whose experts cover the model axis (reduced granite, 4
  experts on model 4; reduced mixtral), and the MoE cases the reference's
  mesh step does not run as one device (the ``dp`` policy's, 2 experts on
  model 4 with their FFN width split), are held to the port's
  one-process step only: the reference's expert-parallel exchange is byte-packed
  (``routing.pack_bytes``, a bitcast), which passes no gradient to the
  tokens, so its mesh gradient differs from its own one-device gradient,
  as one case shows. Both steps keep every record of a batch of at most
  512; above that, each expert keeps the first ceil(1.25 n / E) of the
  batch, which one case, its router scaled up, shows dropping records on
  both;
* prefill and decode logits equal the reference's mesh steps (the port's
  one-process steps for the EP archs) within 1e-5 of the largest logit;
* a checkpoint saved on the mesh holds the one-process checkpoint's npz
  members byte for byte and restores on a fresh mesh into its placements;
  ``launch.train(mesh=)`` for two steps equals ``launch.train()``.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
MESH = (2, 4)
#: seconds each subprocess may take; the module takes ~100 s on one worker
TIMEOUT = 300
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1.0)

#: name -> (arch, overrides, train (B, S), held to the reference's mesh steps)
CASES = {
    "tinyllama 1d": ("tinyllama-1.1b", dict(param_sharding="1d"), (4, 32), True),
    "tinyllama dp": ("tinyllama-1.1b", dict(param_sharding="dp"), (8, 16), True),
    "tinyllama 2d": ("tinyllama-1.1b", dict(param_sharding="2d"), (4, 32), True),
    "tinyllama 1d gqa": ("tinyllama-1.1b", dict(param_sharding="1d", n_kv_heads=2), (4, 32), True),
    "tinyllama 2d mb2": ("tinyllama-1.1b", dict(param_sharding="2d", microbatches=2), (8, 16), True),
    "granite ep": ("granite-moe-1b-a400m", dict(param_sharding="1d"), (4, 64), False),
    "granite ep capacity": ("granite-moe-1b-a400m", dict(param_sharding="1d"), (4, 128), False),
    "mixtral ep window": ("mixtral-8x22b", dict(sliding_window=16), (4, 64), False),
    "mixtral dp capacity": ("mixtral-8x22b", dict(param_sharding="dp"), (4, 128), False),
    "granite ffn-split experts": ("granite-moe-1b-a400m", dict(param_sharding="1d", moe_experts=2, moe_top_k=1),
                                  (4, 64), False),
}
NAMES = list(CASES)
#: cases whose router weights are scaled up: peaked routing, so the 1024
#: records of the batch overflow the one-device capacity and records drop
ROUTER_SCALE = {"granite ep capacity": 8.0, "mixtral dp capacity": 8.0}
#: the serving cases: prefill (B, S) at a cache of CACHE positions, 3 decode steps
SERVE = ["tinyllama 1d", "tinyllama 2d", "tinyllama 1d gqa", "granite ep", "mixtral ep window",
         "granite ffn-split experts"]
PREFILL, CACHE = (4, 16), 32


def cfg_of(case: str):
    from repro_torch.configs import get_arch

    arch, kw, _, _ = CASES[case]
    return dataclasses.replace(get_arch(arch).reduced(), dtype="float32", **kw)


# ------------------------------------------------------------------ ranks
def _full(t):
    from repro_torch.models.sharding import full

    return full(t).detach().clone()


def _all_ranks(flag: bool) -> bool:
    """Whether ``flag`` holds on every rank of the world."""
    import torch.distributed as dist

    t = torch.tensor([int(flag)])
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def _serve(model, mesh, data, case):
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    pre = make_prefill_step(model, mesh, CACHE)
    dec = make_decode_step(model, mesh, PREFILL[0], CACHE)
    with torch.no_grad():
        cache, logits = pre({"tokens": torch.from_numpy(data[f"prompt/{case}"])})
        out = [logits.clone()]
        for t in data[f"decode/{case}"]:
            logits, cache = dec(cache, torch.from_numpy(t))
            out.append(logits.clone())
    return out


def _case(case: str, rank: int, root: str, data) -> dict:
    from repro_torch.core import params_from_reference
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Model
    from repro_torch.optim import OptConfig
    from repro_torch.train import init_all, make_train_step

    with open(os.path.join(root, f"params_{NAMES.index(case)}.pkl"), "rb") as f:
        tree = pickle.load(f)
    if case in ROUTER_SCALE:
        tree["layers"]["router"] = tree["layers"]["router"] * ROUTER_SCALE[case]
    cfg = cfg_of(case)
    oc = OptConfig(**OPT)
    batch = {"tokens": torch.from_numpy(data[f"tokens/{case}"]), "labels": torch.from_numpy(data[f"labels/{case}"])}
    out = {}
    mesh = make_mesh(MESH, ("data", "model"), "cpu")
    model = Model(cfg, device="cpu", params=params_from_reference(tree, "cpu"))
    params, opt = init_all(model, oc, mesh)
    params, opt, met = make_train_step(model, oc, mesh)(params, opt, batch)
    full = {k: _full(p) for k, p in params.items()}
    if case in SERVE:
        served = _serve(Model(cfg, device="cpu", params=params_from_reference(tree, "cpu")), mesh, data, case)
    if rank == 0:
        out.update(loss=float(met["loss"]), params=full, overflow=bool(met.get("aux_overflow", False)))
        one = Model(cfg, device="cpu", params=params_from_reference(tree, "cpu"))
        p1, o1 = init_all(one, oc)
        p1, o1, m1 = make_train_step(one, oc)(p1, o1, batch)
        out.update(one_loss=float(m1["loss"]), one_params={k: p.detach().clone() for k, p in p1.items()},
                   one_overflow=bool(m1.get("aux_overflow", False)))
        if case in SERVE:
            out["served"] = served
            out["one_served"] = _serve(Model(cfg, device="cpu", params=params_from_reference(tree, "cpu")),
                                       None, data, case)
    return out


def _checkpoints(rank: int, root: str) -> dict:
    """Save at step 0 on the mesh and in one process; restore on a fresh
    mesh; then ``launch.train`` with and without the mesh."""
    import tempfile

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train
    from repro_torch.models import Model
    from repro_torch.optim import OptConfig
    from repro_torch.train import checkpoint, init_all

    cfg = cfg_of("tinyllama 2d")
    oc = OptConfig(**OPT)
    mesh = make_mesh(MESH, ("data", "model"), "cpu")
    model = Model(cfg, device="cpu", seed=0)
    params, opt = init_all(model, oc, mesh)
    fresh = make_mesh(MESH, ("data", "model"), "cpu")
    model2 = Model(cfg, device="cpu", seed=1)
    p2, o2 = init_all(model2, oc, fresh)
    ck_mesh, ck_one = os.path.join(root, "ck_mesh"), os.path.join(root, "ck_one")
    # save, then at once on every rank: latest_step and restore (nothing
    # between them orders rank 0's write before the other ranks' reads)
    checkpoint.save(ck_mesh, 0, {"params": params, "opt": opt})
    latest = checkpoint.latest_step(ck_mesh)
    state = checkpoint.restore(ck_mesh, 0, {"params": p2, "opt": o2})
    latest_everywhere = _all_ranks(latest == 0)
    placements_kept = all(list(state["params"][k].placements) == list(p2[k].placements) for k in p2)
    restored = {k: _full(t) for k, t in state["params"].items()}
    m_restored = {k: _full(t) for k, t in state["opt"]["m"].items()}
    with tempfile.TemporaryDirectory() as d:
        pm, om, lm = train(cfg_of("tinyllama dp"), steps=2, batch=8, seq=16, ckpt_dir=d, mesh=mesh, opt_cfg=oc)
        pm = {k: _full(p) for k, p in pm.items()}
    out = {}
    if rank == 0:
        one = Model(cfg, device="cpu", seed=0)
        p1, o1 = init_all(one, oc)
        checkpoint.save(ck_one, 0, {"params": p1, "opt": o1})
        with tempfile.TemporaryDirectory() as d:
            p0, o0, l0 = train(cfg_of("tinyllama dp"), steps=2, batch=8, seq=16, ckpt_dir=d, device="cpu",
                               opt_cfg=oc)
        out = dict(latest_everywhere=latest_everywhere, placements_kept=placements_kept, restored=restored,
                   m_restored=m_restored,
                   one_params={k: p.detach().clone() for k, p in p1.items()}, train_mesh=(lm, pm),
                   train_one=(l0, {k: p.detach().clone() for k, p in p0.items()}))
    return out


def _rank(rank: int, n: int, root: str) -> dict:
    data = np.load(os.path.join(root, "inputs.npz"))
    out = {"cases": {c: _case(c, rank, root, data) for c in NAMES}}
    out["checkpoints"] = _checkpoints(rank, root)
    return out if rank == 0 else {}


def _main(root: str) -> None:
    from repro_torch.launch.mesh import spawn

    torch.save(spawn(_rank, 8, device="cpu", args=(root,))[0], os.path.join(root, "ranks.pt"))


# -------------------------------------------------------------- reference
_REFERENCE = """
import sys, pickle, dataclasses
sys.path[:0] = [{src!r}, {tests!r}]
import numpy as np
from test_torch_harness import reference
reference()
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from test_torch_mesh_steps import CASES, NAMES, SERVE, OPT, MESH, CACHE, PREFILL
from repro.configs import get_arch
from repro.models import Model
from repro.optim import OptConfig, init_state
from repro.train import make_train_step
from repro.train.train_step import make_loss_fn
from repro.launch.steps import make_prefill_step, make_decode_step
from repro.models import sharding as shd
data = np.load({root!r} + "/inputs.npz")
mesh = Mesh(np.array(jax.devices()[:8]).reshape(MESH), ("data", "model"))
oc = OptConfig(**OPT)
out = {{}}
for i, name in enumerate(NAMES):
    arch, kw, _, held = CASES[name]
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32", **kw)
    model = Model(cfg)
    params = model.init(jax.random.key(0))
    with open({root!r} + f"/params_{{i}}.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    batch = {{"tokens": jnp.asarray(data[f"tokens/{{name}}"]), "labels": jnp.asarray(data[f"labels/{{name}}"])}}
    if held:
        donated = jax.tree.map(jnp.copy, params)  # the step donates its inputs
        p, o, m = make_train_step(model, oc, mesh)(donated, init_state(oc, donated), batch)
        out[f"loss/{{name}}"] = np.asarray(m["loss"])
        with open({root!r} + f"/updated_{{i}}.pkl", "wb") as f:
            pickle.dump(jax.tree.map(np.asarray, p), f)
        if name in SERVE:
            cache, logits = make_prefill_step(model, mesh, CACHE)(params, {{"tokens": jnp.asarray(data[f"prompt/{{name}}"])}})
            out[f"logits/{{name}}/0"] = np.asarray(logits)
            cshapes = model.cache_shapes(PREFILL[0], CACHE)  # the decode step's cache shardings
            cspecs = shd.sanitize_specs(mesh, shd.cache_specs(cfg, mesh, cshapes), cshapes)
            cache = jax.device_put(cache, shd.to_shardings(mesh, cspecs))
            dec = make_decode_step(model, mesh, PREFILL[0], CACHE)
            for j, t in enumerate(data[f"decode/{{name}}"]):
                logits, cache = dec(params, cache, jnp.asarray(t))
                out[f"logits/{{name}}/{{j + 1}}"] = np.asarray(logits)
    if name == "granite ep":
        g_mesh = jax.jit(jax.grad(lambda p, b: make_loss_fn(model, mesh)(p, b)[0]))(params, batch)
        g_one = jax.jit(jax.grad(lambda p, b: make_loss_fn(model, None)(p, b)[0]))(params, batch)
        out["grad_wq/mesh"] = np.asarray(g_mesh["layers"]["wq"])
        out["grad_wq/one"] = np.asarray(g_one["layers"]["wq"])
np.savez({root!r} + "/reference.npz", **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_steps"))
    rng = np.random.default_rng(24)
    data = {}
    for name in NAMES:
        b, s = CASES[name][2]
        toks = rng.integers(0, 512, (b, s)).astype(np.int32)
        data[f"tokens/{name}"], data[f"labels/{name}"] = toks, np.roll(toks, -1, 1)
        data[f"prompt/{name}"] = rng.integers(0, 512, PREFILL).astype(np.int32)
        data[f"decode/{name}"] = rng.integers(0, 512, (3, PREFILL[0])).astype(np.int32)
    np.savez(os.path.join(root, "inputs.npz"), **data)
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{HERE}")
    refenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    script = textwrap.dedent(_REFERENCE.format(src=str(SRC), tests=str(HERE), root=root))
    refp = subprocess.run([sys.executable, "-c", script], env=refenv, capture_output=True, text=True,
                          timeout=TIMEOUT)
    assert refp.returncode == 0, f"reference failed:\n{refp.stderr[-4000:]}"
    ranks = subprocess.run([sys.executable, str(Path(__file__)), root], env=env, capture_output=True,
                           text=True, timeout=TIMEOUT)
    assert ranks.returncode == 0, f"ranks failed:\n{(ranks.stdout + ranks.stderr)[-4000:]}"
    ref = np.load(os.path.join(root, "reference.npz"))
    updated = {}
    for i, name in enumerate(NAMES):
        path = os.path.join(root, f"updated_{i}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                updated[name] = pickle.load(f)
    return dict(root=root, ref=ref, updated=updated, port=torch.load(os.path.join(root, "ranks.pt"),
                                                                     weights_only=False))


def _leaf_close(got: dict, want: dict, what: str) -> None:
    for k in want:
        scale = float(np.abs(np.asarray(want[k], np.float32)).max())
        err = float(np.abs(np.asarray(got[k], np.float32) - np.asarray(want[k], np.float32)).max())
        assert err <= 1e-5 * scale, (what, k, err, scale)


def _named(t: dict) -> dict:
    return {k: v.numpy() for k, v in t.items()}


@pytest.mark.parametrize("case", NAMES)
def test_mesh_train_step(runs, case):
    """One step on the mesh against the reference's mesh step and the
    port's one-process step (see the module docstring)."""
    from repro_torch.core import params_from_reference

    got = runs["port"]["cases"][case]
    assert got["overflow"] == got["one_overflow"] == (case in ROUTER_SCALE)
    np.testing.assert_allclose(got["loss"], got["one_loss"], rtol=1e-5)
    _leaf_close(_named(got["params"]), _named(got["one_params"]), f"{case} vs one process")
    if CASES[case][3]:
        np.testing.assert_allclose(got["loss"], float(runs["ref"][f"loss/{case}"]), rtol=1e-5)
        want = {k: v.numpy() for k, v in params_from_reference(runs["updated"][case], "cpu").items()}
        _leaf_close(_named(got["params"]), want, f"{case} vs the reference's mesh step")


@pytest.mark.parametrize("case", SERVE)
def test_mesh_prefill_and_decode(runs, case):
    got = runs["port"]["cases"][case]
    for j, logits in enumerate(got["served"]):
        want = runs["ref"][f"logits/{case}/{j}"] if CASES[case][3] else got["one_served"][j].numpy()
        scale = float(np.abs(want).max())
        assert tuple(logits.shape) == want.shape
        err = float(np.abs(logits.numpy() - want).max())
        assert err <= 1e-5 * scale, (case, j, err, scale)
        one = got["one_served"][j].numpy()
        assert float(np.abs(logits.numpy() - one).max()) <= 1e-5 * float(np.abs(one).max()), (case, j)


def test_reference_ep_mesh_gradient_differs_from_its_own(runs):
    """The reference's byte-packed exchange cuts the gradient to the tokens:
    on the mesh its attention weights' gradient differs from its own
    one-device gradient, where the port's mesh step equals its one-process
    step (``test_mesh_train_step[granite ep]``)."""
    mesh, one = runs["ref"]["grad_wq/mesh"], runs["ref"]["grad_wq/one"]
    assert np.abs(mesh - one).max() > 1e-2 * np.abs(one).max()


def _members(path: str) -> dict:
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def test_mesh_checkpoint_bytes_and_restore(runs):
    import json

    root = runs["root"]
    mesh, one = (os.path.join(root, d, "ckpt_00000000") for d in ("ck_mesh", "ck_one"))
    assert _members(mesh + ".npz") == _members(one + ".npz")
    mj, oj = (json.load(open(p + ".json")) for p in (mesh, one))
    assert {k: v for k, v in mj.items() if k != "sha256"} == {k: v for k, v in oj.items() if k != "sha256"}
    got = runs["port"]["checkpoints"]
    assert got["placements_kept"]
    for k, p in got["one_params"].items():
        assert torch.equal(got["restored"][k], p), k
        assert not got["m_restored"][k].any(), k


def test_mesh_checkpoint_is_read_right_after_save(runs):
    """Every rank finds the step and restores it at once after ``save``:
    rank 0 writes, and ``save`` returns on no rank before the files are
    there."""
    got = runs["port"]["checkpoints"]
    assert got["latest_everywhere"]
    for k, p in got["one_params"].items():
        assert torch.equal(got["restored"][k], p), k


def test_launch_train_on_the_mesh_equals_one_process(runs):
    got = runs["port"]["checkpoints"]
    (lm, pm), (l0, p0) = got["train_mesh"], got["train_one"]
    np.testing.assert_allclose(lm, l0, rtol=1e-5)
    _leaf_close(_named(pm), _named(p0), "launch.train")


_REHEARSAL = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
import chip_smoke as cs
import torch
import repro_torch.core as core
from repro_torch.kernels import _build as build
if __name__ == "__main__":
    spec = dict(cs.MESH_SPEC, reduced=True, parity_train=(4, 32), parity_prefill=(4, 16), train=(4, 64),
                prefill=(4, 16), decode=(4, 32))
    cs.phase_mesh_path(torch, core, build, device="cpu", spec=spec)
"""


def test_chip_smoke_mesh_path_rehearses_on_the_cpu():
    """``chip_smoke.py``'s ``mesh_path`` at the reduced widths on the host:
    the gloo probe, the float32 parity of the mesh steps with one process,
    the bf16 steps' walls, no kernel launched."""
    script = textwrap.dedent(_REHEARSAL.format(src=str(SRC), root=str(HERE.parent)))
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith('{"phase": "mesh_path"')]
    assert len(lines) == 1 and '"ok": true' in lines[0]


if __name__ == "__main__":
    _main(sys.argv[1])
