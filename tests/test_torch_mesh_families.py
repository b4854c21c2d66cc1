"""The mesh steps of the recurrent and audio families (xlstm and whisper
served tensor-parallel, jamba's super-block served and trained on a mesh)
on 8 gloo ranks of the host in the reference's (data 2, model 4) mesh, in
float32, against the JAX package's mesh steps on 8 host devices and
against the port's one-process steps.

As in ``tests/test_torch_mesh_steps.py``, three processes do the work,
once for the module: this one writes the inputs; the JAX package runs in
a subprocess with ``--xla_force_host_platform_device_count=8``, draws each
case's reduced model from ``key(0)``, runs its mesh prefill and three
decode steps and writes its parameters, logits and sanitized cache specs;
then ``python tests/test_torch_mesh_families.py DIR`` starts the 8 ranks
(never from a test function), each building the port's model from the
reference's parameters.

What must hold:

* prefill and decode logits equal the reference's mesh steps and the
  port's one-process steps within 1e-5 of the largest logit. The cases:
  xlstm (4 heads; model 4 puts each of ``w_zifo``'s four gates on a rank
  of its own), whisper (its frames split over the model axis), whisper at
  6 heads of 32 (d_model 192: the heads do not divide model 4, and 66
  frames do not either, so ``xk``/``xv`` are replicated), jamba at one
  super-block (``n_layers=8``; the reduced config's 4 layers make none)
  under ``1d`` and ``2d`` with its 4 experts over the model axis, and
  under ``1d`` with 2 experts and their FFN width split. The jamba cases
  whose experts cover the model axis are held to the reference's
  one-device steps: its expert-parallel mesh step drops records at each
  (source, destination) pair's capacity, where one device keeps every
  record of a batch of at most 512 (``ROADMAP.md`` §3);
* each cache leaf is placed as the reference's sanitized ``cache_specs``;
* after decode, every model rank holds the same bytes of xlstm's
  replicated ``mlstm``/``slstm`` state;
* jamba's mesh train step (``1d`` and ``2d`` with remat, ``2d`` with
  ``microbatches=2``, ``2d`` without remat, the FFN-split experts, and
  ``dp`` with ZeRO-1)
  equals the port's one-process step: the loss at rtol 1e-5, every updated
  leaf within 1e-5 of its largest magnitude, the same records dropped.
  AdamW has ``eps=1``, as in ``test_torch_mesh_steps.py``.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
MESH = (2, 4)
#: seconds each subprocess may take; the module takes ~100 s on one idle
#: worker, and its subprocesses run at a lower priority (``NICE``)
TIMEOUT = 600
#: the subprocesses' niceness: their 8 ranks and the reference's 8 host
#: devices yield the cores to the suite's other workers
NICE = ["nice", "-n", "10"]
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1.0)
JAMBA = "jamba-1.5-large-398b"

#: name -> (arch, overrides, the reference's steps it is held to: its
#: mesh steps, or its one-device steps)
SERVE = {
    "xlstm 1d": ("xlstm-350m", dict(param_sharding="1d"), "mesh"),
    "whisper 1d": ("whisper-tiny", dict(param_sharding="1d"), "mesh"),
    "whisper 6 heads": ("whisper-tiny", dict(param_sharding="1d", d_model=192, n_heads=6, n_kv_heads=6,
                                             head_dim=32, enc_positions=66), "mesh"),
    "jamba 1d ep": (JAMBA, dict(param_sharding="1d", n_layers=8), "one device"),
    "jamba 2d ep": (JAMBA, dict(param_sharding="2d", n_layers=8), "one device"),
    "jamba 1d ffn-split": (JAMBA, dict(param_sharding="1d", n_layers=8, moe_experts=2, moe_top_k=1), "mesh"),
}
#: jamba's train cases: name -> overrides
TRAIN = {
    "jamba 1d ep": dict(param_sharding="1d", n_layers=8),
    "jamba 2d ep": dict(param_sharding="2d", n_layers=8),
    "jamba 2d ep mb2": dict(param_sharding="2d", n_layers=8, microbatches=2),
    "jamba 2d ep no remat": dict(param_sharding="2d", n_layers=8, remat=False),
    "jamba dp": dict(param_sharding="dp", n_layers=8),
    "jamba 1d ffn-split": dict(param_sharding="1d", n_layers=8, moe_experts=2, moe_top_k=1),
}
PREFILL, CACHE, TRAIN_BS = (4, 16), 32, (4, 32)


def serve_cfg(case: str):
    from repro_torch.configs import get_arch

    arch, kw, _ = SERVE[case]
    return dataclasses.replace(get_arch(arch).reduced(), dtype="float32", **kw)


def train_cfg(case: str):
    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(JAMBA).reduced(), dtype="float32", **TRAIN[case])


# ------------------------------------------------------------------ ranks
def _serve(model, mesh, data, case):
    """Prefill and three decode steps: each step's logits, the cache."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    batch = {"tokens": torch.from_numpy(data[f"prompt/{case}"])}
    if f"frames/{case}" in data:
        batch["frames"] = torch.from_numpy(data[f"frames/{case}"])
    pre = make_prefill_step(model, mesh, CACHE)
    dec = make_decode_step(model, mesh, PREFILL[0], CACHE)
    with torch.no_grad():
        cache, logits = pre(batch)
        out = [logits.clone()]
        for t in data[f"decode/{case}"]:
            logits, cache = dec(cache, torch.from_numpy(t))
            out.append(logits.clone())
    return out, cache


def _leaves(cache, path=""):
    """(name, tensor) of every cache leaf but ``pos``: ``mamba.0`` etc."""
    for k, v in (cache.items() if isinstance(cache, dict) else enumerate(cache)):
        name = f"{path}.{k}" if path else str(k)
        if isinstance(v, (dict, tuple, list)):
            yield from _leaves(v, name)
        elif name != "pos":
            yield name, v


def _replicas_equal(mesh, t) -> bool:
    """Whether every rank of this rank's model-axis group holds the same
    bytes of ``t``'s local block."""
    from repro_torch.models import sharding as shd

    local = t.to_local().contiguous()
    every = shd.all_gather(local.reshape(1, -1), shd.axis_procs(mesh, "model"), 0)
    return all(torch.equal(every[0], row) for row in every)


def _serve_case(case: str, rank: int, root: str, data, mesh) -> dict:
    from repro_torch.core import params_from_reference
    from repro_torch.models import Model
    from repro_torch.models import sharding as shd

    with open(os.path.join(root, f"params_{list(SERVE).index(case)}.pkl"), "rb") as f:
        tree = pickle.load(f)
    cfg = serve_cfg(case)
    got, cache = _serve(Model(cfg, device="cpu", params=params_from_reference(tree, "cpu")), mesh, data, case)
    specs = {k: list(shd.spec_of(mesh, t.placements, t.dim())) for k, t in _leaves(cache)}
    equal = {k: _replicas_equal(mesh, t) for k, t in _leaves(cache) if k.split(".")[0] in ("mlstm", "slstm")}
    out = {}
    if rank == 0:
        one, _ = _serve(Model(cfg, device="cpu", params=params_from_reference(tree, "cpu")), None, data, case)
        out = dict(served=got, one_served=one, specs=specs, replicas_equal=equal)
    return out


def _train_case(case: str, rank: int, data, mesh) -> dict:
    from repro_torch.models import Model
    from repro_torch.models.sharding import full
    from repro_torch.optim import OptConfig
    from repro_torch.train import init_all, make_train_step

    cfg = train_cfg(case)
    oc = OptConfig(**OPT)
    batch = {"tokens": torch.from_numpy(data[f"tokens/{case}"]), "labels": torch.from_numpy(data[f"labels/{case}"])}
    model = Model(cfg, device="cpu", seed=0)
    params, opt = init_all(model, oc, mesh)
    params, opt, met = make_train_step(model, oc, mesh)(params, opt, batch)
    got = {k: full(p).detach().clone() for k, p in params.items()}
    out = {}
    if rank == 0:
        one = Model(cfg, device="cpu", seed=0)
        p1, o1 = init_all(one, oc)
        p1, o1, m1 = make_train_step(one, oc)(p1, o1, batch)
        out = dict(loss=float(met["loss"]), params=got, overflow=bool(met["aux_overflow"]),
                   one_loss=float(m1["loss"]), one_params={k: p.detach().clone() for k, p in p1.items()},
                   one_overflow=bool(m1["aux_overflow"]))
    return out


def _rank(rank: int, n: int, root: str) -> dict:
    from repro_torch.launch.mesh import make_mesh

    data = np.load(os.path.join(root, "inputs.npz"))
    mesh = make_mesh(MESH, ("data", "model"), "cpu")
    out = {"serve": {c: _serve_case(c, rank, root, data, mesh) for c in SERVE},
           "train": {c: _train_case(c, rank, data, mesh) for c in TRAIN}}
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
from test_torch_mesh_families import SERVE, MESH, CACHE, PREFILL
from repro.configs import get_arch
from repro.models import Model
from repro.launch.steps import make_prefill_step, make_decode_step
from repro.models import sharding as shd
data = np.load({root!r} + "/inputs.npz")
mesh = Mesh(np.array(jax.devices()[:8]).reshape(MESH), ("data", "model"))
out, specs = {{}}, {{}}
for i, name in enumerate(SERVE):
    arch, kw, held = SERVE[name]
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32", **kw)
    model = Model(cfg)
    params = model.init(jax.random.key(0))
    with open({root!r} + f"/params_{{i}}.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    cshapes = model.cache_shapes(PREFILL[0], CACHE)  # the decode step's cache shardings
    cspecs = shd.sanitize_specs(mesh, shd.cache_specs(cfg, mesh, cshapes), cshapes)
    flat = jax.tree_util.tree_flatten_with_path(cspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    specs[name] = {{".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): list(spec)
                    for path, spec in flat}}
    on = mesh if held == "mesh" else None
    batch = {{"tokens": jnp.asarray(data[f"prompt/{{name}}"])}}
    if f"frames/{{name}}" in data:
        batch["frames"] = jnp.asarray(data[f"frames/{{name}}"])
    cache, logits = make_prefill_step(model, on, CACHE)(params, batch)
    out[f"logits/{{name}}/0"] = np.asarray(logits)
    if on is not None:
        cache = jax.device_put(cache, shd.to_shardings(mesh, cspecs))
    dec = make_decode_step(model, on, PREFILL[0], CACHE)
    for j, t in enumerate(data[f"decode/{{name}}"]):
        logits, cache = dec(params, cache, jnp.asarray(t))
        out[f"logits/{{name}}/{{j + 1}}"] = np.asarray(logits)
np.savez({root!r} + "/reference.npz", **out)
with open({root!r} + "/specs.pkl", "wb") as f:
    pickle.dump(specs, f)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh_families"))
    rng = np.random.default_rng(25)
    data = {}
    for name in SERVE:
        cfg = serve_cfg(name)
        data[f"prompt/{name}"] = rng.integers(0, cfg.vocab, PREFILL).astype(np.int32)
        data[f"decode/{name}"] = rng.integers(0, cfg.vocab, (3, PREFILL[0])).astype(np.int32)
        if cfg.family == "audio":
            data[f"frames/{name}"] = rng.standard_normal((PREFILL[0], cfg.enc_positions, cfg.d_model)).astype(
                np.float32)
    for name in TRAIN:
        toks = rng.integers(0, train_cfg(name).vocab, TRAIN_BS).astype(np.int32)
        data[f"tokens/{name}"], data[f"labels/{name}"] = toks, np.roll(toks, -1, 1)
    np.savez(os.path.join(root, "inputs.npz"), **data)
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{HERE}")
    refenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    script = textwrap.dedent(_REFERENCE.format(src=str(SRC), tests=str(HERE), root=root))
    refp = subprocess.run(NICE + [sys.executable, "-c", script], env=refenv, capture_output=True, text=True,
                          timeout=TIMEOUT)
    assert refp.returncode == 0, f"reference failed:\n{refp.stderr[-4000:]}"
    ranks = subprocess.run(NICE + [sys.executable, str(Path(__file__)), root], env=env, capture_output=True,
                           text=True, timeout=TIMEOUT)
    assert ranks.returncode == 0, f"ranks failed:\n{(ranks.stdout + ranks.stderr)[-4000:]}"
    with open(os.path.join(root, "specs.pkl"), "rb") as f:
        specs = pickle.load(f)
    return dict(ref=np.load(os.path.join(root, "reference.npz")), specs=specs,
                port=torch.load(os.path.join(root, "ranks.pt"), weights_only=False))


def _close(got, want, what) -> None:
    scale = float(np.abs(want).max())
    assert tuple(got.shape) == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= 1e-5 * scale, (what, err, scale)


@pytest.mark.parametrize("case", list(SERVE))
def test_mesh_prefill_and_decode(runs, case):
    got = runs["port"]["serve"][case]
    for j, logits in enumerate(got["served"]):
        _close(logits.numpy(), got["one_served"][j].numpy(), f"{case} step {j} vs one process")
        _close(logits.numpy(), runs["ref"][f"logits/{case}/{j}"], f"{case} step {j} vs the reference's "
               f"{SERVE[case][2]} step")


@pytest.mark.parametrize("case", list(SERVE))
def test_mesh_cache_placed_by_the_sanitized_cache_specs(runs, case):
    """Every leaf's placements, read back as a spec, are the reference's
    sanitized ``cache_specs`` (K/V sequence-split, the Mamba states
    channel-split, the xlstm states replicated over the model axis,
    whisper's ``xk``/``xv`` frame-split where the frames divide)."""
    def entries(spec):  # an entry of one axis named alike, alone or in a tuple
        return [e[0] if isinstance(e, (tuple, list)) and len(e) == 1 else e for e in spec]

    got = {k: entries(v) for k, v in runs["port"]["serve"][case]["specs"].items()}
    want = {k: entries(v) for k, v in runs["specs"][case].items() if k != "pos"}
    assert got == want, case
    if case == "whisper 6 heads":
        assert want["xk"][2] is None and want["k"][2] == "model"
    if case == "whisper 1d":
        assert want["xk"][2] == "model"


def test_xlstm_state_copies_stay_equal(runs):
    """The state is replicated over the model axis: after prefill and three
    decode steps every model rank holds the same bytes of it."""
    equal = runs["port"]["serve"]["xlstm 1d"]["replicas_equal"]
    assert set(equal) == {f"{k}.{i}" for k in ("mlstm", "slstm") for i in range(3)} and all(equal.values()), equal


@pytest.mark.parametrize("case", list(TRAIN))
def test_jamba_mesh_train_step(runs, case):
    """One step on the mesh against the port's one-process step."""
    got = runs["port"]["train"][case]
    assert got["overflow"] == got["one_overflow"]
    np.testing.assert_allclose(got["loss"], got["one_loss"], rtol=1e-5)
    for k, want in got["one_params"].items():
        scale = float(want.abs().max())
        err = float((got["params"][k] - want).abs().max())
        assert err <= 1e-5 * scale, (case, k, err, scale)


_REHEARSAL = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
import chip_smoke as cs
import torch
import repro_torch.core as core
from repro_torch.kernels import _build as build
if __name__ == "__main__":
    cs.phase_mesh_families_path(torch, core, build, device="cpu", spec=cs.MESH_FAMILIES_REHEARSAL)
"""


def test_chip_smoke_mesh_families_path_rehearses_on_the_cpu():
    """``chip_smoke.py``'s ``mesh_families_path`` at the reduced widths on
    the host: the float32 parity of the three families' mesh steps with
    one process, the bf16 serving walls, no kernel launched."""
    script = textwrap.dedent(_REHEARSAL.format(src=str(SRC), root=str(HERE.parent)))
    r = subprocess.run(NICE + [sys.executable, "-c", script], capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith('{"phase": "mesh_families_path"')]
    assert len(lines) == 1 and '"ok": true' in lines[0]


if __name__ == "__main__":
    _main(sys.argv[1])
