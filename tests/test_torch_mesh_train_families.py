"""The configurations the mesh steps took last, on 8 gloo ranks of the host
in the reference's (data 2, model 4) mesh, in float32, against the JAX
package's mesh steps on 8 host devices and against the port's
one-process steps: xlstm and whisper trained under ``1d``, ``2d`` and
``dp``; a tensor-parallel train step without sequence parallelism
(``seq_shard_activations=False``, and a sequence of 30 tokens, which model
4 does not divide: the residual replicated over the model axis); widths
that do not divide the model axis (a ``d_ff`` of 254, a ``d_model`` of
126 with 9 heads of 14: those weights stay whole; xlstm's cores and
jamba's Mamba at a width of 126 too); EP with a sequence of 30, and of 3
(one model rank routes no position); experts split by their FFN width (2
experts on model 4) at 1024 records, past the 512 below which nothing
drops; serving under the ``dp`` policy.

This module runs xlstm's and whisper's train steps held to the
reference's (``FAMILY_TRAIN``);
``tests/test_torch_mesh_train_families_serve.py`` runs the other cases
through the same machinery (``run_cases``), so that ``--dist loadfile``
spreads the two over two workers. As in
``tests/test_torch_mesh_families.py``, three processes do the work, once
for each module: this one writes the inputs; the JAX package runs in
a subprocess with ``--xla_force_host_platform_device_count=8``, draws each
case's reduced model from ``key(0)``, takes one mesh train step
(``repro.train.make_train_step(model, oc, mesh)``) or serves it on the
mesh (``launch.steps.make_prefill_step`` / ``make_decode_step``, the cache
resharded to the decode step's sanitized ``cache_specs``), and writes its
parameters, results and specs; then ``python
tests/test_torch_mesh_train_families.py DIR`` starts the 8 ranks (never
from a test function), each building the port's model from the
reference's parameters.

What must hold:

* the loss equals the reference's mesh step and the port's one-process
  step at rtol 1e-5, each MoE call drops as many records of the batch as
  one process's (``moe.counting_drops``), and every updated leaf is
  within 1e-5 of its largest magnitude, the scale floored at 1e-3 of the
  model's largest (mLSTM's ``b_i`` moves by rounding noise: ``ROADMAP.md``
  §3). AdamW has ``eps=1``, as in ``tests/test_torch_mesh_steps.py``. The
  EP cases (reduced granite, 4 experts on model 4; the reduced jamba at
  one super-block, ``n_layers=8``) are held to the port's one-process
  step only: the reference's byte-packed exchange passes no gradient to
  its tokens. So is the FFN-split granite, whose capacity rule the
  reference's mesh step does not apply as one device does
  (``tests/test_torch_mesh_steps.py``), and so are whisper's and xlstm's
  cases at width 126, to keep the reference's compiles to the cases it
  alone can check (the port's one-process steps equal the reference's in
  ``test_torch_encdec.py`` and ``test_torch_xlstm.py``);
* prefill and decode logits under ``dp`` (and at the uneven widths) equal
  the reference's mesh steps within 1e-5 of the largest logit (jamba's to
  the port's one process: its mesh MoE is the reference's EP step), and
  every cache leaf is placed as the reference's sanitized ``cache_specs``:
  the batch over ``data`` only, the sequence (jamba's Mamba channels) over
  ``model``, re-laid from prefill's rows over (``data``, ``model``);
* ``launch.train(mesh=)`` of xlstm under ``1d`` at 30 tokens equals
  ``launch.train()``;
* ``init_all`` on a mesh copies the tensors the model was built from, so
  a mesh step leaves them as they were (F10: a replicated leaf's block was
  the given tensor itself, and assigning a ``DTensor`` parameter's
  ``.data`` did not copy it).
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
TIMEOUT = 900
NICE = ["nice", "-n", "10"]
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1.0)
XLSTM = dict(n_layers=4, slstm_every=2)
WHISPER_6 = dict(d_model=192, n_heads=6, n_kv_heads=6, head_dim=32, enc_positions=66)
D_MODEL = dict(d_model=126, n_heads=9, n_kv_heads=3, head_dim=14)
UNEVEN = dict(d_model=126, n_heads=9, head_dim=14, d_ff=254)
JAMBA = "jamba-1.5-large-398b"

#: name -> (arch, overrides, train (B, S), held to the reference's mesh step)
TRAIN = {
    "xlstm 1d": ("xlstm-350m", dict(XLSTM, param_sharding="1d"), (4, 32), True),
    "xlstm 2d": ("xlstm-350m", dict(XLSTM, param_sharding="2d"), (4, 32), True),
    "xlstm dp": ("xlstm-350m", dict(XLSTM, param_sharding="dp"), (8, 16), True),
    "whisper 1d": ("whisper-tiny", dict(param_sharding="1d"), (4, 32), True),
    "whisper 2d": ("whisper-tiny", dict(param_sharding="2d"), (4, 32), True),
    "whisper dp": ("whisper-tiny", dict(param_sharding="dp"), (8, 16), True),
    "whisper 6 heads": ("whisper-tiny", dict(WHISPER_6, param_sharding="1d"), (4, 32), True),
    "tinyllama no sp": ("tinyllama-1.1b", dict(param_sharding="1d", seq_shard_activations=False), (4, 32), True),
    "tinyllama 2d s30": ("tinyllama-1.1b", dict(param_sharding="2d"), (4, 30), True),
    "tinyllama d_ff 254": ("tinyllama-1.1b", dict(param_sharding="1d", d_ff=254), (4, 32), True),
    "tinyllama d_model 126": ("tinyllama-1.1b", dict(D_MODEL, param_sharding="2d"), (4, 32), True),
    "whisper uneven": ("whisper-tiny", dict(UNEVEN, n_kv_heads=9, param_sharding="1d"), (4, 30), False),
    "xlstm uneven": ("xlstm-350m", dict(XLSTM, d_model=126, n_heads=9, param_sharding="2d"), (4, 30), False),
    "granite ep s30": ("granite-moe-1b-a400m", dict(param_sharding="1d"), (4, 30), False),
    "granite ep s3": ("granite-moe-1b-a400m", dict(param_sharding="1d"), (4, 3), False),
    "granite ffn-split s256": ("granite-moe-1b-a400m", dict(param_sharding="1d", moe_experts=2, moe_top_k=1),
                               (4, 256), False),
    "jamba ep uneven s30": (JAMBA, dict(param_sharding="1d", n_layers=8, d_model=126, mamba_expand=1, d_ff=254),
                            (4, 30), False),
}
#: name -> (arch, overrides, prefill (B, S), held to the reference's mesh
#: steps). The reference's dp steps take a batch the whole mesh divides;
#: jamba's 4 rows split over data only (the sanitized prefix), so its
#: prefill already computes in the cache's rows
SERVE = {
    "tinyllama dp": ("tinyllama-1.1b", dict(param_sharding="dp"), (8, 16), True),
    "xlstm dp": ("xlstm-350m", dict(XLSTM, param_sharding="dp"), (8, 16), True),
    "whisper dp": ("whisper-tiny", dict(param_sharding="dp"), (8, 16), True),
    "tinyllama d_model 126": ("tinyllama-1.1b", dict(D_MODEL, param_sharding="1d"), (4, 16), True),
    "jamba dp": (JAMBA, dict(param_sharding="dp", n_layers=8), (4, 16), False),
}
#: case -> the leading positions of every row that hold one token: their
#: states are alike into the first MoE layer (attention over equal values
#: returns that value), so they route alike and 768 of the 1024 records
#: meet one of the 2 experts, past its 640: records drop there, in the
#: batch's order across the data axis (and in later layers as they fall)
SKEWED = {"granite ffn-split s256": 192}
CACHE = 32
LAUNCH_TRAIN = dict(steps=2, batch=4, seq=30)
#: the train cases this module runs; the others, the served cases and the
#: launch and init checks run in ``test_torch_mesh_train_families_serve.py``
#: (two modules, so that ``--dist loadfile`` spreads them over two workers)
FAMILY_TRAIN = [c for c in TRAIN if c.startswith(("xlstm", "whisper")) and TRAIN[c][3]]
OTHER_TRAIN = [c for c in TRAIN if c not in FAMILY_TRAIN]


def cfg_of(arch: str, kw: dict):
    from repro_torch.configs import get_arch

    return dataclasses.replace(get_arch(arch).reduced(), dtype="float32", **kw)


def _batch(data, prefix: str, case: str) -> dict:
    return {k: torch.from_numpy(data[f"{k}/{prefix}/{case}"]) for k in ("tokens", "labels", "frames")
            if f"{k}/{prefix}/{case}" in data}


# ------------------------------------------------------------------ ranks
def _full(t):
    from repro_torch.models.sharding import full

    return full(t).detach().clone()


def _params(root: str, kind: str, case: str, held: bool):
    """A case's parameters by state-dict name: the reference's draw for a
    case held to the reference, else None (the port's seeded draw)."""
    from repro_torch.core import params_from_reference

    if not held:
        return None
    with open(os.path.join(root, f"params_{kind}_{case}.pkl"), "rb") as f:
        return params_from_reference(pickle.load(f), "cpu")


def _model(cfg, params):
    from repro_torch.models import Model

    return Model(cfg, device="cpu", seed=0, params=None if params is None else dict(params))


def _train_case(case: str, rank: int, root: str, data, mesh) -> dict:
    from repro_torch.models.moe import counting_drops
    from repro_torch.optim import OptConfig
    from repro_torch.train import init_all, make_train_step

    drawn = _params(root, "train", case, TRAIN[case][3])
    cfg = cfg_of(*TRAIN[case][:2])
    oc = OptConfig(**OPT)
    batch = _batch(data, "train", case)
    model = _model(cfg, drawn)
    params, opt = init_all(model, oc, mesh)
    with counting_drops() as drops:
        params, opt, met = make_train_step(model, oc, mesh)(params, opt, batch)
    got = {k: _full(p) for k, p in params.items()}
    if rank:
        return {}
    one = _model(cfg, drawn)
    p1, o1 = init_all(one, oc)
    with counting_drops() as one_drops:
        p1, o1, m1 = make_train_step(one, oc)(p1, o1, batch)
    return dict(loss=float(met["loss"]), params=got, overflow=bool(met.get("aux_overflow", False)),
                drops=[int(n) for n in drops], one_loss=float(m1["loss"]),
                one_params={k: p.detach().clone() for k, p in p1.items()},
                one_overflow=bool(m1.get("aux_overflow", False)), one_drops=[int(n) for n in one_drops])


def _serve(model, mesh, data, case):
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    batch = {k: v for k, v in _batch(data, "serve", case).items() if k != "labels"}
    pre = make_prefill_step(model, mesh, CACHE)
    dec = make_decode_step(model, mesh, SERVE[case][2][0], CACHE)
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


def _serve_case(case: str, rank: int, root: str, data, mesh) -> dict:
    from repro_torch.models import sharding as shd

    drawn = _params(root, "serve", case, SERVE[case][3])
    cfg = cfg_of(*SERVE[case][:2])
    got, cache = _serve(_model(cfg, drawn), mesh, data, case)
    specs = {k: list(shd.spec_of(mesh, t.placements, t.dim())) for k, t in _leaves(cache)}
    if rank:
        return {}
    one, _ = _serve(_model(cfg, drawn), None, data, case)
    return dict(served=got, one_served=one, specs=specs)


def _launch_train(rank: int, mesh) -> dict:
    """``launch.train`` of the reduced xlstm under 1d at a sequence model 4
    does not divide, on the mesh and in one process."""
    import tempfile

    from repro_torch.launch.train import train
    from repro_torch.optim import OptConfig

    cfg = cfg_of("xlstm-350m", dict(XLSTM, param_sharding="1d"))
    oc = OptConfig(**OPT)
    with tempfile.TemporaryDirectory() as d:
        pm, _, lm = train(cfg, ckpt_dir=d, mesh=mesh, opt_cfg=oc, **LAUNCH_TRAIN)
        pm = {k: _full(p) for k, p in pm.items()}
    if rank:
        return {}
    with tempfile.TemporaryDirectory() as d:
        p0, _, l0 = train(cfg, ckpt_dir=d, device="cpu", opt_cfg=oc, **LAUNCH_TRAIN)
    return dict(mesh=(lm, pm), one=(l0, {k: p.detach().clone() for k, p in p0.items()}))


def _given_tensors_kept(mesh) -> bool:
    """``init_all`` on a mesh copies the tensors a model was built from: a
    step leaves them as they were (a replicated leaf's block is the given
    tensor itself until then)."""
    from repro_torch.optim import OptConfig
    from repro_torch.train import init_all, make_train_step

    cfg = cfg_of("tinyllama-1.1b", dict(param_sharding="1d"))
    given = {k: p.detach() for k, p in _model(cfg, None).named_parameters()}
    kept = {k: t.clone() for k, t in given.items()}
    model = _model(cfg, given)
    params, opt = init_all(model, OptConfig(**OPT), mesh)
    toks = torch.arange(64, dtype=torch.int32).reshape(4, 16)
    make_train_step(model, OptConfig(**OPT), mesh)(params, opt, {"tokens": toks, "labels": toks})
    return all(torch.equal(given[k], kept[k]) for k in given)


def _rank(rank: int, n: int, root: str) -> dict:
    from repro_torch.launch.mesh import make_mesh

    data = np.load(os.path.join(root, "inputs.npz"))
    with open(os.path.join(root, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    mesh = make_mesh(MESH, ("data", "model"), "cpu")
    out = {"train": {c: _train_case(c, rank, root, data, mesh) for c in cases["train"]},
           "serve": {c: _serve_case(c, rank, root, data, mesh) for c in cases["serve"]}}
    if cases["extras"]:
        out.update(launch_train=_launch_train(rank, mesh), given_tensors_kept=_given_tensors_kept(mesh))
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
from test_torch_mesh_train_families import TRAIN, SERVE, MESH, CACHE, OPT
from repro.configs import get_arch
from repro.models import Model
from repro.optim import OptConfig, init_state
from repro.train import make_train_step
from repro.launch.steps import make_prefill_step, make_decode_step
from repro.models import sharding as shd
data = np.load({root!r} + "/inputs.npz")
with open({root!r} + "/cases.pkl", "rb") as f:
    cases = pickle.load(f)
mesh = Mesh(np.array(jax.devices()[:8]).reshape(MESH), ("data", "model"))
oc = OptConfig(**OPT)
out, specs, updated = {{}}, {{}}, {{}}


def batch_of(prefix, name, keys):
    return {{k: jnp.asarray(data[f"{{k}}/{{prefix}}/{{name}}"]) for k in keys if f"{{k}}/{{prefix}}/{{name}}" in data}}


drawn = {{}}  # init by the shapes' config: the policy does not change the draw


def model_of(kind, name, arch, kw):
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32", **kw)
    model = Model(cfg)
    shapes = repr(sorted((k, v) for k, v in kw.items() if k not in ("param_sharding", "seq_shard_activations")))
    if (arch, shapes) not in drawn:
        drawn[arch, shapes] = model.init(jax.random.key(0))
    params = drawn[arch, shapes]
    with open({root!r} + f"/params_{{kind}}_{{name}}.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    return cfg, model, params


for name in cases["train"]:
    arch, kw, _, held = TRAIN[name]
    if held:
        cfg, model, params = model_of("train", name, arch, kw)
        donated = jax.tree.map(jnp.copy, params)  # the step donates its inputs
        p, o, m = make_train_step(model, oc, mesh)(donated, init_state(oc, donated),
                                                   batch_of("train", name, ("tokens", "labels", "frames")))
        out[f"loss/{{name}}"] = np.asarray(m["loss"])
        updated[name] = jax.tree.map(np.asarray, p)
for name in cases["serve"]:
    arch, kw, (rows, _), held = SERVE[name]
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32", **kw)
    model = Model(cfg)
    cshapes = model.cache_shapes(rows, CACHE)  # the decode step's cache shardings
    cspecs = shd.sanitize_specs(mesh, shd.cache_specs(cfg, mesh, cshapes), cshapes)
    flat = jax.tree_util.tree_flatten_with_path(cspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    specs[name] = {{".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): list(spec)
                    for path, spec in flat}}
    if not held:
        continue
    cfg, model, params = model_of("serve", name, arch, kw)
    cache, logits = make_prefill_step(model, mesh, CACHE)(params, batch_of("serve", name, ("tokens", "frames")))
    out[f"logits/{{name}}/0"] = np.asarray(logits)
    cache = jax.device_put(cache, shd.to_shardings(mesh, cspecs))
    dec = make_decode_step(model, mesh, rows, CACHE)
    for j, t in enumerate(data[f"decode/{{name}}"]):
        logits, cache = dec(params, cache, jnp.asarray(t))
        out[f"logits/{{name}}/{{j + 1}}"] = np.asarray(logits)
np.savez({root!r} + "/reference.npz", **out)
with open({root!r} + "/specs.pkl", "wb") as f:
    pickle.dump(specs, f)
with open({root!r} + "/updated.pkl", "wb") as f:
    pickle.dump(updated, f)
"""


def run_cases(tmp_path_factory, train: list, serve: list, extras: bool) -> dict:
    """The inputs of the ``train`` and ``serve`` cases (and, with
    ``extras``, ``launch.train`` and the ``init_all`` check) through the
    reference's subprocess and the 8 ranks; their results."""
    root = str(tmp_path_factory.mktemp("mesh_train_families"))
    rng = np.random.default_rng(26)
    data = {}

    def draw(prefix, name, cfg, b, s):
        toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
        toks[:, : SKEWED.get(name, 0)] = toks[0, 0]
        data[f"tokens/{prefix}/{name}"], data[f"labels/{prefix}/{name}"] = toks, np.roll(toks, -1, 1)
        if cfg.family == "audio":
            data[f"frames/{prefix}/{name}"] = rng.standard_normal((b, cfg.enc_positions, cfg.d_model)).astype(
                np.float32)

    for name in train:
        arch, kw, (b, s), _ = TRAIN[name]
        draw("train", name, cfg_of(arch, kw), b, s)
    for name in serve:
        arch, kw, (b, s), _ = SERVE[name]
        cfg = cfg_of(arch, kw)
        draw("serve", name, cfg, b, s)
        data[f"decode/{name}"] = rng.integers(0, cfg.vocab, (3, b)).astype(np.int32)
    np.savez(os.path.join(root, "inputs.npz"), **data)
    with open(os.path.join(root, "cases.pkl"), "wb") as f:
        pickle.dump(dict(train=list(train), serve=list(serve), extras=extras), f)
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
    with open(os.path.join(root, "updated.pkl"), "rb") as f:
        updated = pickle.load(f)
    return dict(ref=np.load(os.path.join(root, "reference.npz")), specs=specs, updated=updated,
                port=torch.load(os.path.join(root, "ranks.pt"), weights_only=False))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory, FAMILY_TRAIN, [], extras=False)


def _leaf_close(got: dict, want: dict, what: str) -> None:
    """Every leaf within 1e-5 of its largest magnitude, the scale floored at
    1e-3 of the model's largest."""
    top = max(float(np.abs(np.asarray(w, np.float32)).max()) for w in want.values())
    for k in want:
        w = np.asarray(want[k], np.float32)
        scale = max(float(np.abs(w).max()), 1e-3 * top)
        err = float(np.abs(np.asarray(got[k], np.float32) - w).max())
        assert err <= 1e-5 * scale, (what, k, err, scale)


def _named(t: dict) -> dict:
    return {k: v.numpy() for k, v in t.items()}


def check_train_step(runs, case):
    """One step on the mesh against the port's one-process step and, for the
    cases so marked, the reference's mesh step (see the module docstring)."""
    from repro_torch.core import params_from_reference

    got = runs["port"]["train"][case]
    assert got["overflow"] == got["one_overflow"]
    assert got["drops"] == got["one_drops"], case  # each MoE call's dropped records, the whole batch's
    if case in SKEWED:  # the capacity rule drops records in the first MoE call
        assert got["one_drops"][0] > 0, got["one_drops"]
    np.testing.assert_allclose(got["loss"], got["one_loss"], rtol=1e-5)
    _leaf_close(_named(got["params"]), _named(got["one_params"]), f"{case} vs one process")
    if TRAIN[case][3]:
        np.testing.assert_allclose(got["loss"], float(runs["ref"][f"loss/{case}"]), rtol=1e-5)
        want = {k: v.numpy() for k, v in params_from_reference(runs["updated"][case], "cpu").items()}
        _leaf_close(_named(got["params"]), want, f"{case} vs the reference's mesh step")


def check_prefill_and_decode(runs, case):
    got = runs["port"]["serve"][case]
    for j, logits in enumerate(got["served"]):
        wants = [("one process", got["one_served"][j].numpy())]
        if SERVE[case][3]:
            wants.append(("the reference's mesh step", runs["ref"][f"logits/{case}/{j}"]))
        for what, want in wants:
            scale = float(np.abs(want).max())
            assert tuple(logits.shape) == want.shape, (case, j, what)
            err = float(np.abs(logits.numpy() - want).max())
            assert err <= 1e-5 * scale, (case, j, what, err, scale)


def check_cache_specs(runs, case):
    """Every leaf's placements, read back as a spec, are the reference's
    sanitized ``cache_specs``; under ``dp`` that is not the layout prefill
    computes in (rows over data and model), so the cache was re-laid."""
    def entries(spec):  # an entry of one axis named alike, alone or in a tuple
        return [e[0] if isinstance(e, (tuple, list)) and len(e) == 1 else e for e in spec]

    got = {k: entries(v) for k, v in runs["port"]["serve"][case]["specs"].items()}
    want = {k: entries(v) for k, v in runs["specs"][case].items() if k != "pos"}
    assert got == want, case
    if case in ("tinyllama dp", "whisper dp"):
        assert want["k"][1] == "data" and want["k"][2] == "model"


def check_launch_train(runs):
    got = runs["port"]["launch_train"]
    (lm, pm), (l0, p0) = got["mesh"], got["one"]
    np.testing.assert_allclose(lm, l0, rtol=1e-5)
    _leaf_close(_named(pm), _named(p0), "launch.train")


@pytest.mark.parametrize("case", FAMILY_TRAIN)
def test_mesh_train_step(runs, case):
    check_train_step(runs, case)


if __name__ == "__main__":
    _main(sys.argv[1])
