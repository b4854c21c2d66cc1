"""The sharded sort (``bsp_sort_sharded``, ``bsp_sort_sharded_safe``, the
executor's sharded entries) on 8 gloo ranks of the host, one processor a
rank, against the port's ``bsp_sort`` and the JAX package's
``bsp_sort_sharded`` on 8 host devices.

Three processes do the work, once for the module: this one writes the
inputs and the reference's sample draws; ``python tests/test_torch_sharded.py
DIR`` starts the 8 ranks (``repro_torch.launch.mesh.spawn``; the ranks are
never spawned from a test function, so pytest-xdist's workers stay out of
it); and the JAX package runs in a subprocess of its own with
``--xla_force_host_platform_device_count=8`` (its 64-bit scope aliased as
``tests/test_torch_harness.py::reference`` does). The randomized sorts
(iran, ran) take the draws of the reference's ``random_sample`` under its
``key(seed)`` on every rank, so all three runs take the same sample.

Every case must give the same bytes three ways: each rank's row equals the
matching row of the port's ``bsp_sort`` and of the reference's
``bsp_sort_sharded`` (buffers, counts, payloads, the overflow flag).
Tolerance: exact. Then the escalation and the executor's cache, the
reference's own distributed tests ported as cases of one test, and the
group primitives against their simulated-processor forms.
"""
from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"
P, NP = 8, 2048
#: seconds each subprocess may take; the module takes ~60 s on one worker
TIMEOUT = 240

#: (name, SortConfig overrides, distribution, key dtype, payload count)
CASES = [
    *[(f"{a} {d}", dict(algorithm=a), d, "int32", 0)
      for a in ("det", "iran", "ran", "bitonic") for d in ("U", "DD", "WR")],
    ("det ring U+payload", dict(routing="ring"), "U", "int32", 1),
    ("det ring per_array U+payload", dict(routing="ring", exchange="per_array"), "U", "int32", 1),
    ("det allgather U+payload", dict(routing="allgather"), "DD", "int32", 1),
    ("iran allgather U", dict(algorithm="iran", routing="allgather"), "U", "int32", 0),
    ("det bitonic-sample U", dict(sample_sort="bitonic"), "U", "int32", 0),
    ("iran bitonic-sample DD", dict(algorithm="iran", sample_sort="bitonic"), "DD", "int32", 0),
    ("det tree U", dict(merge="tree", merge_backend="pallas", local_sort="bitonic"), "U", "int32", 0),
    ("det tree DD+payload", dict(merge="tree", merge_backend="pallas"), "DD", "int32", 1),
    ("det sort-merge U+payload", dict(merge="sort", exchange="per_array"), "U", "int32", 1),
    ("radix U", dict(route="radix"), "U", "int32", 0),
    ("radix DD+payload", dict(route="radix", merge="tree"), "DD", "int32", 1),
    ("det float32 +-0 NaN", dict(merge="tree", merge_backend="pallas"), "U", "float32", 0),
    ("det uint32 U", dict(), "U", "uint32", 0),
    ("det bfloat16 U", dict(local_sort="bitonic"), "U", "bfloat16", 0),
    ("det int64 U", dict(), "U", "int64", 0),
    ("radix int64 U+payload", dict(route="radix"), "U", "int64", 1),
]
NAMES = [c[0] for c in CASES]

#: the ported distributed tests of the JAX package, and the primitives
DRIVER_CASES = ["resumes_and_caches", "resume_false", "radix_one_rung", "mesh_keyed_cache", "traced", "primitives"]
#: the traced runs: det's splitter estimate and radix's exact counts
TRACED = (dict(algorithm="det"), dict(route="radix"))


def make_input(dist: str, dtype: str) -> np.ndarray:
    """(P, NP) keys from a seed; bfloat16 keys as their int16 bits, rounded
    here (torch's host cast of a NaN to bfloat16 gives 0xffff, jnp's
    0x7fc0: the packages must start from the same bits)."""
    from repro_torch.core import datagen

    x = datagen.generate(dist, P, NP, seed=7)
    if dtype == "int32":
        return x
    if dtype == "uint32":
        return (x.astype(np.int64) * 7919 - 2**30).astype(np.uint32)
    if dtype == "int64":
        return x.astype(np.int64) * (2**33 + 3) - 2**40
    f = x.astype(np.float32)
    rng = np.random.default_rng(11)
    f[rng.random(f.shape) < 1 / 16] = -0.0
    f[rng.random(f.shape) < 1 / 16] = 0.0
    f[rng.random(f.shape) < 1 / 64] = np.nan
    if dtype == "float32":
        return f
    u = f.view(np.uint32).astype(np.uint64)
    bits = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint16)  # round to nearest even
    bits[np.isnan(f)] = 0x7FC0
    return bits.view(np.int16)


def torch_keys(a: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.view(torch.bfloat16) if dtype == "bfloat16" else t


def payload() -> np.ndarray:
    return np.arange(P * NP, dtype=np.int32).reshape(P, NP) * 3 - 5


def adversarial(n_p: int) -> np.ndarray:
    return np.repeat((np.arange(P, dtype=np.int32) * 1000)[:, None], n_p, axis=1)


def host(t: torch.Tensor) -> np.ndarray:
    """Bytes-comparable host array (bfloat16 as its bits)."""
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


# ------------------------------------------------------------------ ranks
def _draws_for(cfg, draws):
    """``api._positions`` replaced: the reference's draws of the case."""
    def positions(tier_cfg, rung, generator, device):
        if tier_cfg.algorithm not in ("iran", "ran") or tier_cfg.route == "radix":
            return None
        return torch.from_numpy(draws).to(device)

    return positions


def _rank(rank: int, n: int, root: str) -> dict:
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core import api, bsp_sort_sharded
    from repro_torch.core.types import SortConfig

    data = np.load(os.path.join(root, "inputs.npz"))
    mesh = DeviceMesh("cpu", torch.arange(n), mesh_dim_names=("procs",))
    own_draws = api._positions
    out = {}
    for i, (name, kw, _, dtype, nv) in enumerate(CASES):
        x = torch_keys(data[f"x{i}"], dtype)
        vals = [torch.from_numpy(data["payload"])][:nv]
        cfg = SortConfig(p=P, n_per_proc=NP, **kw)
        if f"draws{i}" in data.files:
            api._positions = _draws_for(cfg, data[f"draws{i}"])
        res, pv = bsp_sort_sharded(x[rank:rank + 1], mesh, "procs", cfg, values=[v[rank:rank + 1] for v in vals])
        out[name] = dict(buf=res.buf, count=res.count, overflow=bool(res.overflow), vals=pv)
        api._positions = own_draws
    return dict(cases=out, drivers={c: _driver_case(c, rank, n, mesh) for c in DRIVER_CASES})


def _driver_case(case: str, rank: int, n: int, mesh) -> dict:
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core import SortConfig, SortExecutor, bsp_sort_sharded, bsp_sort_sharded_safe, datagen
    from repro_torch.core.primitives import GroupProcs

    if case in ("resumes_and_caches", "resume_false", "radix_one_rung"):
        x = torch.from_numpy(adversarial(NP))
        kw = dict(algorithm="iran", pair_capacity="whp")
        if case == "radix_one_rung":
            kw = dict(route="radix", pair_capacity="whp")
        cfg = SortConfig(p=P, n_per_proc=NP, **kw)
        ex = SortExecutor()
        resume = case != "resume_false"
        res, _, st = bsp_sort_sharded_safe(x[rank:rank + 1], mesh, "procs", cfg, executor=ex, resume=resume)
        first = dict(ex.trace_counts)
        res2, _, st2 = bsp_sort_sharded_safe(x[rank:rank + 1], mesh, "procs", cfg, executor=ex, resume=resume)
        return dict(buf=res.buf, count=res.count, row=st.as_row(), row2=st2.as_row(), same=torch.equal(res.buf, res2.buf),
                    first=[(k[0], k[1], v) for k, v in first.items()], again=dict(ex.trace_counts) == first)
    if case == "traced":
        from repro_torch.obs import Tracer

        x = torch.from_numpy(datagen.generate("G", P, NP, seed=9))
        got = []
        for kw in TRACED:
            tracer = Tracer()
            res, _, _ = bsp_sort_sharded_safe(x[rank:rank + 1], mesh, "procs", SortConfig(p=P, n_per_proc=NP, obs=tracer,
                                                                                        **kw))
            plain, _, _ = bsp_sort_sharded_safe(x[rank:rank + 1], mesh, "procs", SortConfig(p=P, n_per_proc=NP, **kw))
            got.append(dict(same=torch.equal(res.buf, plain.buf) and torch.equal(res.count, plain.count),
                            spans=[sp["name"] for sp in tracer.spans],
                            points=[(pt["name"], pt["args"]) for pt in tracer.points if pt["name"] == "distribution"]))
        return dict(traced=got)
    if case == "mesh_keyed_cache":
        mesh_b = DeviceMesh("cpu", torch.arange(n).flip(0), mesh_dim_names=("procs",))
        x = torch.from_numpy(datagen.generate("U", P, 512, seed=3))
        cfg = SortConfig(p=P, n_per_proc=512, algorithm="det")
        ex = SortExecutor()
        got = {}
        for tag, m in (("a", mesh), ("b", mesh_b)):
            me = GroupProcs.from_mesh(m, "procs").index
            res, _ = bsp_sort_sharded(x[me:me + 1], m, "procs", cfg, executor=ex)
            got[tag] = (me, res.buf, res.count)
        keys = list(ex.trace_counts)
        counts = dict(ex.trace_counts)
        bsp_sort_sharded(x[got["a"][0]:got["a"][0] + 1], mesh, "procs", cfg, executor=ex)
        bsp_sort_sharded(x[got["b"][0]:got["b"][0] + 1], mesh_b, "procs", cfg, executor=ex)
        return dict(got=got, n_keys=len(keys), meshes_distinct=keys[0][4] is not keys[1][4] and keys[0][4] != keys[1][4],
                    built_once=all(v == 1 for v in counts.values()), hits_only=dict(ex.trace_counts) == counts)
    # the group primitives on one float row and one int row a rank, and
    # the mesh constructors
    from repro_torch.launch.mesh import host_device_mesh, make_production_mesh

    try:
        make_production_mesh(device_type="cpu")
        refused = False
    except RuntimeError as e:
        refused = "need 256 ranks" in str(e)
    host = host_device_mesh(n, "procs")
    g = GroupProcs.from_mesh(mesh, "procs")
    f = torch.arange(6, dtype=torch.float32).reshape(1, 6) + 10 * rank
    f[0, 0] = -0.0 if rank % 2 else float("nan")
    c = torch.tensor([[rank, 2 * rank + 1, 7]], dtype=torch.int32)
    return dict(
        proc_id=g.proc_id("cpu"), bcast=g.broadcast_from(f, 3), prefix=g.prefix_counts(c),
        xor=g.exchange_with((f.to(torch.bfloat16), c), 5), shift=g.ppermute_shift(f, 3),
        a2a=g.all_to_all(torch.arange(P * 2, dtype=torch.float32).reshape(1, P, 2) + 100 * rank),
        gather=g.gather_rows(f.to(torch.bfloat16)), any=g.any(torch.tensor([rank == 6])),
        max=g.max(torch.tensor([rank * 3, -rank], dtype=torch.int64)), min=g.min(torch.tensor([rank - 4])),
        f=f, c=c, production_refused=refused, host_mesh=(host.mesh.tolist(), GroupProcs.from_mesh(host, "procs").index))


def _main(root: str) -> None:
    from repro_torch.launch.mesh import spawn

    torch.save(spawn(_rank, P, device="cpu", args=(root,)), os.path.join(root, "ranks.pt"))


# -------------------------------------------------------------- reference
_REFERENCE = """
import sys
sys.path[:0] = [{src!r}, {tests!r}]
import numpy as np
from test_torch_harness import reference, x64
ref = reference()
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from test_torch_sharded import CASES, P, NP
data = np.load({root!r} + "/inputs.npz")
mesh = Mesh(np.array(jax.devices()[:P]), ("procs",))
out = {{}}
for i, (name, kw, _, dtype, nv) in enumerate(CASES):
    with x64(dtype == "int64"):
        x = jnp.asarray(data[f"x{{i}}"])
        if dtype == "bfloat16":
            x = x.view(jnp.bfloat16)
        vals = [jnp.asarray(data["payload"])][:nv]
        cfg = ref.SortConfig(p=P, n_per_proc=NP, **kw)
        res, pv = ref.bsp_sort_sharded(x, mesh, "procs", cfg, values=vals)
        buf = np.asarray(res.buf)
        out[f"buf{{i}}"] = buf.view(np.int16) if dtype == "bfloat16" else buf
        out[f"count{{i}}"] = np.asarray(res.count)
        out[f"overflow{{i}}"] = np.asarray(res.overflow)
        for j, v in enumerate(pv):
            out[f"val{{i}}_{{j}}"] = np.asarray(v)
np.savez({root!r} + "/reference.npz", **out)
"""


def _reference_draws(cfg_kw: dict) -> np.ndarray:
    """The (P, s) positions the reference's ``random_sample`` draws under
    ``key(seed)``, the key its ``bsp_sort_sharded`` samples with."""
    import jax

    from test_torch_harness import config_fields, reference

    ref = reference()
    from repro.core import splitters
    from repro.core.types import AXIS

    rcfg = ref.SortConfig(p=P, n_per_proc=NP, **cfg_kw)
    rng = jax.random.key(rcfg.seed)
    xs = jax.numpy.zeros((P, NP), jax.numpy.int32)
    assert config_fields(rcfg)["algorithm"] in ("iran", "ran")
    return np.array(jax.vmap(lambda r: splitters.random_sample(r, rcfg, AXIS, rng)[2], axis_name=AXIS)(xs))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sharded"))
    data = {"payload": payload()}
    for i, (_, kw, dist, dtype, _) in enumerate(CASES):
        data[f"x{i}"] = make_input(dist, dtype)
        if kw.get("algorithm") in ("iran", "ran") and kw.get("route") != "radix":
            data[f"draws{i}"] = _reference_draws(kw)
    np.savez(os.path.join(root, "inputs.npz"), **data)
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{HERE}")
    ranks = subprocess.Popen([sys.executable, str(Path(__file__)), root], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    refenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    script = textwrap.dedent(_REFERENCE.format(src=str(SRC), tests=str(HERE), root=root))
    refp = subprocess.run([sys.executable, "-c", script], env=refenv, capture_output=True, text=True,
                          timeout=TIMEOUT)
    try:
        log, _ = ranks.communicate(timeout=TIMEOUT)
    finally:
        ranks.kill()
    assert ranks.returncode == 0, f"ranks failed:\n{log[-4000:]}"
    assert refp.returncode == 0, f"reference failed:\n{refp.stderr[-4000:]}"
    return dict(data=np.load(os.path.join(root, "inputs.npz")),
                ranks=torch.load(os.path.join(root, "ranks.pt"), weights_only=False),
                ref=np.load(os.path.join(root, "reference.npz")))


def _rows(ranks, name: str, what: str):
    return [r["cases"][name][what] for r in ranks]


@pytest.mark.parametrize("i", range(len(CASES)), ids=NAMES)
def test_sharded_sort_rows_equal_bsp_sort_and_reference(runs, i, monkeypatch):
    from repro_torch.core import SortConfig, api, bsp_sort

    name, kw, _, dtype, nv = CASES[i]
    data, ranks, ref = runs["data"], runs["ranks"], runs["ref"]
    buf = torch.cat(_rows(ranks, name, "buf"))
    count = torch.cat(_rows(ranks, name, "count"))
    flags = _rows(ranks, name, "overflow")
    vals = [torch.cat([r["cases"][name]["vals"][j] for r in ranks]) for j in range(nv)]
    assert len(set(flags)) == 1, f"{name}: the ranks read different overflow flags"

    # the port's simulated processors, fed the same draws
    if f"draws{i}" in data.files:
        monkeypatch.setattr(api, "_positions", _draws_for(None, data[f"draws{i}"]))
    x = torch_keys(data[f"x{i}"], dtype)
    res, pv = bsp_sort(x, SortConfig(p=P, n_per_proc=NP, **kw), values=[torch.from_numpy(data["payload"])][:nv],
                       device="cpu")
    assert host(buf).tobytes() == host(res.buf).tobytes(), f"{name}: rows differ from bsp_sort"
    assert torch.equal(count, res.count) and flags[0] == bool(res.overflow), name
    for a, b in zip(vals, pv):
        assert torch.equal(a, b), f"{name}: payload rows differ from bsp_sort"

    # the JAX package's bsp_sort_sharded on 8 host devices
    rbuf = ref[f"buf{i}"]
    assert host(buf).dtype == rbuf.dtype and host(buf).shape == rbuf.shape, name
    assert host(buf).tobytes() == rbuf.tobytes(), f"{name}: rows differ from the reference"
    assert np.array_equal(count.numpy(), ref[f"count{i}"]), f"{name}: counts differ from the reference"
    assert flags[0] == bool(ref[f"overflow{i}"]), name
    for j, a in enumerate(vals):
        assert a.numpy().tobytes() == ref[f"val{i}_{j}"].tobytes(), f"{name}: payload differs from the reference"


@pytest.mark.parametrize("case", DRIVER_CASES)
def test_sharded_drivers_and_executor_cache(runs, case):
    from repro_torch.core import SortConfig, bsp_sort_safe, datagen
    from repro_torch.core.primitives import LocalProcs

    got = [r["drivers"][case] for r in runs["ranks"]]
    if case in ("resumes_and_caches", "resume_false", "radix_one_rung"):
        x = adversarial(NP)
        kw = dict(route="radix", pair_capacity="whp") if case == "radix_one_rung" else dict(
            algorithm="iran", pair_capacity="whp")
        res, _, st = bsp_sort_safe(torch.from_numpy(x), SortConfig(p=P, n_per_proc=NP, **kw),
                                   resume=case != "resume_false", device="cpu")
        buf, count = torch.cat([g["buf"] for g in got]), torch.cat([g["count"] for g in got])
        assert torch.equal(buf, res.buf) and torch.equal(count, res.count)
        flat = torch.cat([buf[k, :c] for k, c in enumerate(count.tolist())])
        assert np.array_equal(flat.numpy(), np.sort(x.ravel()))
        for g in got:
            assert g["row"] == st.as_row() and g["row2"] == g["row"] and g["same"]
            assert g["again"], "a second call built a sharded entry again"
            assert all(v == 1 for _, _, v in g["first"]) and all(r == "sharded" for _, r, _ in g["first"])
        stages = [s for s, _, _ in got[0]["first"]]
        if case == "radix_one_rung":
            assert st.as_row() == {"tier_radix": 1, "ok_radix": 1, "retries": 0}
        else:
            assert st.retries >= 1, st.as_row()  # escalated past whp
        if case == "resume_false":
            assert set(stages) == {"sort"} and len(stages) == st.retries + 1
        else:  # one prepare entry shared by every rung
            assert stages.count("prepare") == 1 and stages.count("route") == st.retries + 1
    elif case == "traced":
        from repro_torch.obs import Tracer

        x = torch.from_numpy(datagen.generate("G", P, NP, seed=9))
        for i, kw in enumerate(TRACED):
            tracer = Tracer()
            bsp_sort_safe(x, SortConfig(p=P, n_per_proc=NP, obs=tracer, **kw), device="cpu")
            want = [(pt["name"], pt["args"]) for pt in tracer.points if pt["name"] == "distribution"]
            assert want, kw
            for g in got:
                t = g["traced"][i]
                assert t["same"], "a traced sharded sort changed its result"
                assert t["spans"] == [sp["name"] for sp in tracer.spans], kw
                assert t["points"] == want, f"{kw}: the gathered distribution differs from one process's"
    elif case == "mesh_keyed_cache":
        for g in got:
            assert g["n_keys"] == 2 and g["meshes_distinct"] and g["built_once"] and g["hits_only"]
        for tag in ("a", "b"):
            rows = sorted((g["got"][tag] for g in got), key=lambda t: t[0])
            assert [me for me, _, _ in rows] == list(range(P))
            flat = torch.cat([b[0, :int(c[0])] for _, b, c in rows])
            assert np.array_equal(flat.numpy(), np.sort(datagen.generate("U", P, 512, seed=3).ravel())), tag
    else:
        local = LocalProcs(P)
        f = torch.cat([g["f"] for g in got])
        c = torch.cat([g["c"] for g in got])
        a2a = torch.stack([torch.arange(P * 2, dtype=torch.float32).reshape(P, 2) + 100 * r for r in range(P)])
        want = dict(proc_id=local.proc_id("cpu"), bcast=local.broadcast_from(f, 3), prefix=local.prefix_counts(c),
                    shift=local.ppermute_shift(f, 3), a2a=local.all_to_all(a2a))
        for key, w in want.items():
            assert host(torch.cat([g[key] for g in got])).tobytes() == host(w).tobytes(), key
        xf, xc = local.exchange_with((f.to(torch.bfloat16), c), 5)
        assert host(torch.cat([g["xor"][0] for g in got])).tobytes() == host(xf).tobytes()
        assert torch.equal(torch.cat([g["xor"][1] for g in got]), xc)
        for r, g in enumerate(got):
            assert g["production_refused"], "a world of 8 built the (16, 16) production mesh"
            assert g["host_mesh"] == (list(range(P)), r)
            assert host(g["gather"]).tobytes() == host(f.to(torch.bfloat16)).tobytes()
            assert bool(g["any"]) and int(g["max"]) == 3 * (P - 1) and int(g["min"]) == -4


_REHEARSAL = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
import chip_smoke as cs
import torch
import repro_torch.core as core
from repro_torch.kernels import _build as build
if __name__ == "__main__":
    spec = dict(cs.SHARD_MOE, tokens=(4, 32), widths=dict(d_model=32, d_ff=16))
    cs.phase_sharded_path(torch, core, build, device="cpu", n_p=1024, moe_spec=spec)
"""


def test_launcher_takes_the_card_unless_asked(monkeypatch):
    """``spawn`` and ``make_mesh`` with no device take the card: with none
    present they raise before any rank starts or any group is touched."""
    from repro_torch.launch.mesh import make_mesh, spawn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spawn(_rank, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh((2,), ("procs",))


def test_chip_smoke_sharded_path_rehearses_on_the_cpu():
    """``chip_smoke.py``'s ``sharded_path`` at a cut size on the host: 4 gloo
    ranks, then a world of one, every check of the phase passing (rows
    against one process's sort, tiers, the escalations, the MoE against
    the dense evaluation); the card's launch checks are skipped there."""
    script = textwrap.dedent(_REHEARSAL.format(src=str(SRC), root=str(HERE.parent)))
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith('{"phase": "sharded_path"')]
    assert len(lines) == 3 and all('"ok": true' in ln for ln in lines)


# ------------------------------------------------------------- the card
def _card_rank(rank: int, n: int, device: str) -> dict:
    """A det sort on the kernels' path and ``moe_ep`` on 2 ranks of ``device``."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.core import SortConfig, bsp_sort_sharded_safe, datagen
    from repro_torch.launch.mesh import make_mesh, mesh_device
    from repro_torch.models import moe

    mesh = make_mesh((n,), ("procs",), device)
    dev = mesh_device(mesh)
    x = torch.from_numpy(datagen.generate("U", n, 1 << 14, seed=5))
    vals = [torch.arange(x.numel(), dtype=torch.int32).reshape(x.shape)]
    cfg = SortConfig(p=n, n_per_proc=1 << 14, local_sort="bitonic", merge="tree", merge_backend="pallas")
    out = {}
    for nv in (0, 1):
        res, pv, st = bsp_sort_sharded_safe(x[rank:rank + 1].to(dev), mesh, "procs", cfg,
                                            values=[v[rank:rank + 1].to(dev) for v in vals[:nv]])
        out[nv] = (res.buf.cpu(), res.count.cpu(), [v.cpu() for v in pv], st.as_row())
    mi = moe.MoEMeshInfo(mesh=make_mesh((1, n), ("data", "model"), device), model_axis="model", data_axes=("data",))
    cfg = dataclasses.replace(get_arch("granite-moe-1b-a400m").reduced(), dtype="float32", moe_experts=8, moe_top_k=2)
    gen = torch.Generator().manual_seed(3)
    params = moe.expert_block({k: v.to(dev) for k, v in moe.init_moe(gen, cfg).items()}, mi)
    xt = moe.token_block(torch.randn((2, 64, cfg.d_model), generator=gen), mi).to(dev)
    y, aux = moe.moe_ep(params, xt, cfg, mi)
    out["moe"] = (y.cpu(), bool(aux["overflow"]))
    return out


def _card_main(root: str) -> None:
    from repro_torch.launch.mesh import spawn

    for device in ("cuda", "cpu"):
        torch.save(spawn(_card_rank, 2, device=device, args=(device,)), os.path.join(root, f"{device}.pt"))


@pytest.mark.cuda
def test_two_gloo_ranks_on_the_card_equal_the_cpu(tmp_path):
    """2 gloo ranks sharing the card: the sort's bytes and tiers equal 2 gloo
    ranks on the host's; ``moe_ep`` within 1e-4 of the largest |y|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{HERE}")
    r = subprocess.run([sys.executable, str(Path(__file__)), "--card", str(tmp_path)], env=env, capture_output=True,
                       text=True, timeout=TIMEOUT)
    assert r.returncode == 0, r.stderr[-4000:]
    card, cpu = (torch.load(tmp_path / f"{d}.pt", weights_only=False) for d in ("cuda", "cpu"))
    for a, b in zip(card, cpu):
        for nv in (0, 1):
            assert torch.equal(a[nv][0], b[nv][0]) and torch.equal(a[nv][1], b[nv][1]) and a[nv][3] == b[nv][3]
            assert all(torch.equal(u, v) for u, v in zip(a[nv][2], b[nv][2]))
        assert a["moe"][1] == b["moe"][1]
        assert float((a["moe"][0] - b["moe"][0]).abs().max()) <= 1e-4 * float(b["moe"][0].abs().max())


if __name__ == "__main__":
    if sys.argv[1] == "--card":
        _card_main(sys.argv[2])
    else:
        _main(sys.argv[1])
