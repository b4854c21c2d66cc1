"""Dry-run: trace every (arch × shape) cell's step on ``meta`` tensors, on
one device or on the production mesh, and derive its roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch whisper-tiny \
        --shape train_4k [--mesh | --multi-pod] [--out results.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh | --multi-pod]

The port of the JAX package's ``repro.launch.dryrun``. The reference
lowers and compiles each cell for a mesh of placeholder devices and reads
the compiled artifact. The port builds the model, its optimizer state and
the cell's inputs as ``meta`` tensors (shapes and dtypes, no memory: the
``meta`` device is the dry-run's by design, not a fallback), runs the
train, prefill or decode step on them under ``roofline.count_step`` and
derives the terms with ``roofline.analyze``. Without a flag the step is
one device's (cells keyed ``{arch}|{shape}|1``). ``--mesh`` and
``--multi-pod`` run it as rank 0 of the (data 16, model 16) or (pod 2,
data 16, model 16) mesh, in a world of torch's ``fake`` backend
(``launch.mesh.fake_world``): the step places its parameters, state,
batch and cache as on the real mesh, and the counts are that rank's local
products and its collectives (cells keyed ``|16x16`` and ``|2x16x16``).
A trace that fails (a step that reads a value back, or a data-dependent
shape) is a cell with ``status: error``.
It sets no environment variable and touches no device.

Per cell this records the trace's wall (``trace_s``, in place of the
reference's ``lower_s`` and ``compile_s``), the counted FLOPs and bytes
of the matrix products, the collectives' bytes, the step's input bytes
and the three terms, in seconds of an H100 SXM at its published peaks and
network rate: bounds, not times.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from typing import Dict

import torch

from ..configs import SHAPES, all_archs, get_arch
from ..configs.base import ArchConfig, ShapeConfig
from ..models import Model
from ..optim import OptConfig
from ..roofline.analysis import analyze, count_step
from ..train import init_all, make_train_step
from .mesh import fake_world, make_production_mesh
from .steps import make_decode_step, make_prefill_step, place_cache


def opt_shapes(params_shapes: Dict[str, torch.Tensor], opt_cfg: OptConfig) -> Dict:
    """The AdamW state of ``params_shapes`` as ``meta`` tensors."""
    dt = getattr(torch, opt_cfg.state_dtype)

    def z(p):
        return torch.empty(p.shape, dtype=dt, device="meta")

    return {"m": {k: z(p) for k, p in params_shapes.items()}, "v": {k: z(p) for k, p in params_shapes.items()},
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def opt_config_for(cfg) -> OptConfig:
    # >100B params: bf16 optimizer state to fit the 16 GB/chip budget
    big = cfg.param_count() > 1e11
    return OptConfig(
        state_dtype="bfloat16" if big else "float32",
        grad_accum_dtype="bfloat16" if big else "float32",
    )


def lower_cell(arch, shape, mesh=None) -> Dict:
    """Trace one cell's step on ``meta`` tensors and analyze it. ``arch`` is
    a registered name or an ``ArchConfig``, ``shape`` a name of ``SHAPES``
    or a ``ShapeConfig`` (a cell at another batch or length); ``mesh`` a
    ``DeviceMesh`` of a fake world (:func:`launch.mesh.fake_world`), or
    None for one device."""
    cfg = arch if isinstance(arch, ArchConfig) else get_arch(arch)
    shape = shape if isinstance(shape, ShapeConfig) else SHAPES[shape]
    runnable, reason = cfg.runnable(shape)
    if not runnable:
        return {"status": "skipped", "reason": reason}
    if shape.kind != "train" and cfg.param_sharding == "dp":
        # the pure-DP training policy is wrong for serving (batch ≤ 32):
        # the reference serves with TP weights. A sharding policy: on one
        # device it changes nothing
        cfg = dataclasses.replace(cfg, param_sharding="1d")

    model = Model(cfg, device="meta")
    t0 = time.perf_counter()
    if shape.kind == "train":
        ocfg = opt_config_for(cfg)
        if mesh is None:
            model.requires_grad_(True)
            params = dict(model.named_parameters())
            opt = opt_shapes(params, ocfg)
        else:
            params, opt = init_all(model, ocfg, mesh)
        step = make_train_step(model, ocfg, mesh)
        counts = count_step(step, params, opt, model.input_specs(shape))
    elif shape.kind == "prefill":
        batch = model.input_specs(shape)
        fn = make_prefill_step(model, mesh, cache_len=shape.seq_len, batch_shapes=batch)
        with torch.no_grad():
            counts = count_step(lambda params, b: fn(b), dict(model.named_parameters()), batch)
    else:  # decode
        specs = model.input_specs(shape)
        fn = make_decode_step(model, mesh, batch=shape.global_batch, cache_len=shape.seq_len)
        cache = specs["cache"] if mesh is None else place_cache(model, mesh, specs["cache"])
        with torch.no_grad():
            counts = count_step(lambda params, c, t: fn(c, t), dict(model.named_parameters()), cache,
                                specs["token"])
    t_trace = time.perf_counter() - t0

    devices = 1 if mesh is None else mesh.size()
    info = analyze(counts, cfg=cfg, shape=shape, devices=devices)
    info.update({"status": "ok", "aten_ops": counts["aten_ops"], "trace_s": round(t_trace, 2)})
    return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", action="store_true", help="rank 0 of the (data 16, model 16) mesh")
    ap.add_argument("--multi-pod", action="store_true", help="rank 0 of the (pod 2, data 16, model 16) mesh")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in all_archs() for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]
    if not (args.mesh or args.multi_pod):
        print("dry-run: one device, meta tensors; seconds are bounds at the H100 SXM's published peaks")
        return _run(cells, None, "1", args.out)
    n = 512 if args.multi_pod else 256
    with fake_world(n):
        mesh = make_production_mesh(multi_pod=args.multi_pod, device_type="cpu")
        print(f"dry-run: rank 0 of mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} in a fake world of {n}, "
              "meta tensors; seconds are bounds at the H100 SXM's published peaks and network rate")
        return _run(cells, mesh, "2x16x16" if args.multi_pod else "16x16", args.out)


def _run(cells, mesh, tag: str, out) -> int:
    results = {}
    for arch_name, shape_name in cells:
        key = f"{arch_name}|{shape_name}|{tag}"
        print(f"=== {key} ===", flush=True)
        try:
            info = lower_cell(arch_name, shape_name) if mesh is None else lower_cell(arch_name, shape_name, mesh)
        except Exception as e:  # a dry-run failure is a bug in the port
            info = {
                "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:],
            }
        results[key] = info
        for k, v in info.items():
            if k != "trace":
                print(f"  {k}: {v}")
        if out:
            with open(out, "w") as f:
                json.dump(results, f, indent=2)

    counts = {s: sum(1 for r in results.values() if r["status"] == s) for s in ("ok", "skipped")}
    n_err = len(results) - sum(counts.values())
    print(f"\n=== dry-run summary: {counts['ok']} ok, {counts['skipped']} skipped, {n_err} errors ===")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
