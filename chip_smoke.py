#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root, on a machine with the card

Phases, each printing one JSON line; any failure ends the run nonzero:

1. ``device``      — the card, its power limit, torch and CUDA versions.
2. ``build``       — builds the CUDA kernels from ``src/repro_torch/csrc``
                     with nvcc for sm_90a; seconds and the ``-Xptxas -v``
                     register / shared-memory report.
3. ``kernels``     — each kernel (K1 bitonic tile sort, K2 tagged ranks, K3
                     merge-path merge) against its plain PyTorch version at
                     the main path's shapes: outputs must be exactly equal.
                     Times by CUDA events (warmed, median of repeats) beside
                     the kernel's bound and one PyTorch library call.
4. ``small_parity``— the whole sort on the card against the plain path on
                     the CPU at p=8, n_per_proc=512: byte-identical.
5. ``main_path``   — ``bsp_sort_safe`` at the full-width configuration, the
                     paper's largest point: n = 2^23 int32 keys on p = 128
                     simulated processors, for U, DD and U with an int32
                     payload; output checked against ``torch.sort``; every
                     kernel must have launched during this phase.
6. ``ladder``      — the adversarial input (every run constant, distinct
                     per processor) at p = 128, n_per_proc = 8192 must walk
                     whp → whp2 → exact and come out sorted.
7. ``profile``     — per full-width run: prepare and per-rung route times by
                     CUDA events; the device's busy share and its top
                     operations under ``torch.profiler``.

Then the card's ``nvidia-smi`` name and power limit, one ``{"kernels": ...}``
summary line, and as the last line ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the repository beside it, the script
exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

#: H100 SXM published peaks: HBM bandwidth, and the 32-bit non-tensor rate
#: used for the kernels' integer/float compare operations.
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12

FULL = dict(p=128, n_per_proc=65536)
SLICE = dict(
    algorithm="det", local_sort="bitonic", merge="tree", merge_backend="pallas",
    pair_capacity="whp",
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(phase: str, msg: str) -> None:
    raise SystemExit(f"chip_smoke: phase {phase} failed: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail("device", f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def time_ms(torch, fn, target_ms: float = 300.0, max_reps: int = 20) -> float:
    """Median CUDA-event time of ``fn`` in ms, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    reps = 1
    while len(times) < reps:
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        if len(times) == 1:
            reps = max(3, min(max_reps, int(target_ms / max(times[0], 1e-3))))
    return statistics.median(times)


def bound(bytes_moved: float, ops: float) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(torch, got, want, phase: str, what: str) -> float:
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(phase, f"{what}: {tuple(got.shape)}/{got.dtype} vs {tuple(want.shape)}/{want.dtype}")
    diff = torch.where(got == want, 0.0, got.double() - want.double())
    err = diff.abs().max().item() if got.numel() else 0.0
    if not torch.equal(got, want):
        fail(phase, f"{what}: kernel differs from its plain version (max abs err {err})")
    return err


def sorted_rows(torch, rows, width, dtype, gen, sentinel_tails):
    x = torch.randint(0, 2**30, (rows, width), device="cuda", generator=gen)
    x = torch.sort(x.to(dtype), dim=-1).values
    if sentinel_tails:
        lens = torch.randint(0, width + 1, (rows, 1), device="cuda", generator=gen)
        sent = torch.iinfo(dtype).max if not dtype.is_floating_point else float("inf")
        x = torch.where(torch.arange(width, device="cuda") < lens, x, sent)
    return x.contiguous()


# ------------------------------------------------------------------ phases
def phase_kernels(torch, mods):
    bops, bref, sops, sref, mops, mref = mods
    gen = torch.Generator(device="cuda").manual_seed(0)
    details, entries = [], {}
    int_max = torch.iinfo(torch.int32).max

    # K1 — the main path's tiles: 128 runs x 4 tiles of 16384, and whole runs
    errs = []
    for dtype in (torch.int32, torch.float32):
        x = torch.randint(-(2**30), 2**30, (512, 16384), device="cuda", generator=gen).to(dtype)
        x[:3, :100] = int_max if dtype == torch.int32 else float("inf")
        errs.append(max_abs_err(torch, bops.sort_tiles(x), bref.sort_tiles(x), "kernels", f"K1 {dtype}"))
        xm = torch.randint(-(2**30), 2**30, (128, 65536), device="cuda", generator=gen).to(dtype)
        errs.append(max_abs_err(torch, bops.sort(xm), torch.sort(xm, dim=-1).values, "kernels", f"K1 multi-tile {dtype}"))
        ms = time_ms(torch, lambda: bops.sort_tiles(x))
        rows, w = x.shape
        lg = int(math.log2(w))
        b_ms, b_by = bound(2 * x.numel() * 4, rows * (w // 2) * lg * (lg + 1) // 2)
        d = dict(kernel="K1", dtype=str(dtype), shape=[rows, w], ms=ms, bound_ms=b_ms,
                 plain_ms=time_ms(torch, lambda: bref.sort_tiles(x)),
                 library_ms=time_ms(torch, lambda: torch.sort(x, dim=-1)),
                 multi_tile_ms=time_ms(torch, lambda: bops.sort(xm)),
                 multi_tile_shape=list(xm.shape))
        details.append(d)
        if dtype == torch.int32:
            entries["K1"] = dict(ms=ms, plain_ms=d["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                                 library_ms=d["library_ms"])
    entries["K1"]["max_abs_err"] = max(errs)

    # K2 — rank-merge ranks: round 1 (8192 rows of 1256) and the last round
    # (rows of 79008); both sides; sentinel-valued queries and tails
    errs = []
    for rows, n, s, plain_rows in ((8192, 1256, 2512, 8192), (128, 79008, 79008, 8)):
        data = sorted_rows(torch, rows, n, torch.int32, gen, True)
        q = torch.randint(0, 2**30, (rows, s), device="cuda", generator=gen).int()
        q[:, :8] = int_max
        for side in ("left", "right"):
            got = sops.rank_in(data, q, side=side)
            dp, qp = data[:plain_rows].contiguous(), q[:plain_rows].contiguous()
            tag = torch.full_like(qp, 1 if side == "right" else -1)
            zeros_q = torch.zeros_like(qp)
            me = torch.zeros(plain_rows, dtype=torch.int32, device="cuda")
            want = sref.ranks(dp, qp, tag, zeros_q, me)
            errs.append(max_abs_err(torch, got[:plain_rows], want, "kernels", f"K2 {rows}x{n} {side}"))
            lib = torch.searchsorted(data, q, side=side, out_int32=True)
            if not torch.equal(lib, got):
                fail("kernels", f"K2 {rows}x{n} {side}: differs from torch.searchsorted")
        ms = time_ms(torch, lambda: sops.rank_in(data, q, side="right"))
        b_ms, b_by = bound((data.numel() + 2 * q.numel()) * 4,
                           q.numel() * math.ceil(math.log2(n + 1)))
        d = dict(kernel="K2", shape=[rows, n], queries=s, ms=ms, bound_ms=b_ms,
                 plain_rows=plain_rows,
                 plain_ms=time_ms(torch, lambda: sref.ranks(dp, qp, tag, zeros_q, me), target_ms=1),
                 library_ms=time_ms(torch, lambda: torch.searchsorted(data, q, side="right", out_int32=True)))
        details.append(d)
        if n == 1256:
            entries["K2"] = dict(ms=ms, plain_ms=d["plain_ms"] * rows / plain_rows,
                                 bound_ms=b_ms, bound_by=b_by, library_ms=d["library_ms"])
    entries["K2"]["max_abs_err"] = max(errs)

    # K3 — key-only merge rounds: whp rounds 1-2, exact round 1 (clipped to n_max)
    errs = []
    for rows, w, out_w, plain_rows in ((8192, 1256, 2512, 8192), (4096, 2512, 5024, 4096),
                                       (8192, 65536, 79008, 64)):
        a = sorted_rows(torch, rows, w, torch.int32, gen, True)
        b = sorted_rows(torch, rows, w, torch.int32, gen, True)
        got = mops.merge_partitioned(a, b, width=out_w)
        tile = min(mops.TILE, mops._pow2_at_least(w))
        ap, bp = a[:plain_rows].contiguous(), b[:plain_rows].contiguous()
        want = mref.merge_windows(ap, bp, tile, out_w)
        errs.append(max_abs_err(torch, got[:plain_rows], want, "kernels", f"K3 {rows}x{w}"))
        ms = time_ms(torch, lambda: mops.merge_partitioned(a, b, width=out_w))
        spans = -(-out_w // tile)
        lg = int(math.log2(tile))
        b_ms, b_by = bound((2 * a.numel() + rows * out_w) * 4, rows * spans * 2 * tile * lg)
        d = dict(kernel="K3", shape=[rows, w], out_width=out_w, ms=ms, bound_ms=b_ms,
                 plain_rows=plain_rows,
                 plain_ms=time_ms(torch, lambda: mref.merge_windows(ap, bp, tile, out_w), target_ms=1),
                 library_ms=time_ms(torch, lambda: torch.sort(torch.cat([a, b], dim=-1), dim=-1)))
        details.append(d)
        if w == 1256:
            entries["K3"] = dict(ms=ms, plain_ms=d["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                                 library_ms=d["library_ms"])
    entries["K3"]["max_abs_err"] = max(errs)
    emit({"phase": "kernels", "ok": True, "details": details})
    return entries


def check_sort(torch, core, x, vals, res, pvals, stats, phase, what):
    out = core.gathered_output(res)
    if not torch.equal(out, torch.sort(x.flatten()).values):
        fail(phase, f"{what}: output is not the sorted input")
    if vals:
        order = torch.sort(x.flatten(), stable=True).indices
        counts = res.count.tolist()
        got = torch.cat([pvals[0][k, :c] for k, c in enumerate(counts)])
        if not torch.equal(got, vals[0].flatten()[order]):
            fail(phase, f"{what}: payload is not the stable-argsort gather")
    row = stats.as_row()
    walked = [k[len("tier_"):] for k in row if k.startswith("tier_")]
    if not walked or walked[-1] != stats.last_tier or row["retries"] != len(walked) - 1:
        fail(phase, f"{what}: inconsistent tiers {row}")
    return walked


def phase_small_parity(torch, core):
    for dist, nv in (("U", 1), ("DD", 0), ("adversarial", 1)):
        x = adversarial(8, 512) if dist == "adversarial" else core.datagen.generate(dist, 8, 512)
        vals = [torch.arange(8 * 512, dtype=torch.int32).reshape(8, 512)][:nv]
        cfg = core.SortConfig(p=8, n_per_proc=512, **SLICE)
        gres, gvals, gst = core.bsp_sort_safe(x, cfg, values=[v.cuda() for v in vals])
        cres, cvals, cst = core.bsp_sort_safe(x, cfg, values=vals, device="cpu")
        same = (torch.equal(gres.buf.cpu(), cres.buf) and torch.equal(gres.count.cpu(), cres.count)
                and bool(gres.overflow) == bool(cres.overflow) and gst.as_row() == cst.as_row()
                and all(torch.equal(g.cpu(), c) for g, c in zip(gvals, cvals)))
        if not same:
            fail("small_parity", f"{dist}: card and CPU results differ")
    emit({"phase": "small_parity", "ok": True, "cases": ["U+payload", "DD", "adversarial+payload"]})


def run_sort(torch, core, x, vals, cfg):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, pvals, stats = core.bsp_sort_safe(x, cfg, values=vals)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, res, pvals, stats


def phase_main_path(torch, core, build):
    cfg = core.SortConfig(**FULL, **SLICE)
    n = cfg.n
    runs = []
    build.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    for dist, nv in (("U", 0), ("DD", 0), ("U", 1)):
        x = torch.from_numpy(core.datagen.generate(dist, cfg.p, cfg.n_per_proc)).cuda()
        vals = [torch.arange(n, dtype=torch.int32, device="cuda").reshape(cfg.p, cfg.n_per_proc)][:nv]
        walls = []
        for _ in range(2):  # first call, then a warm one
            wall, res, pvals, stats = run_sort(torch, core, x, vals, cfg)
            walls.append(wall)
            walked = check_sort(torch, core, x, vals, res, pvals, stats, "main_path",
                                f"{dist}{'+payload' if nv else ''}")
        runs.append(dict(dist=dist, payload=bool(nv), tiers=walked, wall_s=walls,
                         keys_per_s=n / walls[-1]))
    launches = build.counts()
    for name in ("bitonic_sort_tiles", "splitter_ranks", "merge_sorted_tiles"):
        if launches.get(name, 0) <= 0:
            fail("main_path", f"kernel {name} was not launched on the main path")
    emit({"phase": "main_path", "ok": True, "config": dict(**FULL, **SLICE),
          "n": n, "s": cfg.s, "pair_cap": cfg.pair_cap, "n_max": cfg.n_max, "runs": runs,
          "launches": launches, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    return launches


def adversarial(p, n_p):
    import numpy as np

    return np.repeat((np.arange(p, dtype=np.int32) * 1000)[:, None], n_p, axis=1)


def phase_ladder(torch, core):
    cfg = core.SortConfig(p=128, n_per_proc=8192, **SLICE)
    x = torch.from_numpy(adversarial(cfg.p, cfg.n_per_proc)).cuda()
    wall, res, pvals, stats = run_sort(torch, core, x, [], cfg)
    walked = check_sort(torch, core, x, [], res, pvals, stats, "ladder", "adversarial")
    if walked != ["whp", "whp2", "exact"]:
        fail("ladder", f"walked {walked}, expected whp -> whp2 -> exact")
    emit({"phase": "ladder", "ok": True, "tiers": walked, "wall_s": wall, "row": stats.as_row()})


def phase_profile(torch, core):
    """Where the main path's time goes: stage times by CUDA events, and the
    device's busy share and top operations under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.sort_det import prepare_det_spmd, route_det_spmd

    cfg = core.SortConfig(**FULL, **SLICE)
    cells = []
    for dist, nv in (("U", 0), ("DD", 0), ("U", 1)):
        x = torch.from_numpy(core.datagen.generate(dist, cfg.p, cfg.n_per_proc)).cuda()
        vals = [torch.arange(cfg.n, dtype=torch.int32, device="cuda").reshape(x.shape)][:nv]
        stages = {"prepare": time_ms(torch, lambda: prepare_det_spmd(x, cfg, vals), target_ms=50)}
        prep = prepare_det_spmd(x, cfg, vals)
        for tier, tier_cfg in cfg.tier_ladder()[:-1]:
            stages[f"route_{tier}"] = time_ms(torch, lambda: route_det_spmd(prep, tier_cfg), target_ms=50)
        wall_ms = run_sort(torch, core, x, vals, cfg)[0] * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            core.bsp_sort_safe(x, cfg, values=vals)
            torch.cuda.synchronize()
            profiled_ms = (time.perf_counter() - t0) * 1e3
        rows = []
        for ev in prof.key_averages():
            # device-side events only: a host op repeats its kernels' time
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0)
            if dev_us > 0:
                rows.append((dev_us / 1e3, ev.key, ev.count))
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        # idle share against the unprofiled wall: the profiler slows the host
        cells.append(dict(dist=dist, payload=bool(nv), stage_ms=stages, wall_ms=wall_ms,
                          profiled_wall_ms=profiled_ms, device_busy_ms=busy,
                          idle_share=max(0.0, 1 - busy / wall_ms),
                          top=[dict(op=k[:80], ms=ms, calls=c) for ms, k, c in rows[:8]]))
    emit({"phase": "profile", "ok": True, "cells": cells})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch.core as core
    from repro_torch.kernels import _build as build
    from repro_torch.kernels.bitonic import ops as bops, ref as bref
    from repro_torch.kernels.merge_path import ops as mops, ref as mref
    from repro_torch.kernels.searchsorted import ops as sops, ref as sref

    smi = nvidia_smi()
    emit({"phase": "device", "ok": True, "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    build.load()
    ptxas = [ln.strip() for ln in build.build_log().splitlines()
             if "registers" in ln or "Compiling entry" in ln or ln.startswith("==")]
    emit({"phase": "build", "ok": True, "seconds": time.perf_counter() - t0, "ptxas": ptxas})

    entries = phase_kernels(torch, (bops, bref, sops, sref, mops, mref))
    phase_small_parity(torch, core)
    launches = phase_main_path(torch, core, build)
    phase_ladder(torch, core)
    phase_profile(torch, core)

    meta = {
        "K1": ("bitonic_sort_tiles", "src/repro_torch/csrc/bitonic_sort.cu",
               "src/repro/kernels/bitonic/kernel.py:102"),
        "K2": ("splitter_ranks", "src/repro_torch/csrc/splitter_ranks.cu",
               "src/repro/kernels/searchsorted/kernel.py:47"),
        "K3": ("merge_sorted_tiles", "src/repro_torch/csrc/merge_path.cu",
               "src/repro/kernels/merge_path/kernel.py:39"),
    }
    kernels = []
    for key, (name, source, replaces) in meta.items():
        e = entries[key]
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=launches[name], max_abs_err=e["max_abs_err"], ms=e["ms"],
                            plain_ms=e["plain_ms"], bound_ms=e["bound_ms"], bound_by=e["bound_by"],
                            library_ms=e["library_ms"]))
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
