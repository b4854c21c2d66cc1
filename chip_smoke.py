#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py    # from the repository root, on a machine with the card

Phases, each printing one JSON line; any failure ends the run nonzero:

1. ``device``      — the card, its power limit, torch and CUDA versions.
2. ``build``       — builds the CUDA kernels from ``src/repro_torch/csrc``
                     with nvcc for sm_90a; seconds and the ``-Xptxas -v``
                     report: registers, spilled bytes and static shared
                     memory of every kernel.
3. ``kernels``     — each kernel against its plain PyTorch version, bit for
                     bit: K1 bitonic tile sort at every tile width 128 ..
                     16384 for int32, float32, uint32 and bfloat16 keys
                     (float rows with ±0.0 and NaN); K4 key-value tile sort
                     for 2-, 4- and 8-byte values under every key dtype with
                     heavy ties, at widths 128, 512, 1024 and 16384; K2
                     tagged ranks; K3 merge-path merge, also on float
                     windows with ±0.0 and NaN; K2 and K3 on int64 rows
                     (extremes, sentinel tails, broadcast and unsorted
                     query rows, clipped widths), and K2 int64 on the delta
                     fold's one long row (2^23 against 2^16); K3's float
                     route at the merge tail's whp round 1 and exact round
                     on NaN-free rows, rows with a ±0.0 band (merge route)
                     and rows with NaNs (network route), each with the
                     count of reference spans the network merged;
                     at the paths' shapes.
                     Times by CUDA events (warmed, median of repeats) and
                     profiler device time, beside the kernel's bound, its
                     plain version's time (on every row, or on the
                     ``plain_rows`` a row names; never scaled) and one
                     PyTorch library call (events and device time).
4. ``small_parity``— whole sorts on the card against the plain path on the
                     CPU at p=8, n_per_proc=512, byte-identical: det, iran,
                     ran, [BSI], the bitonic sample sort, float keys with
                     ±0.0 and NaN, uint32 and bfloat16 keys (NaNs too,
                     non-canonical ones included),
                     [DSR], [RSR], ``route="radix"`` (int64 and float keys
                     included), the ring under both exchange modes, and the
                     segmented sort (keys, orders and tiers).
5. ``main_path``   — SORT_DET_BSP through ``bsp_sort_safe`` at the
                     full-width configuration, the paper's largest point:
                     n = 2^23 int32 keys on p = 128 simulated processors,
                     for U, DD and U with an int32 payload; output checked
                     against ``torch.sort``; K1, K2 and K3 must launch.
6. ``ladder``      — the adversarial input (every run constant, distinct
                     per processor) at p = 128, n_per_proc = 8192 must walk
                     whp → whp2 → exact and come out sorted.
7. ``iran_path``   — SORT_IRAN_BSP, the paper's randomized sort, at the same
                     full width for U, DD and U with a payload (K1, K2 and
                     K3 must launch); then once each SORT_RAN_BSP, [BSI]
                     (28 compare-split supersteps) and SORT_DET_BSP with
                     bfloat16 keys (K1 must launch on them) and uint32 keys.
8. ``sort_kv_path``— the key-value tile sort ``kernels.bitonic.ops.sort_kv``
                     as a caller would use it, rows of 16384: K4 must launch.
9. ``radix_path``  — at the same full width: the paper's [DSR] and [RSR]
                     (``local_sort="radix"``) on U, key-only (K3 must
                     launch) and [DSR] with a payload (K2 must launch); then
                     ``route="radix"`` on each mix of the reference's radix
                     benchmark (dense_int, expert_id, U, zipf_skew, U64 as
                     int64): one "radix" rung, no retry, and U64 must launch
                     the int64 K3.
10. ``ring_path``  — SORT_DET_BSP with ``routing="ring"`` (127 rotations)
                     under both exchange modes, and with a payload.
10a. ``float_path``— SORT_DET_BSP on float32 keys at the same full width on
                     the kernels' tree merge: U cast to float32, and the
                     same keys with one in 16 replaced by -0.0 or +0.0
                     (values and the count of -0.0 keys checked); K3's
                     float route must launch.
11. ``segmented_path`` — 256 ragged int32 requests (one of a single key, one
                     of over 2^20; 2^23 keys in all) fused into one int64
                     composite sort at p = 128, striped and contiguous under
                     the default config, and striped under the tree merge on
                     the kernels (the int64 K2 must launch); every segment's
                     keys and stable argsort checked.
12. ``obs_path``   — phase 5's det U configuration traced
                     (``SortConfig(obs=Tracer())``) and untraced: equal bits
                     out; the route spans' h_words, recv_max and imbalance,
                     a (g, L) fit over the DD ladder's three rungs, and the
                     traced and untraced warm walls.
13. ``planner_path``— phase 11's 256 request sizes with the keys of each of
                     the planner table's mixes (U, G, B, DD, zipf), each
                     twice through one ``CapacityPlanner``: fingerprint,
                     plan, pack with the plan's layout, the segmented sort
                     with the plan's overrides on the kernels' tree merge,
                     record; then one single-segment batch of 2^23 int32
                     keys under ``local_sort="bitonic"``, segmented and
                     key-only through ``bsp_sort_safe(planner=...)``.
                     Every segment checked; the int64 K2 must launch on
                     the fused batches, K1 on the key-only single batch.
14. ``delta_path`` — a ``SortedView`` of 2^23 int32 keys and a payload on
                     the kernels folds Δ = 2^16 and Δ = 2^20 (K2 must
                     launch); ``near_sorted_sort`` of a 2^23 stream with 1%
                     of its keys displaced equals a cold ``bsp_sort_safe``
                     of it (the int64 K2 must launch); K2's device time in
                     each fold.
15. ``profile``    — per full-width run of phases 5 and 7: prepare and
                     per-rung route times by CUDA events, the median wall of
                     five warm sorts; the device's busy share and its top
                     operations under ``torch.profiler``. Phases 9–14 give the
                     same wall, busy and idle numbers per run, with its peak
                     memory, on their own lines.

Then the card's ``nvidia-smi`` name and power limit, one ``{"kernels": ...}``
summary line (``launches``: each kernel's launches over the path phases 5,
7, 8, 9, 10, 10a, 11, 12, 13 and 14, each counted from zero just before the
phase's checked runs and read just after; the int64 routes of K2 and K3
and K3's float route are listed and counted on their own),
and as the last line ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the repository beside it, the script exits nonzero and
prints no result.
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
KEYS = FULL["p"] * FULL["n_per_proc"]  # 2^23: the planner and delta paths' batch
SLICE = dict(
    algorithm="det", local_sort="bitonic", merge="tree", merge_backend="pallas",
    pair_capacity="whp",
)
IRAN = dict(SLICE, algorithm="iran")
RADIX = dict(route="radix", local_sort="bitonic", merge="tree", merge_backend="pallas",
             pair_capacity="exact")
RADIX_MIXES = ("dense_int", "expert_id", "U", "zipf_skew", "U64")
INT_MIN = -(2**31)
I64_MIN, I64_MAX = -(2**63), 2**63 - 1


def key_dtypes(torch):
    return (torch.int32, torch.float32, torch.uint32, torch.bfloat16)


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


def ptxas_report(log: str) -> list:
    """One line per kernel of the ``-Xptxas -v`` report: source, kernel
    (demangled where ``c++filt`` is found), registers, spill stores and
    loads in bytes, static shared memory."""
    import re
    import shutil

    rows, src, cur = [], "", None
    for ln in log.splitlines():
        if ln.startswith("== "):
            src = ln[3:].strip()
        elif "Compiling entry function" in ln:
            cur = dict(source=src, kernel=ln.split("'")[1], spill_stores=0, spill_loads=0)
            rows.append(cur)
        elif cur is not None and "spill stores" in ln:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            cur.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif cur is not None and "Used" in ln and "registers" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            cur["static_smem"] = int(m.group(1)) if m else 0
    if shutil.which("c++filt") and rows:
        out = subprocess.run(["c++filt"], input="\n".join(r["kernel"] for r in rows),
                             capture_output=True, text=True, timeout=60).stdout.splitlines()
        if len(out) == len(rows):
            for r, name in zip(rows, out):
                name = re.sub(r"\(anonymous namespace\)::|^void ", "", name)
                r["kernel"] = name.split("(")[0]
    return [f"{r['source']} {r['kernel']}: {r.get('registers')} registers, "
            f"{r['spill_stores']}/{r['spill_loads']} B spilled/reloaded, "
            f"{r.get('static_smem', 0)} B static smem" for r in rows]


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


def bits(torch, t):
    """The tensor's bits as an integer tensor of the same width."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def neg_zeros(torch, t) -> int:
    """How many keys of a float tensor are -0.0, by their bits."""
    return int((bits(torch, t) == bits(torch, torch.tensor(-0.0, dtype=t.dtype, device=t.device))).sum())


def max_abs_err(torch, got, want, phase: str, what: str) -> float:
    """0.0 if ``got`` equals ``want`` bit for bit; otherwise the run fails.

    Bits, not values: NaN must meet NaN and -0.0 must meet -0.0."""
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(phase, f"{what}: {tuple(got.shape)}/{got.dtype} vs {tuple(want.shape)}/{want.dtype}")
    if not torch.equal(bits(torch, got.contiguous()), bits(torch, want.contiguous())):
        fail(phase, f"{what}: kernel differs from its plain version in its bits")
    return 0.0


def sorted_rows(torch, rows, width, dtype, gen, sentinel_tails):
    x = torch.randint(0, 2**30, (rows, width), device="cuda", generator=gen)
    x = torch.sort(x.to(dtype), dim=-1).values
    if sentinel_tails:
        lens = torch.randint(0, width + 1, (rows, 1), device="cuda", generator=gen)
        sent = torch.iinfo(dtype).max if not dtype.is_floating_point else float("inf")
        x = torch.where(torch.arange(width, device="cuda") < lens, x, sent)
    return x.contiguous()


def path_runs(torch, rows, width, gen, mean=512):
    """Sorted int32 (rows, width) runs as the merge tree's first round gets
    them at full width: about n_per_proc / p = 512 valid keys a run, then
    the sentinel. Returns (runs, valid counts)."""
    counts = torch.randint(mean - 64, mean + 65, (rows,), device="cuda", generator=gen).int()
    x = torch.randint(0, 2**31 - 1, (rows, width), device="cuda", generator=gen).int()
    x = torch.where(torch.arange(width, device="cuda") < counts[:, None], x, torch.iinfo(torch.int32).max)
    return torch.sort(x, dim=-1).values.contiguous(), counts


def device_split(torch, prof, reps: int = 1) -> dict:
    """{op: (device ms per rep, calls)} of a profiler run: device-side events
    only, since a host op repeats its kernels' time."""
    split = {}
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            split[ev.key] = (us / 1e3 / reps, ev.count)
    return split


def timed(torch, fn, reps: int = 10, **kw) -> dict:
    """CUDA-event ms of ``fn`` (wrapper, allocations and launches included)
    beside its device-only ms under ``torch.profiler``, the split of that by
    kernel, and the host's ms per call (the wrapper's Python and launches,
    timed without waiting for the device)."""
    from torch.profiler import ProfilerActivity, profile

    ms = time_ms(torch, fn, **kw)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {k[:60]: v[0] for k, v in device_split(torch, prof, reps).items()}
    return dict(ms=ms, device_ms=sum(split.values()), host_ms=host_ms, device_split=split)


def library_timed(torch, fn) -> dict:
    """``timed`` of a library call, or Nones where PyTorch lacks it for the dtype."""
    try:
        return timed(torch, fn)
    except (NotImplementedError, RuntimeError):
        return dict(ms=None, device_ms=None, host_ms=None, device_split={})


def rank_in_plain(torch, sref, data, q, side, rows):
    """K2's plain version on the first ``rows`` rows, as ``rank_in`` calls it."""
    qq = q[:rows]
    tag = torch.full(qq.shape, 1 if side == "right" else -1, dtype=torch.int32, device="cuda")
    zeros = torch.zeros(qq.shape, dtype=torch.int32, device="cuda")
    return sref.ranks(data[:rows], qq, tag, zeros, torch.zeros(rows, dtype=torch.int32, device="cuda"))


# ------------------------------------------------------------------ phases
def phase_kernels(torch, mods):
    bops, bref, sops, sref, mops, mref = mods
    gen = torch.Generator(device="cuda").manual_seed(0)
    details, entries = [], {}
    entries["K1"] = kernels_k1(torch, bops, bref, gen, details)
    entries["K4"] = kernels_k4(torch, bops, bref, gen, details)
    entries["K2"] = kernels_k2(torch, sops, sref, gen, details)
    entries["K3"] = kernels_k3(torch, mops, mref, gen, details)
    entries["K2_int64"] = kernels_k2_int64(torch, sops, sref, gen, details)
    entries["K3_int64"] = kernels_k3_int64(torch, mops, mref, gen, details)
    entries["K3_float"] = kernels_k3_float(torch, mops, mref, gen, details)
    # the int64 rows cache tens of GiB of blocks in the allocator; hand them
    # back, or the path phases' first allocations pay for freeing them
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "ok": True, "details": details})
    return entries


def int64_runs(torch, rows, width, gen, valid=None):
    """Sorted int64 (rows, width) runs over the whole range, the extremes
    and ties included, then the sentinel: ``valid`` keys a run (about;
    default a random count in [0, width])."""
    x = torch.randint(-(2**62), 2**62, (rows, width), device="cuda", generator=gen) * 2
    x[0, :3] = I64_MIN
    x[-1, -2:] = I64_MAX
    x[:, 5:9] = x[:, 4:5]
    if valid is None:
        keep = torch.randint(0, width + 1, (rows, 1), device="cuda", generator=gen)
    else:
        keep = torch.randint(valid - 64, valid + 65, (rows, 1), device="cuda", generator=gen)
    x = torch.where(torch.arange(width, device="cuda") < keep, x, I64_MAX)
    return torch.sort(x, dim=-1).values.contiguous()


def kernels_k2_int64(torch, sops, sref, gen, details):
    """K2 on int64 keys (the segmented sort's composites): the merge tail's
    two round-1 calls at the whp shape and at the exact tier's (the
    segmented sort's default), and each route's edges — unsorted queries,
    the broadcast query row (stride 0), rows of 79 008, tagged splitters,
    the int64 extremes, sentinel tails."""
    errs = []

    def check(got, data, q, side, rows, what):
        errs.append(max_abs_err(torch, got[:rows], rank_in_plain(torch, sref, data, q, side, rows),
                                "kernels", f"K2 int64 {what} {side}"))

    summary = None
    for rows, w, plain_rows in ((8192, 1256, 8192), (8192, 65536, 2)):
        ka = int64_runs(torch, rows, w, gen, valid=512)
        kb = int64_runs(torch, rows, w, gen, valid=512)
        cb = (kb != I64_MAX).sum(dim=1).int()
        ca = (ka != I64_MAX).sum(dim=1).int()
        ra = torch.minimum(sops.rank_in(kb, ka, side="left"), cb[:, None])
        ia = torch.arange(w, dtype=torch.int32, device="cuda")
        pos_a = torch.where(ia < ca[:, None], ia + ra, 2 * w + ia).contiguous()
        o = torch.arange(2 * w, dtype=torch.int32, device="cuda").expand(rows, 2 * w)
        for what, data, q, side in ((f"call 1 {rows}x{w}: ka in kb", kb, ka, "left"),
                                    (f"call 2 {rows}x{w}: arange(2w) in pos_a (int32)", pos_a, o, "right")):
            got = sops.rank_in(data, q, side=side)
            check(got, data, q, side, min(plain_rows, 64), what)
            if data.dtype != torch.int64:
                continue
            B, n = data.shape
            S = q.shape[1]
            b_ms, b_by = bound(B * n * 8 + B * S * 8 + B * S * 4, B * (n + S))
            lib = library_timed(torch, lambda: torch.searchsorted(data, q, side=side, out_int32=True))
            d = dict(kernel="K2 int64", call=what, side=side, shape=[B, n], queries=S,
                     **timed(torch, lambda: sops.rank_in(data, q, side=side)), bound_ms=b_ms, bound_by=b_by,
                     plain_ms=time_ms(torch, lambda: rank_in_plain(torch, sref, data, q, side, plain_rows),
                                      target_ms=1),
                     plain_rows=plain_rows, library_ms=lib["ms"], library_device_ms=lib["device_ms"])
            details.append(d)
            summary = summary or d
    # unsorted queries, long rows, the int64 extremes as queries
    for rows, n, s in ((1024, 1256, 2512), (4, 79008, 79008)):
        data = int64_runs(torch, rows, n, gen)
        q = int64_runs(torch, rows, s, gen)
        q_rand = q[:, torch.randperm(s, device="cuda", generator=gen)].contiguous()
        q_rand[:, :2] = torch.tensor([I64_MIN, I64_MAX], device="cuda")
        for kind, qq in (("sorted", q), ("random", q_rand)):
            for side in ("left", "right"):
                got = sops.rank_in(data, qq, side=side)
                check(got, data, qq, side, 4, f"{rows}x{n} {kind} queries")
                if not torch.equal(got, torch.searchsorted(data, qq, side=side, out_int32=True)):
                    fail("kernels", f"K2 int64 {rows}x{n} {kind} {side}: differs from torch.searchsorted")
    # tagged splitters on int64 keys with ties
    x = int64_runs(torch, 1024, 1256, gen, valid=1256)
    keys = x.gather(1, torch.randint(0, 1256, (1024, 300), device="cuda", generator=gen))
    procs = torch.randint(0, 128, (1024, 300), device="cuda", generator=gen).int()
    idx = torch.randint(0, 1256, (1024, 300), device="cuda", generator=gen).int()
    me = torch.randint(0, 128, (1024,), device="cuda", generator=gen).int()
    errs.append(max_abs_err(torch, sops.splitter_ranks(x, keys, procs, idx, me), sref.ranks(x, keys, procs, idx, me),
                            "kernels", "K2 int64 tagged"))
    errs += kernels_k2_delta_row(torch, sops, sref, gen, details)
    return dict(ms=summary["ms"], plain_ms=summary["plain_ms"], bound_ms=summary["bound_ms"],
                bound_by=summary["bound_by"], library_ms=summary["library_ms"], max_abs_err=max(errs))


def kernels_k2_delta_row(torch, sops, sref, gen, details):
    """K2 int64 at the delta fold's shape: ONE row, a sorted run of 2^23
    fold composites against 2^16 sorted queries, and the fold's own call 1
    (the 2^23-wide kept run ranked in a Δ run of 2^16). Both sides in
    order, so the row must take the merge path, cut into 4096-item tiles.
    The plain version (the masked count) runs on the first 64 queries. The
    long run's bound counts the sectors its 2^16 queries' searches need, not
    the whole run, as ``torch.searchsorted`` shows it can."""
    errs = []
    big = int64_runs(torch, 1, 1 << 23, gen, valid=(1 << 23) - 64)
    small = int64_runs(torch, 1, 1 << 16, gen, valid=(1 << 16) - 64)
    for what, data, q in (("one row of 2^23 against 2^16 queries", big, small),
                          ("fold call 1: 2^23 queries in a run of 2^16", small, big)):
        got = sops.rank_in(data, q, side="left")
        qq = q[:, :64].contiguous()
        errs.append(max_abs_err(torch, got[:, :64], rank_in_plain(torch, sref, data, qq, "left", 1),
                                "kernels", f"K2 int64 delta {what}"))
        if not torch.equal(got, torch.searchsorted(data, q, side="left", out_int32=True)):
            fail("kernels", f"K2 int64 delta {what}: differs from torch.searchsorted")
        n, S = data.shape[1], q.shape[1]
        # queries read and ranks written once; of the run, what ranking needs:
        # for S < n sorted queries, a search of ⌈lg(n/S)⌉ steps between
        # neighbouring ranks, one 32-byte sector a step (capped at the run)
        steps = math.ceil(math.log2(n / S)) if S < n else 0
        run_bytes = min(n * 8, S * steps * 32) if S < n else n * 8
        b_ms, b_by = bound(run_bytes + S * 8 + S * 4, S * steps if S < n else n + S)
        lib = library_timed(torch, lambda: torch.searchsorted(data, q, side="left", out_int32=True))
        details.append(dict(kernel="K2 int64", call=f"delta {what}", side="left", shape=[1, n], queries=S,
                            **timed(torch, lambda: sops.rank_in(data, q, side="left")), bound_ms=b_ms,
                            bound_by=b_by,
                            plain_ms=time_ms(torch, lambda: rank_in_plain(torch, sref, data, qq, "left", 1),
                                             target_ms=1),
                            plain_queries=64, library_ms=lib["ms"], library_device_ms=lib["device_ms"]))
    return errs


def k3_float_rows(torch, kind, dtype, rows, w, gen):
    """Sorted float (rows, w) row pairs for K3's float route, with +inf
    tails as the merge tail pads them: ``NaN-free``; ``±0 band``, keys of
    both signs with one in 16 replaced by -0.0 or +0.0 before sorting, so
    every row holds a band of mixed zeros mid-row; ``NaN``, the NaN-free
    rows with one key in 64 replaced by a NaN of either sign in place (out
    of order, as the bitonic tile sort can leave a run)."""
    int_max = float(torch.iinfo(torch.int32).max)
    pair = []
    for _ in range(2):
        x = sorted_rows(torch, rows, w, torch.int32, gen, True).to(torch.float32)
        tail = x == int_max
        if kind == "±0 band":
            pick = torch.randint(0, 32, x.shape, device="cuda", generator=gen)
            x = torch.where(pick == 0, -0.0, torch.where(pick == 1, 0.0, x - 2**29))
        x = torch.sort(torch.where(tail, float("inf"), x).to(dtype), dim=-1).values
        if kind == "NaN":
            pick = torch.randint(0, 128, x.shape, device="cuda", generator=gen)
            x = torch.where(pick == 0, float("nan"), torch.where(pick == 1, -float("nan"), x.float())).to(dtype)
        pair.append(x.contiguous())
    return pair


def network_spans(torch, mops, a, b, out_w, has_nan):
    """Reference spans that K3's float route merges by the TPU network,
    counted by the script from the inputs with plain tensor ops (the kernel
    counts nothing): every span of a call that may hold a NaN; on NaN-free
    sorted rows, each span [k*tile, (k+1)*tile) whose window (tile keys a
    side from its split) holds both -0.0 and +0.0 and meets a merge CTA
    whose inputs hold a zero. Returns (network spans, all spans)."""
    import torch.nn.functional as F

    rows, w = a.shape
    tile = min(mops.TILE, mops._pow2_at_least(w))
    span = mops.int_span(out_w)
    nt = -(-out_w // tile)
    if has_nan:
        return rows * nt, rows * nt
    assert span >= tile, "a reference span meets at most two merge CTAs"
    af, bf = a.float(), b.float()
    pos_a = (torch.arange(w, device="cuda", dtype=torch.int32)
             + torch.searchsorted(bf, af, side="left", out_int32=True))

    def split(d):  # a-elements among the first d outputs of each row
        return torch.searchsorted(pos_a, d.expand(rows, -1).contiguous(), side="left", out_int32=True).long()

    def prefix(x, negative):  # keys that are a zero of the given sign, before each index
        z = (x == 0) & (torch.signbit(x) == negative)
        return F.pad(torch.cumsum(z, dim=1, dtype=torch.int32), (1, 0))

    def count(pre, lo, hi):
        return pre.gather(1, hi.clamp(0, w)) - pre.gather(1, lo.clamp(0, w))

    pos_a_zero, neg_a_zero = prefix(af, False), prefix(af, True)
    pos_b_zero, neg_b_zero = prefix(bf, False), prefix(bf, True)
    dk = torch.arange(nt, device="cuda") * tile
    ia = split(dk)
    ib = dk - ia
    ea, eb = (ia + tile).clamp(max=w), (ib + tile).clamp(max=w)
    mixed = ((count(pos_a_zero, ia, ea) + count(pos_b_zero, ib, eb) > 0)
             & (count(neg_a_zero, ia, ea) + count(neg_b_zero, ib, eb) > 0))
    dc = (torch.arange(-(-out_w // span) + 1, device="cuda") * span).clamp(max=out_w)
    ic = split(dc)
    jc = dc - ic
    zeros_a, zeros_b = pos_a_zero + neg_a_zero, pos_b_zero + neg_b_zero
    cta_zero = (count(zeros_a, ic[:, :-1], ic[:, 1:]) + count(zeros_b, jc[:, :-1], jc[:, 1:])) > 0
    first = (dk // span).expand(rows, -1)
    last = ((dk + tile).clamp(max=out_w) - 1) // span
    gate = cta_zero.gather(1, first) | cta_zero.gather(1, last.expand(rows, -1))
    return int((mixed & gate).sum()), rows * nt


def kernels_k3_float(torch, mops, mref, gen, details):
    """K3's float route at the key-only merge tail's shapes — whp round 1
    and the exact round clipped to n_max in float32, round 1 in bfloat16 —
    on three kinds of rows (``k3_float_rows``): NaN-free rows and rows with
    a ±0 band take the merge route, rows with NaNs the network route. Each
    call gets the NaN flag as the merge tree hands it (one device byte);
    each row prints how many reference spans the network merged
    (``network_spans``). Bit for bit against the plain version on
    ``plain_rows`` rows; NaN-free rows also against a stable sort of the
    concatenated rows, ±0 band rows against its values and its count of
    -0.0 keys. The bound counts the bytes of the merge and one comparison
    an output."""
    errs = []
    summary = None
    for what, dtype, rows, w, out_w, plain_rows in (
            ("whp round 1", torch.float32, 8192, 1256, 2512, 256),
            ("exact round", torch.float32, 8192, 65536, 79008, 2),
            ("whp round 1", torch.bfloat16, 8192, 1256, 2512, 256)):
        for kind in ("NaN-free", "±0 band", "NaN"):
            a, b = k3_float_rows(torch, kind, dtype, rows, w, gen)
            has_nan = torch.isnan(a).any() | torch.isnan(b).any()
            got = mops.merge_partitioned(a, b, width=out_w, has_nan=has_nan)
            tile = min(mops.TILE, mops._pow2_at_least(w))
            ap, bp = a[:plain_rows].contiguous(), b[:plain_rows].contiguous()
            errs.append(max_abs_err(torch, got[:plain_rows], mref.merge_windows(ap, bp, tile, out_w),
                                    "kernels", f"K3 float {what} {dtype} {kind}"))
            if kind != "NaN":
                want = torch.sort(torch.cat([a, b], dim=-1), dim=-1, stable=True).values[:, :out_w]
                same = (torch.equal(bits(torch, got), bits(torch, want)) if kind == "NaN-free" else
                        torch.equal(got, want) and neg_zeros(torch, got) == neg_zeros(torch, want))
                if not same:
                    fail("kernels", f"K3 float {what} {dtype} {kind}: not the merged rows")
            net, spans = network_spans(torch, mops, a, b, out_w, kind == "NaN")
            b_ms, b_by = bound(rows * (min(2 * w, out_w) + out_w) * a.element_size(), rows * out_w)
            lib = library_timed(torch, lambda: torch.sort(torch.cat([a, b], dim=-1), dim=-1, stable=True))
            d = dict(kernel="K3 float", round=what, dtype=str(dtype), rows_kind=kind, shape=[rows, w],
                     out_width=out_w, network_spans=net, reference_spans=spans,
                     **timed(torch, lambda: mops.merge_partitioned(a, b, width=out_w, has_nan=has_nan)),
                     bound_ms=b_ms, bound_by=b_by, plain_rows=plain_rows,
                     plain_ms=time_ms(torch, lambda: mref.merge_windows(ap, bp, tile, out_w), target_ms=1),
                     library_ms=lib["ms"], library_device_ms=lib["device_ms"])
            details.append(d)
            summary = summary or d
            del a, b, got
    return dict(ms=summary["ms"], plain_ms=summary["plain_ms"], bound_ms=summary["bound_ms"],
                bound_by=summary["bound_by"], library_ms=summary["library_ms"], max_abs_err=max(errs))


def kernels_k3_int64(torch, mops, mref, gen, details):
    """K3's integer route on int64 keys: whp-shaped rounds 1-2, the exact
    round clipped to n_max, clipped widths no multiple of a span, W = 1,
    one side all sentinel; the int64 extremes and ties throughout."""
    errs = []

    def check(a, b, out_w, plain_rows, what):
        got = mops.merge_partitioned(a, b, width=out_w)
        tile = min(mops.TILE, mops._pow2_at_least(a.shape[1]))
        ap, bp = a[:plain_rows].contiguous(), b[:plain_rows].contiguous()
        errs.append(max_abs_err(torch, got[:plain_rows], mref.merge_windows(ap, bp, tile, out_w),
                                "kernels", f"K3 int64 {what}"))
        return tile, ap, bp

    summary = None
    for what, rows, w, out_w, plain_rows in (("whp round 1", 8192, 1256, 2512, 8192),
                                             ("whp round 2", 4096, 2512, 5024, 4096),
                                             ("exact round", 8192, 65536, 79008, 32)):
        a = int64_runs(torch, rows, w, gen)
        b = int64_runs(torch, rows, w, gen)
        tile, ap, bp = check(a, b, out_w, plain_rows, what)
        b_ms, b_by = bound(rows * (min(2 * w, out_w) + out_w) * 8, rows * out_w)
        lib = library_timed(torch, lambda: torch.sort(torch.cat([a, b], dim=-1), dim=-1))
        d = dict(kernel="K3 int64", round=what, shape=[rows, w], out_width=out_w,
                 **timed(torch, lambda: mops.merge_partitioned(a, b, width=out_w)),
                 bound_ms=b_ms, bound_by=b_by, plain_rows=plain_rows,
                 plain_ms=time_ms(torch, lambda: mref.merge_windows(ap, bp, tile, out_w), target_ms=1),
                 library_ms=lib["ms"], library_device_ms=lib["device_ms"])
        details.append(d)
        summary = summary or d
    for what, rows, w, out_w in (("clipped 2000", 512, 1256, 2000), ("clipped 5001", 256, 3000, 5001),
                                 ("W = 1", 1000, 1, 2), ("W = 1 clipped", 1000, 1, 1)):
        check(int64_runs(torch, rows, w, gen), int64_runs(torch, rows, w, gen), out_w, rows, what)
    a = int64_runs(torch, 1024, 1256, gen)
    sent = torch.full_like(a, I64_MAX)
    check(a, sent, 2512, 1024, "b all sentinel")
    check(sent, a, 2000, 1024, "a all sentinel, clipped")
    return dict(ms=summary["ms"], plain_ms=summary["plain_ms"], bound_ms=summary["bound_ms"],
                bound_by=summary["bound_by"], library_ms=summary["library_ms"], max_abs_err=max(errs))


def tile_keys(torch, dtype, rows, w, gen, ties=False):
    """(rows, w) keys of ``dtype`` on the card. Wide random keys, or heavy
    ties (50 values: the order of equal keys' values is the network's);
    float keys get a row of -0.0/+0.0 runs and a row of NaNs of both signs,
    uint32 keys run above 2^31 and hold the uint32 sentinel."""
    if ties:
        x = torch.randint(0, 50, (rows, w), device="cuda", generator=gen)
        if dtype.is_floating_point:
            choice = torch.tensor([-0.0, 0.0, 1.5, -2.0, float("nan")], device="cuda")
            return choice[x % 5].to(dtype)
        return (x.int() * 100_000_000).view(torch.uint32) if dtype == torch.uint32 else x.int()
    x = torch.randint(-(2**30), 2**30, (rows, w), device="cuda", generator=gen)
    if dtype == torch.uint32:
        x = x.int() * 2
        x[:3, :100] = -1  # the uint32 sentinel
        return x.view(torch.uint32)
    if not dtype.is_floating_point:
        x = x.int()
        x[:3, :100] = torch.iinfo(torch.int32).max
        return x
    x = x.float()
    x[:3, :100] = float("inf")
    x[3, : w // 3] = -0.0
    x[3, w // 6 : w // 2] = 0.0
    x[4, ::7] = float("nan")
    x[4, 3::11] = -float("nan")
    return x.to(dtype)


def network_ops(rows, w):
    lg = int(math.log2(w))
    return rows * (w // 2) * lg * (lg + 1) // 2


def kernels_k1(torch, bops, bref, gen, details):
    """K1 bit for bit at every tile width 128 .. 16384 (each has its own
    schedule) for every key dtype, float keys with ±0.0 and NaN rows; timed
    at the main path's tiles, 128 runs x 4 tiles of 16384, and on whole
    runs (the multi-tile sort)."""
    errs = []
    for dtype in key_dtypes(torch):
        for lg in range(7, 15):
            x = tile_keys(torch, dtype, 64, 1 << lg, gen)
            errs.append(max_abs_err(torch, bops.sort_tiles(x), bref.sort_tiles(x), "kernels",
                                    f"K1 {dtype} width {1 << lg}"))
    entry = None
    for dtype in key_dtypes(torch):
        x = tile_keys(torch, dtype, 512, 16384, gen)
        errs.append(max_abs_err(torch, bops.sort_tiles(x), bref.sort_tiles(x), "kernels", f"K1 {dtype}"))
        rows, w = x.shape
        k = timed(torch, lambda: bops.sort_tiles(x))
        b_ms, b_by = bound(2 * x.numel() * x.element_size(), network_ops(rows, w))
        lib = library_timed(torch, lambda: torch.sort(x, dim=-1))
        d = dict(kernel="K1", dtype=str(dtype), shape=[rows, w], **k, bound_ms=b_ms,
                 plain_ms=time_ms(torch, lambda: bref.sort_tiles(x)),
                 library_ms=lib["ms"], library_device_ms=lib["device_ms"])
        if dtype in (torch.int32, torch.float32):
            xm = torch.randint(-(2**30), 2**30, (128, 65536), device="cuda", generator=gen).to(dtype)
            errs.append(max_abs_err(torch, bops.sort(xm), torch.sort(xm, dim=-1).values, "kernels",
                                    f"K1 multi-tile {dtype}"))
            d.update(multi_tile_ms=time_ms(torch, lambda: bops.sort(xm)), multi_tile_shape=list(xm.shape))
        details.append(d)
        if dtype == torch.int32:
            entry = dict(ms=k["ms"], plain_ms=d["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                         library_ms=d["library_ms"])
    entry["max_abs_err"] = max(errs)
    return entry


def kernels_k4(torch, bops, bref, gen, details):
    """K4 bit for bit for 2-, 4- and 8-byte values under every key dtype,
    with heavy ties (float keys with ±0.0 and NaN), at widths 128, 512, 1024
    and 16384; timed at (512, 16384) with int32 values under int32 keys and
    under float32 keys."""
    errs = []
    for dtype in key_dtypes(torch):
        for w in (128, 512, 1024, 16384):
            keys = tile_keys(torch, dtype, 16, w, gen, ties=True)
            for vdt in (torch.int16, torch.int32, torch.int64):
                vals = torch.randperm(keys.numel(), device="cuda", generator=gen).reshape(keys.shape).to(vdt)
                gk, gv = bops.sort_kv_tiles(keys, vals)
                pk, pv = bref.sort_kv_tiles(keys, vals)
                errs.append(max_abs_err(torch, gk, pk, "kernels", f"K4 keys {dtype} {vdt} width {w}"))
                errs.append(max_abs_err(torch, gv, pv, "kernels", f"K4 values {dtype} {vdt} width {w}"))
    entry = None
    for dtype in (torch.int32, torch.float32):
        keys = tile_keys(torch, dtype, 512, 16384, gen, ties=True)
        vals = torch.arange(keys.numel(), dtype=torch.int32, device="cuda").reshape(keys.shape)
        gk, gv = bops.sort_kv_tiles(keys, vals)
        pk, pv = bref.sort_kv_tiles(keys, vals)
        errs.append(max_abs_err(torch, gk, pk, "kernels", f"K4 keys {dtype}"))
        errs.append(max_abs_err(torch, gv, pv, "kernels", f"K4 values {dtype}"))
        rows, w = keys.shape
        k = timed(torch, lambda: bops.sort_kv_tiles(keys, vals))
        b_ms, b_by = bound(2 * keys.numel() * 8, network_ops(rows, w))

        def library():  # two calls: a stable sort of the keys, then a gather
            order = torch.sort(keys, dim=-1, stable=True)
            return order.values, vals.gather(-1, order.indices)

        lib = library_timed(torch, library)
        d = dict(kernel="K4", keys=str(dtype), values="int32", shape=[rows, w], **k, bound_ms=b_ms,
                 plain_ms=time_ms(torch, lambda: bref.sort_kv_tiles(keys, vals)),
                 library_ms=lib["ms"], library_device_ms=lib["device_ms"],
                 library="torch.sort + gather (two calls)")
        details.append(d)
        if dtype == torch.int32:
            entry = dict(ms=k["ms"], plain_ms=d["plain_ms"], bound_ms=b_ms, bound_by=b_by,
                         library_ms=d["library_ms"])
    entry["max_abs_err"] = max(errs)
    return entry


def kernels_k2(torch, sops, sref, gen, details):
    """K2 at the rank merge's two round-1 calls (``core/merge._rank_merge_two``)
    and on every route: sorted queries (one merge per row), unsorted queries
    (a search per query), runs out of order (the masked count), float keys
    with ±0.0 and NaN, tagged splitters, rows of 79 008."""
    int_max = torch.iinfo(torch.int32).max
    errs = []

    def check(got, data, q, side, rows, what):
        errs.append(max_abs_err(torch, got[:rows], rank_in_plain(torch, sref, data, q, side, rows),
                                "kernels", f"K2 {what} {side}"))

    def measure(what, data, q, side, plain_rows, merge):
        """Times one call; the bound counts one merge per row (sorted queries)
        or one binary search per query, and a broadcast query row once."""
        B, n = data.shape
        S = q.shape[1]
        q_words = S if q.stride(0) == 0 else B * S
        ops = B * (n + S) if merge else B * S * math.ceil(math.log2(n + 1))
        b_ms, b_by = bound((B * n + q_words + B * S) * 4, ops)
        qc = q.contiguous()  # the library call's best case: queries in place
        lib = library_timed(torch, lambda: torch.searchsorted(data, qc, side=side, out_int32=True))
        plain = time_ms(torch, lambda: rank_in_plain(torch, sref, data, q, side, plain_rows), target_ms=1)
        d = dict(kernel="K2", call=what, side=side, shape=[B, n], queries=S,
                 query_row_stride=q.stride(0), **timed(torch, lambda: sops.rank_in(data, q, side=side)),
                 bound_ms=b_ms, bound_by=b_by, plain_ms=plain, plain_rows=plain_rows,
                 library_ms=lib["ms"], library_device_ms=lib["device_ms"],
                 library_split=lib["device_split"])
        details.append(d)
        return d

    # the main path's round 1: 8192 pairs of runs of 1256 (pair_cap) with
    # ~512 valid keys; call 1 ranks ka in kb, call 2 the output slots
    # arange(2w), one row broadcast over the rows, in the rank positions pos_a
    rows, w = 8192, 1256
    ka, ca = path_runs(torch, rows, w, gen)
    kb, cb = path_runs(torch, rows, w, gen)
    ra = torch.minimum(sops.rank_in(kb, ka, side="left"), cb[:, None])
    ia = torch.arange(w, dtype=torch.int32, device="cuda")
    pos_a = torch.where(ia < ca[:, None], ia + ra, 2 * w + ia).contiguous()
    o = torch.arange(2 * w, dtype=torch.int32, device="cuda").expand(rows, 2 * w)
    calls = (("call 1: ka in kb", kb, ka, "left"), ("call 2: arange(2w) in pos_a, broadcast", pos_a, o, "right"))
    summary = None
    for what, data, q, side in calls:
        got = sops.rank_in(data, q, side=side)
        check(got, data, q, side, 2048, what)
        if not torch.equal(got, torch.searchsorted(data, q.contiguous(), side=side, out_int32=True)):
            fail("kernels", f"K2 {what}: differs from torch.searchsorted")
        summary = measure(what, data, q, side, rows, merge=True)  # plain on every row
    # random (unsorted) queries at the round-1 shape; rows of 79 008 (the
    # last round) with sorted and with random queries
    for rows, n, s, plain_rows in ((8192, 1256, 2512, 2048), (128, 79008, 79008, 4)):
        data = sorted_rows(torch, rows, n, torch.int32, gen, True)
        q_rand = torch.randint(0, 2**30, (rows, s), device="cuda", generator=gen).int()
        q_rand[:, :8] = int_max
        q_sorted = sorted_rows(torch, rows, s, torch.int32, gen, True)
        for kind, q in (("random queries", q_rand), ("sorted queries", q_sorted)):
            for side in ("left", "right"):
                got = sops.rank_in(data, q, side=side)
                check(got, data, q, side, plain_rows, f"{rows}x{n} {kind}")
                if not torch.equal(got, torch.searchsorted(data, q, side=side, out_int32=True)):
                    fail("kernels", f"K2 {rows}x{n} {kind} {side}: differs from torch.searchsorted")
            if kind == "random queries" or n > 1256:
                measure(f"{rows}x{n} {kind}", data, q, "right", plain_rows, merge=kind == "sorted queries")
    # float keys: ±0.0 ties; rows 0-3 out of order (a NaN inside: the masked
    # count), rows 4-7 with NaN tails (in order); queries sorted, then with
    # NaN keys (out of order: a search per query); rows of one tile, and
    # rows of several (n + S > 4096)
    choice = torch.tensor([-0.0, 0.0, 1.0, -1.0, 2.5, float("inf")], device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        for rows, n, s in ((64, 1256, 2512), (8, 5000, 3000)):
            data = torch.sort(choice[torch.randint(0, 6, (rows, n), device="cuda", generator=gen)], dim=-1).values
            data[:4, n // 2] = float("nan")
            data[4:8, -40:] = float("nan")
            q = torch.sort(choice[torch.randint(0, 6, (rows, s), device="cuda", generator=gen)], dim=-1).values
            q_nan = q.clone()
            q_nan[:, -5:] = float("nan")
            for kind, qq in (("sorted", q), ("NaN", q_nan)):
                for side in ("left", "right"):  # the kernel alone: rank_in adds the JAX pads to it
                    dd, qd = data.to(dtype).contiguous(), qq.to(dtype).contiguous()
                    got = sops._ranks(dd, qd, None, 1 if side == "right" else -1, None, None)
                    check(got, dd, qd, side, rows, f"{dtype} {rows}x{n} {kind} queries")
    # tagged splitters (key, proc, idx) with ties on the key, sorted
    # lexicographically per row (one merge) and as drawn (a search each)
    B, n, S = 1024, 1256, 640
    x = torch.sort(torch.randint(0, 500, (B, n), device="cuda", generator=gen).int(), dim=-1).values
    keys = x.gather(1, torch.randint(0, n, (B, S), device="cuda", generator=gen))
    procs = torch.randint(0, 128, (B, S), device="cuda", generator=gen).int()
    idx = torch.randint(0, n, (B, S), device="cuda", generator=gen).int()
    me = torch.randint(0, 128, (B,), device="cuda", generator=gen).int()
    order = torch.argsort((keys.long() << 32) | (procs.long() << 16) | idx.long(), dim=-1)
    for kind, (k, p, i) in (("sorted", [t.gather(1, order) for t in (keys, procs, idx)]),
                            ("as drawn", (keys, procs, idx))):
        got = sops.splitter_ranks(x, k.contiguous(), p.contiguous(), i.contiguous(), me)
        errs.append(max_abs_err(torch, got, sref.ranks(x, k, p, i, me), "kernels", f"K2 tagged {kind}"))
    return dict(ms=summary["ms"], plain_ms=summary["plain_ms"], bound_ms=summary["bound_ms"],
                bound_by=summary["bound_by"], library_ms=summary["library_ms"], max_abs_err=max(errs))


def kernels_k3(torch, mops, mref, gen, details):
    """K3 on the key-only merge rounds (whp rounds 1-2, the exact round
    clipped to n_max), widths that are no multiple of a span, one side all
    sentinel, all-equal keys, W = 1, and float windows with ±0.0 and NaN."""
    int_max = torch.iinfo(torch.int32).max
    errs = []

    def check(a, b, out_w, plain_rows, what):
        got = mops.merge_partitioned(a, b, width=out_w)
        tile = min(mops.TILE, mops._pow2_at_least(a.shape[1]))
        ap, bp = a[:plain_rows].contiguous(), b[:plain_rows].contiguous()
        errs.append(max_abs_err(torch, got[:plain_rows], mref.merge_windows(ap, bp, tile, out_w),
                                "kernels", f"K3 {what}"))
        return tile, ap, bp

    summary = None
    for what, rows, w, out_w, plain_rows in (("whp round 1", 8192, 1256, 2512, 8192),
                                             ("whp round 2", 4096, 2512, 5024, 4096),
                                             ("exact round", 8192, 65536, 79008, 64)):
        a = sorted_rows(torch, rows, w, torch.int32, gen, True)
        b = sorted_rows(torch, rows, w, torch.int32, gen, True)
        tile, ap, bp = check(a, b, out_w, plain_rows, what)
        # bytes: the inputs that reach the first out_w columns, and the output
        b_ms, b_by = bound(rows * (min(2 * w, out_w) + out_w) * 4, rows * out_w)
        lib = library_timed(torch, lambda: torch.sort(torch.cat([a, b], dim=-1), dim=-1))
        d = dict(kernel="K3", round=what, shape=[rows, w], out_width=out_w,
                 **timed(torch, lambda: mops.merge_partitioned(a, b, width=out_w)),
                 bound_ms=b_ms, bound_by=b_by, plain_rows=plain_rows,
                 plain_ms=time_ms(torch, lambda: mref.merge_windows(ap, bp, tile, out_w), target_ms=1),
                 library_ms=lib["ms"], library_device_ms=lib["device_ms"])
        details.append(d)
        summary = summary or d
    # edges: clipped widths no multiple of any span, one side all sentinel,
    # all-equal keys, one-key rows
    for what, rows, w, out_w in (("clipped 2000", 512, 1256, 2000), ("clipped 5001", 256, 3000, 5001),
                                 ("clipped 7777", 64, 4000, 7777), ("W = 1", 1000, 1, 2),
                                 ("W = 1 clipped", 1000, 1, 1)):
        a = sorted_rows(torch, rows, w, torch.int32, gen, True)
        b = sorted_rows(torch, rows, w, torch.int32, gen, True)
        check(a, b, out_w, rows, what)
    a = sorted_rows(torch, 1024, 1256, torch.int32, gen, False)
    sent = torch.full_like(a, int_max)
    check(a, sent, 2512, 1024, "b all sentinel")
    check(sent, a, 2000, 1024, "a all sentinel, clipped")
    same = torch.full_like(a, 7)
    check(same, same.clone(), 2512, 1024, "all-equal keys")
    # float windows with ±0.0 and NaN: runs as a bitonic network leaves
    # them (NaNs in place), so the diagonals come from the replayed search
    choice = torch.tensor([-0.0, 0.0, float("nan"), 1.0, -1.0], device="cuda")
    rows, w, out_w = 8192, 1256, 2512
    fa = choice[torch.randint(0, 5, (rows, w), device="cuda", generator=gen)]
    fb = choice[torch.randint(0, 5, (rows, w), device="cuda", generator=gen)]
    tile, _, _ = check(fa, fb, out_w, rows, "float32 ±0/NaN")
    check(fa[:512].to(torch.bfloat16), fb[:512].to(torch.bfloat16), 2000, 512, "bfloat16 ±0/NaN clipped")
    nan = torch.isnan(fa).any() | torch.isnan(fb).any()
    b_ms, _ = bound((2 * fa.numel() + rows * out_w) * 4, rows * out_w)
    details.append(dict(kernel="K3", round="float32 ±0.0/NaN windows", shape=[rows, w], out_width=out_w,
                        **timed(torch, lambda: mops.merge_partitioned(fa, fb, width=out_w, has_nan=nan)),
                        bound_ms=b_ms,
                        plain_ms=time_ms(torch, lambda: mref.merge_windows(fa, fb, tile, out_w)),
                        library_ms=library_timed(torch, lambda: torch.sort(torch.cat([fa, fb], dim=-1), dim=-1))["ms"]))
    return dict(ms=summary["ms"], plain_ms=summary["plain_ms"], bound_ms=summary["bound_ms"],
                bound_by=summary["bound_by"], library_ms=summary["library_ms"], max_abs_err=max(errs))


def sorted_reference(torch, x):
    """``torch.sort`` of the flattened keys (uint32 through its order-keeping bias)."""
    flat = x.flatten()
    if x.dtype == torch.uint32:
        return ((torch.sort(flat.view(torch.int32) ^ INT_MIN).values) ^ INT_MIN).view(torch.uint32)
    return torch.sort(flat).values


def stable_order(torch, x):
    flat = x.flatten()
    if x.dtype == torch.uint32:
        flat = flat.view(torch.int32) ^ INT_MIN
    return torch.sort(flat, stable=True).indices


def check_sort(torch, core, x, vals, res, pvals, stats, phase, what):
    """Output bits equal ``torch.sort``'s; where float keys hold -0.0 and
    +0.0, which tie, the values equal and the count of -0.0 keys is kept."""
    out = core.gathered_output(res)
    want = sorted_reference(torch, x)
    if not torch.equal(bits(torch, out), bits(torch, want)) and not (
            x.is_floating_point() and torch.equal(out, want) and neg_zeros(torch, out) == neg_zeros(torch, x)):
        fail(phase, f"{what}: output is not the sorted input")
    if vals:
        counts = res.count.tolist()
        got = torch.cat([pvals[0][k, :c] for k, c in enumerate(counts)])
        if not torch.equal(got, vals[0].flatten()[stable_order(torch, x)]):
            fail(phase, f"{what}: payload is not the stable-argsort gather")
    row = stats.as_row()
    walked = [k[len("tier_"):] for k in row if k.startswith("tier_")]
    if not walked or walked[-1] != stats.last_tier or row["retries"] != len(walked) - 1:
        fail(phase, f"{what}: inconsistent tiers {row}")
    return walked


def parity_input(torch, core, dist, dtype):
    """(8, 512) keys of one distribution, as a CPU tensor of ``dtype``."""
    import numpy as np

    if dist == "noncanonical_nans":  # every 9th key a 0xffff or 0x7f81 NaN
        x = torch.from_numpy(core.datagen.generate("G", 8, 512)).to(torch.bfloat16)
        bits_ = x.view(torch.int16).flatten()
        bits_[::9] = torch.tensor([-1, 0x7F81], dtype=torch.int16).repeat(bits_[::9].numel())[: bits_[::9].numel()]
        return bits_.view(torch.bfloat16).reshape(8, 512)
    if dist in ("signed_zeros", "nans", "cast"):
        rng = np.random.default_rng(0)
        choice = {"signed_zeros": [-0.0, 0.0, 2.0], "nans": [np.nan, -np.nan, 1.0, -1.0, 0.5],
                  "cast": [-0.0, 0.0, np.nan, np.inf, -np.inf, 3.7, -1.5, 5e9, -3e9, 7e4]}[dist]
        x = np.asarray(choice, np.float32)[rng.integers(0, len(choice), (8, 512))]
        return torch.from_numpy(x).to(dtype)
    if dist in RADIX_MIXES:
        return torch.from_numpy(radix_mix(core, dist, 8, 512))
    x = torch.from_numpy(adversarial(8, 512) if dist == "adversarial" else core.datagen.generate(dist, 8, 512))
    if dtype == torch.uint32:
        return (x * 7919 - 2**30).view(torch.uint32)  # keys above 2^31 too
    return x.to(dtype)


#: (name, config overrides, distribution, key dtype, payloads)
PARITY_CASES = (
    ("det U+payload", SLICE, "U", "int32", 1),
    ("det DD", SLICE, "DD", "int32", 0),
    ("det adversarial+payload", SLICE, "adversarial", "int32", 1),
    ("iran U+payload", IRAN, "U", "int32", 1),
    ("iran DD", IRAN, "DD", "int32", 0),
    ("ran U", dict(algorithm="ran", pair_capacity="whp"), "U", "int32", 0),
    ("bitonic [BSI] U", dict(algorithm="bitonic", local_sort="bitonic"), "U", "int32", 0),
    ("iran bitonic sample sort U", dict(IRAN, sample_sort="bitonic"), "U", "int32", 0),
    ("det float32 ±0.0", SLICE, "signed_zeros", "float32", 0),
    ("det float32 ±0.0+payload", SLICE, "signed_zeros", "float32", 1),
    ("det float32 NaN", SLICE, "nans", "float32", 0),
    ("det uint32", SLICE, "U", "uint32", 0),
    ("det bfloat16", SLICE, "U", "bfloat16", 0),
    ("det bfloat16 NaN", SLICE, "nans", "bfloat16", 0),
    ("det bfloat16 non-canonical NaN", SLICE, "noncanonical_nans", "bfloat16", 0),
    ("det bfloat16 non-canonical NaN+payload, lax", dict(SLICE, local_sort="lax"), "noncanonical_nans",
     "bfloat16", 1),
    ("ring bfloat16 non-canonical NaN", dict(SLICE, routing="ring"), "noncanonical_nans", "bfloat16", 0),
    ("[DSR] U+payload", dict(SLICE, local_sort="radix"), "U", "int32", 1),
    ("[DSR] DD", dict(SLICE, local_sort="radix"), "DD", "int32", 0),
    ("[RSR] U+payload", dict(IRAN, local_sort="radix"), "U", "int32", 1),
    ("radix route dense_int", RADIX, "dense_int", "int32", 0),
    ("radix route expert_id+payload", RADIX, "expert_id", "int32", 1),
    ("radix route zipf_skew", RADIX, "zipf_skew", "int32", 0),
    ("radix route U64", RADIX, "U64", "int64", 0),
    ("radix route U64+payload", RADIX, "U64", "int64", 1),
    ("radix route float32 cast", RADIX, "cast", "float32", 0),
    ("radix route bfloat16 cast", RADIX, "cast", "bfloat16", 0),
    ("ring fused+payload", dict(SLICE, routing="ring"), "U", "int32", 1),
    ("ring per_array DD", dict(SLICE, routing="ring", exchange="per_array"), "DD", "int32", 0),
    ("iran ring per_array+payload", dict(IRAN, routing="ring", exchange="per_array"), "U", "int32", 1),
)

#: (name, layout, overrides) of the segmented sort's card/CPU parity
SEGMENTED_PARITY = (
    ("segmented striped", "striped", {}),
    ("segmented contiguous", "contiguous", {}),
    ("segmented striped tree pallas", "striped", dict(merge="tree", merge_backend="pallas")),
    ("segmented one request", "contiguous", {}),
)


def radix_mix(core, name, p, n_p):
    """The mixes of the reference's radix benchmark (``benchmarks/tables.py``)."""
    import numpy as np

    if name == "dense_int":
        return core.datagen.dense_int(p, n_p, seed=21, domain=4 * p)
    if name == "expert_id":
        return core.datagen.dense_int(p, n_p, seed=22, domain=p)
    if name == "U":
        return core.datagen.generate("U", p, n_p, seed=21)
    if name == "zipf_skew":
        return core.datagen.generate("zipf", p, n_p, seed=21)
    x = np.random.default_rng(21).integers(-(2**62), 2**62, (p, n_p), dtype=np.int64)
    x[0, :2] = (I64_MIN, I64_MAX)
    return x


def phase_small_parity(torch, core):
    for name, overrides, dist, dtype, nv in PARITY_CASES:
        x = parity_input(torch, core, dist, getattr(torch, dtype))
        vals = [torch.arange(8 * 512, dtype=torch.int32).reshape(8, 512)][:nv]
        cfg = core.SortConfig(p=8, n_per_proc=512, **overrides)
        gres, gvals, gst = core.bsp_sort_safe(x.cuda(), cfg, values=[v.cuda() for v in vals])
        cres, cvals, cst = core.bsp_sort_safe(x, cfg, values=vals, device="cpu")
        same = (gres.buf.dtype == cres.buf.dtype
                and torch.equal(bits(torch, gres.buf.cpu()), bits(torch, cres.buf))
                and torch.equal(gres.count.cpu(), cres.count)
                and bool(gres.overflow) == bool(cres.overflow) and gst.as_row() == cst.as_row()
                and all(torch.equal(g.cpu(), c) for g, c in zip(gvals, cvals)))
        if not same:
            fail("small_parity", f"{name}: card and CPU results differ")
    import numpy as np

    rng = np.random.default_rng(3)
    batch = [rng.integers(-1000, 1000, n).astype(np.int32) for n in (1, 300, 2000, 77, 1500, 5)]
    for name, layout, overrides in SEGMENTED_PARITY:
        arrs = batch[2:3] if name == "segmented one request" else batch
        g = core.sort_segments(arrs, p=8, layout=layout, **overrides)
        c = core.sort_segments(arrs, p=8, layout=layout, device="cpu", **overrides)
        same = (g.tier == c.tier and g.stats.as_row() == c.stats.as_row()
                and all(torch.equal(a.cpu(), b) for a, b in zip(g.keys + g.order, c.keys + c.order)))
        if not same:
            fail("small_parity", f"{name}: card and CPU results differ")
    emit({"phase": "small_parity", "ok": True,
          "cases": [c[0] for c in PARITY_CASES] + [c[0] for c in SEGMENTED_PARITY]})


def run_sort(torch, core, x, vals, cfg, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, pvals, stats = core.bsp_sort_safe(x, cfg, values=vals, **kw)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, res, pvals, stats


KERNEL_NAMES = ("bitonic_sort_tiles", "splitter_ranks", "merge_sorted_tiles", "bitonic_sort_kv_tiles",
                "splitter_ranks_int64", "merge_sorted_tiles_int64", "merge_sorted_tiles_float")


def full_width_runs(torch, core, cfg, phase):
    """U, DD and U + int32 payload through ``bsp_sort_safe``, first call and warm."""
    runs = []
    for dist, nv in (("U", 0), ("DD", 0), ("U", 1)):
        x = torch.from_numpy(core.datagen.generate(dist, cfg.p, cfg.n_per_proc)).cuda()
        vals = [torch.arange(cfg.n, dtype=torch.int32, device="cuda").reshape(cfg.p, cfg.n_per_proc)][:nv]
        walls = []
        for _ in range(2):  # first call, then a warm one
            wall, res, pvals, stats = run_sort(torch, core, x, vals, cfg)
            walls.append(wall)
            walked = check_sort(torch, core, x, vals, res, pvals, stats, phase,
                                f"{dist}{'+payload' if nv else ''}")
        runs.append(dict(dist=dist, payload=bool(nv), tiers=walked, wall_s=walls,
                         keys_per_s=cfg.n / walls[-1]))
    return runs


def require_launched(launches, names, phase, what="the path"):
    for name in names:
        if launches.get(name, 0) <= 0:
            fail(phase, f"kernel {name} was not launched on {what}")


def phase_main_path(torch, core, build):
    cfg = core.SortConfig(**FULL, **SLICE)
    build.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    runs = full_width_runs(torch, core, cfg, "main_path")
    launches = build.counts()
    require_launched(launches, KERNEL_NAMES[:3], "main_path")
    emit({"phase": "main_path", "ok": True, "config": dict(**FULL, **SLICE),
          "n": cfg.n, "s": cfg.s, "pair_cap": cfg.pair_cap, "n_max": cfg.n_max, "runs": runs,
          "launches": launches, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    return launches


def phase_iran_path(torch, core, build):
    """SORT_IRAN_BSP at full width, then one run each of the other sorts and dtypes."""
    cfg = core.SortConfig(**FULL, **IRAN)
    build.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    runs = full_width_runs(torch, core, cfg, "iran_path")
    require_launched(build.counts(), KERNEL_NAMES[:3], "iran_path")
    u = torch.from_numpy(core.datagen.generate("U", cfg.p, cfg.n_per_proc)).cuda()
    others = []
    for name, overrides, x in (
        ("ran U", dict(algorithm="ran", pair_capacity="whp"), u),
        ("bitonic [BSI] U", dict(algorithm="bitonic", local_sort="bitonic"), u),
        ("det bfloat16 U", SLICE, u.to(torch.bfloat16)),
        ("det uint32 U", SLICE, (u * 7919 - 2**30).view(torch.uint32)),
    ):
        ocfg = core.SortConfig(**FULL, **overrides)
        before = build.counts().get("bitonic_sort_tiles", 0)
        wall, res, pvals, stats = run_sort(torch, core, x, [], ocfg)
        walked = check_sort(torch, core, x, [], res, pvals, stats, "iran_path", name)
        others.append(dict(run=name, tiers=walked, wall_s=wall, keys_per_s=ocfg.n / wall))
        if x.dtype == torch.bfloat16 and build.counts().get("bitonic_sort_tiles", 0) <= before:
            fail("iran_path", "K1 did not launch on bfloat16 keys")
    launches = build.counts()
    emit({"phase": "iran_path", "ok": True, "config": dict(**FULL, **IRAN), "n": cfg.n,
          "s": cfg.s, "pair_cap": cfg.pair_cap, "n_max": cfg.n_max, "runs": runs,
          "others": others, "launches": launches,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    return launches


def phase_sort_kv_path(torch, bops, build):
    """``sort_kv`` as a caller would use it: (key, value) rows of 16384, and
    one 1-D row; output sorted by key, every (key, value) pair kept."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    keys = torch.randint(0, 1000, (512, 16384), device="cuda", generator=gen).int()
    vals = torch.arange(keys.numel(), device="cuda").reshape(keys.shape)
    build.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ko, vo = bops.sort_kv(keys, vals)
    k1, v1 = bops.sort_kv(keys[0, :10000], vals[0, :10000])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = build.counts()
    require_launched(launches, KERNEL_NAMES[3:4], "sort_kv_path", "sort_kv")
    for k, v, x, xv in ((ko, vo, keys, vals), (k1[None], v1[None], keys[:1, :10000], vals[:1, :10000])):
        if not torch.equal(k, torch.sort(x, dim=-1).values):
            fail("sort_kv_path", "keys are not sorted")
        if not torch.equal(x.gather(-1, v - v.min(dim=-1, keepdim=True).values), k):
            fail("sort_kv_path", "a value left its key")
        if not torch.equal(torch.sort(v, dim=-1).values, xv):
            fail("sort_kv_path", "values are not a permutation of the input's")
    emit({"phase": "sort_kv_path", "ok": True, "shape": list(keys.shape), "wall_s": wall,
          "launches": launches})
    return launches


def where_time_goes(torch, fn, reps: int = 5) -> dict:
    """A run's wall (median of ``reps`` warm calls, host clock around work
    ending in a sync), its device busy time under ``torch.profiler``, the
    idle share 1 - busy / wall, and its top device operations."""
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = sorted(((ms, k, c) for k, (ms, c) in device_split(torch, prof).items()), reverse=True)
    busy = sum(r[0] for r in rows)
    return dict(wall_ms=wall, walls_ms=walls, device_busy_ms=busy, idle_share=max(0.0, 1 - busy / wall),
                top=[dict(op=k[:80], ms=ms, calls=c) for ms, k, c in rows[:6]])


def checked_runs(torch, core, build, phase, specs):
    """Each spec ``(name, overrides, x, payloads, kernels)`` through
    ``bsp_sort_safe`` at full width, first call and warm, checked against
    ``torch.sort``; each named kernel must launch on its runs. Returns the
    rows and the launches of these runs; then, not counted, each run's
    wall, busy time and idle share."""
    rows = []
    build.reset_counts()
    for name, overrides, x, nv, kernels in specs:
        cfg = core.SortConfig(p=x.shape[0], n_per_proc=x.shape[1], **overrides)
        vals = [torch.arange(cfg.n, dtype=torch.int32, device="cuda").reshape(x.shape)][:nv]
        before = build.counts()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(2):  # first call, then a warm one
            wall, res, pvals, stats = run_sort(torch, core, x, vals, cfg)
            walls.append(wall)
            walked = check_sort(torch, core, x, vals, res, pvals, stats, phase, name)
        after = build.counts()
        for k in kernels:
            if after.get(k, 0) <= before.get(k, 0):
                fail(phase, f"{name}: kernel {k} was not launched")
        if cfg.route == "radix" and (walked != ["radix"] or stats.retries):
            fail(phase, f"{name}: walked {walked} with {stats.retries} retries, expected one radix rung")
        rows.append(dict(run=name, dtype=str(x.dtype), payload=bool(nv), tiers=walked, wall_s=walls,
                         keys_per_s=cfg.n / walls[-1], peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                         cfg=cfg, x=x, vals=vals))
    launches = build.counts()
    for r in rows:
        cfg, x, vals = r.pop("cfg"), r.pop("x"), r.pop("vals")
        r.update(where_time_goes(torch, lambda: core.bsp_sort_safe(x, cfg, values=vals)))
    torch.cuda.empty_cache()  # as after the kernels phase
    return rows, launches


def phase_radix_path(torch, core, build):
    """[DSR]/[RSR] and ``route="radix"`` on the radix benchmark's mixes."""
    p, n_p = FULL["p"], FULL["n_per_proc"]
    u = torch.from_numpy(core.datagen.generate("U", p, n_p)).cuda()
    specs = [("[DSR] U", dict(SLICE, local_sort="radix"), u, 0, ["merge_sorted_tiles"]),
             ("[RSR] U", dict(IRAN, local_sort="radix"), u, 0, ["merge_sorted_tiles"]),
             ("[DSR] U+payload", dict(SLICE, local_sort="radix"), u, 1, ["splitter_ranks"])]
    for mix in RADIX_MIXES:
        x = torch.from_numpy(radix_mix(core, mix, p, n_p)).cuda()
        k3 = "merge_sorted_tiles_int64" if x.dtype == torch.int64 else "merge_sorted_tiles"
        specs.append((f"radix route {mix}", RADIX, x, 0, ["bitonic_sort_tiles", k3] if mix != "U64" else [k3]))
    rows, launches = checked_runs(torch, core, build, "radix_path", specs)
    emit({"phase": "radix_path", "ok": True, "full": FULL, "runs": rows, "launches": launches})
    return launches


def phase_ring_path(torch, core, build):
    """SORT_DET_BSP with the ring schedule: 127 rotation supersteps."""
    u = torch.from_numpy(core.datagen.generate("U", FULL["p"], FULL["n_per_proc"])).cuda()
    specs = [("det U ring fused", dict(SLICE, routing="ring"), u, 0, ["bitonic_sort_tiles"]),
             ("det U ring per_array", dict(SLICE, routing="ring", exchange="per_array"), u, 0,
              ["bitonic_sort_tiles"]),
             ("det U+payload ring fused", dict(SLICE, routing="ring"), u, 1, [])]
    rows, launches = checked_runs(torch, core, build, "ring_path", specs)
    emit({"phase": "ring_path", "ok": True, "full": FULL, "runs": rows, "launches": launches})
    return launches


def phase_float_path(torch, core, build):
    """SORT_DET_BSP on float32 keys at full width on the kernels' tree
    merge: the U keys cast to float32, and the same keys with one in 16
    replaced by -0.0 or +0.0 (the lowest keys, so the merge rows of a few
    processors hold long bands of mixed zeros). No NaN: K3's float route
    takes its merge route and must launch."""
    u = torch.from_numpy(core.datagen.generate("U", FULL["p"], FULL["n_per_proc"])).cuda().float()
    gen = torch.Generator(device="cuda").manual_seed(2)
    pick = torch.randint(0, 32, u.shape, device="cuda", generator=gen)
    band = torch.where(pick == 0, -0.0, torch.where(pick == 1, 0.0, u))
    k3 = ["bitonic_sort_tiles", "merge_sorted_tiles_float"]
    specs = [("det float32 U", SLICE, u, 0, k3), ("det float32 U ±0 band", SLICE, band, 0, k3)]
    rows, launches = checked_runs(torch, core, build, "float_path", specs)
    emit({"phase": "float_path", "ok": True, "full": FULL, "neg_zeros": neg_zeros(torch, band),
          "zeros": int((band == 0).sum()), "runs": rows, "launches": launches})
    return launches


def segmented_batch(core):
    """256 ragged int32 requests, 2^23 keys in all: heavy-tailed sizes with
    one request of a single key and one of at least 2^20."""
    import numpy as np

    sizes = core.datagen.zipf_sizes(256, 2**23, seed=5)
    lo, hi = int(np.argmin(sizes)), int(np.argmax(sizes))
    sizes[hi] += sizes[lo] - 1
    sizes[lo] = 1
    if sizes.max() < 2**20 or sizes.sum() != 2**23:
        fail("segmented_path", f"size draw out of spec: max {sizes.max()}, sum {sizes.sum()}")
    keys = np.random.default_rng(6).integers(-(2**31), 2**31, 2**23, dtype=np.int64).astype(np.int32)
    keys[:1000] = 7  # ties in the first requests
    return np.split(keys, np.cumsum(sizes)[:-1])


def check_segments(torch, arrays, res, what, phase="segmented_path"):
    for r, a in enumerate(arrays):
        want = torch.sort(torch.from_numpy(a).cuda(), stable=True)
        if not torch.equal(res.keys[r], want.values):
            fail(phase, f"{what}: segment {r} keys are not its sort")
        if not torch.equal(res.order[r].long(), want.indices):
            fail(phase, f"{what}: segment {r} order is not its stable argsort")


def phase_segmented_path(torch, core, build):
    arrays = segmented_batch(core)
    p = FULL["p"]
    packed = {layout: core.pack_segments(arrays, p, layout=layout) for layout in ("striped", "contiguous")}
    specs = (("striped default", "striped", {}, []),
             ("contiguous default", "contiguous", {}, []),
             ("striped tree pallas", "striped", dict(merge="tree", merge_backend="pallas"),
              ["splitter_ranks_int64"]))
    build.reset_counts()
    rows = []
    for name, layout, overrides, kernels in specs:
        before = build.counts()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = core.segmented_sort_safe(packed[layout], **overrides)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            check_segments(torch, arrays, res, name)
        after = build.counts()
        for k in kernels:
            if after.get(k, 0) <= before.get(k, 0):
                fail("segmented_path", f"{name}: kernel {k} was not launched")
        rows.append(dict(run=name, n_per_proc=packed[layout].n_per_proc, tier=res.tier,
                         row=res.stats.as_row(), wall_s=walls, keys_per_s=2**23 / walls[-1],
                         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30, overrides=overrides,
                         layout=layout))
    launches = build.counts()
    for r in rows:
        pk, ov = packed[r.pop("layout")], r.pop("overrides")
        r.update(where_time_goes(torch, lambda: core.segmented_sort_safe(pk, **ov)))
    torch.cuda.empty_cache()  # 48 GiB of exact-tier blocks
    sizes = [len(a) for a in arrays]
    emit({"phase": "segmented_path", "ok": True, "p": p, "requests": len(arrays), "keys": sum(sizes),
          "size_min": min(sizes), "size_max": max(sizes), "runs": rows, "launches": launches})
    return launches


def phase_obs_path(torch, core, build):
    """``main_path``'s det U configuration traced (``SortConfig(obs=...)``)
    and untraced: equal bits out, the route spans' numbers, a (g, L) fit
    over the DD ladder's three rungs, and both warm walls."""
    from repro_torch import obs

    cfg = core.SortConfig(**FULL, **SLICE)
    u = torch.from_numpy(core.datagen.generate("U", cfg.p, cfg.n_per_proc)).cuda()
    dd = torch.from_numpy(core.datagen.generate("DD", cfg.p, cfg.n_per_proc)).cuda()
    build.reset_counts()
    plain, _, _ = core.bsp_sort_safe(u, cfg)
    tracer = obs.Tracer()
    traced, _, _ = core.bsp_sort_safe(u, core.SortConfig(obs=tracer, **FULL, **SLICE))
    ladder_tracer = obs.Tracer()
    res, _, stats = core.bsp_sort_safe(dd, core.SortConfig(obs=ladder_tracer, **FULL, **SLICE))
    torch.cuda.synchronize()
    launches = build.counts()
    require_launched(launches, KERNEL_NAMES[:3:2], "obs_path")
    if not (torch.equal(plain.buf, traced.buf) and torch.equal(plain.count, traced.count)):
        fail("obs_path", "the traced run's output differs from the untraced run's")
    check_sort(torch, core, dd, [], res, [], stats, "obs_path", "DD traced")
    for t in (tracer, ladder_tracer):
        problems = obs.validate_spans(t) + obs.validate_chrome_trace(t.chrome_trace())
        if problems:
            fail("obs_path", f"trace schema: {problems[:3]}")
    if len(ladder_tracer.route_spans()) != 3:
        fail("obs_path", f"DD walked {len(ladder_tracer.route_spans())} rungs, expected 3")
    keep = ("tier", "rung", "ok", "h_words", "supersteps", "recv_max", "imbalance")
    spans = [dict({k: s_["args"][k] for k in keep}, dur_ms=s_["dur"] * 1e3)
             for s_ in tracer.route_spans() + ladder_tracer.route_spans()]
    prepare_ms = [s_["dur"] * 1e3 for s_ in tracer.spans + ladder_tracer.spans if s_["name"] == "prepare"]
    fit = obs.fit_gl(ladder_tracer.route_spans())
    # the ladder's h barely moves (max(recv, n_per_proc) words): a fit over
    # the U rung too spreads h a little more
    fit_all = obs.fit_gl(tracer.route_spans() + ladder_tracer.route_spans())
    walls = {}
    for name, c in (("untraced", cfg), ("traced", None)):
        ws = []
        for _ in range(5):
            run_cfg = c if c is not None else core.SortConfig(obs=obs.Tracer(), **FULL, **SLICE)
            ws.append(run_sort(torch, core, u, [], run_cfg)[0] * 1e3)
        walls[name] = dict(median_ms=statistics.median(ws), walls_ms=ws)
    emit({"phase": "obs_path", "ok": True, "config": dict(**FULL, **SLICE), "route_spans": spans,
          "prepare_span_ms": prepare_ms, "distribution": [p_["args"] for p_ in tracer.points
                                                          if p_["name"] == "distribution"],
          "fit_ladder": dict(g_s_per_word=fit.g_s_per_word, l_s=fit.l_s, r2=fit.r2, n=fit.n_samples, ok=fit.ok),
          "fit_all": dict(g_s_per_word=fit_all.g_s_per_word, l_s=fit_all.l_s, r2=fit_all.r2,
                          n=fit_all.n_samples, ok=fit_all.ok),
          "walls": walls, "launches": launches})
    torch.cuda.empty_cache()
    return launches


PLANNER_MIXES = ("U", "G", "B", "DD", "zipf")


def planner_batch(core, mix):
    """``segmented_batch``'s 256 Zipf(1.2) sizes (2^23 keys), keys of ``mix``."""
    import numpy as np

    sizes = [len(a) for a in segmented_batch(core)]
    keys = core.datagen.generate(mix, 1, KEYS, seed=7)[0]
    return np.split(keys, np.cumsum(sizes)[:-1])


def plan_overrides(d):
    """The segmented sort's overrides for a plan, as the JAX package's
    service dispatcher builds them (``service/dispatch.py:605-617``)."""
    ov = {"pair_capacity": d.pair_capacity}
    if d.route == "radix":
        ov["route"] = "radix"
    elif d.pair_capacity == "planned":
        ov.update(pair_cap_override=d.pair_cap_override, omega=d.omega)
    return ov


def phase_planner_path(torch, core, build):
    """The planned segmented sort as a service would drive it: fingerprint →
    plan → pack with the plan's layout → ``segmented_sort_safe`` with the
    plan's overrides under the kernels' tree merge → record, on the 256
    requests of ``segmented_path`` (2^23 keys, p = 128) for each of the
    planner table's mixes, twice through one planner; then one
    single-segment int32 batch of 2^23 keys under ``local_sort="bitonic"``.
    Its position payload sends Ph2 to the stable sort, as in the JAX
    package, so K1 is gated on the planner's other policy instead: key-only
    DD sorts through ``bsp_sort_safe(planner=...)`` until the planner has
    promoted their bucket to the exact rung, and the run that starts there."""
    from repro_torch import planner as planner_mod

    p = FULL["p"]
    planner = planner_mod.CapacityPlanner()
    runs = []
    build.reset_counts()

    def drive(arrays, overrides):
        t0 = time.perf_counter()
        fp = planner_mod.fingerprint_arrays(arrays, p)
        d = planner.plan(arrays, p, fingerprint=fp)
        packed = core.pack_segments(arrays, p, layout=d.layout)
        t_host = time.perf_counter() - t0
        ov = dict(plan_overrides(d), **overrides)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = core.segmented_sort_safe(packed, **ov)
        torch.cuda.synchronize()
        t_sort = time.perf_counter() - t1
        planner.record(d, res.stats.retries > 0)
        return fp, d, packed, ov, res, t_host, t_sort

    cases = [(mix, planner_batch(core, mix), dict(merge="tree", merge_backend="pallas"), ["splitter_ranks_int64"])
             for mix in PLANNER_MIXES]
    one = [core.datagen.generate("U", 1, KEYS, seed=8)[0]]
    # the segmented sort carries the pos payload, so its Ph2 is the stable
    # sort whatever local_sort says (as in the JAX package): no K1 here
    cases.append(("U single segment", one, dict(merge="tree", merge_backend="pallas", local_sort="bitonic"), []))
    for name, arrays, overrides, kernels in cases:
        for attempt in range(2):
            before = build.counts()
            torch.cuda.reset_peak_memory_stats()
            fp, d, packed, ov, res, t_host, t_sort = drive(arrays, overrides)
            peak = torch.cuda.max_memory_allocated() / 2**30
            check_segments(torch, arrays, res, f"planner {name}", "planner_path")
            after = build.counts()
            for k in kernels:
                if after.get(k, 0) <= before.get(k, 0):
                    fail("planner_path", f"{name}: kernel {k} was not launched")
            runs.append(dict(run=name, attempt=attempt, route=d.route, layout=d.layout, start_tier=d.start_tier,
                             planned_cap=d.pair_cap_override, exact_cap=fp.n_per_proc, omega=d.omega,
                             rung=d.rung, bucket=d.bucket, tier=res.tier, row=res.stats.as_row(),
                             retries=res.stats.retries, host_plan_pack_s=t_host, first_sort_s=t_sort,
                             peak_mem_gib=peak, packed=packed, ov=ov))
    # key-only DD through bsp_sort_safe(planner=...): whp and whp2 fault, so
    # the planner promotes sort/det/p128/npp65536/whp a rung after each
    # min_attempts faulted starts; the run after the last promotion starts
    # at the exact rung the planner chose and must launch K1
    x = torch.from_numpy(core.datagen.generate("DD", p, FULL["n_per_proc"])).cuda()
    cfg = core.SortConfig(**FULL, **SLICE)
    bucket = f"sort/det/p{p}/npp{cfg.n_per_proc}/whp"
    ladder = [name for name, _ in cfg.tier_ladder()]
    starts = []
    while planner.rung_for(bucket, len(ladder)) < ladder.index("exact") and len(starts) < 4 * planner.min_attempts:
        starts.append(ladder[planner.rung_for(bucket, len(ladder))])
        wall, res, pvals, stats = run_sort(torch, core, x, [], cfg, planner=planner)
        check_sort(torch, core, x, [], res, pvals, stats, "planner_path", "DD, planner policy")
    before = build.counts()
    wall, res, pvals, stats = run_sort(torch, core, x, [], cfg, planner=planner)
    walked = check_sort(torch, core, x, [], res, pvals, stats, "planner_path", "DD, promoted bucket")
    if walked != ["exact"] or stats.retries:
        fail("planner_path", f"DD, promoted bucket: walked {walked} with {stats.retries} retries")
    if build.counts().get("bitonic_sort_tiles", 0) <= before.get("bitonic_sort_tiles", 0):
        fail("planner_path", "DD, promoted bucket: kernel bitonic_sort_tiles was not launched")
    runs.append(dict(run="DD key-only, bsp_sort_safe(planner=), after promotion", bucket=bucket,
                     starts_before=starts, tiers=walked, wall_s=wall))
    launches = build.counts()
    for r in runs:
        packed, ov = r.pop("packed", None), r.pop("ov", None)
        if packed is not None and r["attempt"] == 1:
            r.update(where_time_goes(torch, lambda: core.segmented_sort_safe(packed, **ov), reps=3))
    torch.cuda.empty_cache()
    emit({"phase": "planner_path", "ok": True, "p": p, "keys": KEYS, "runs": runs,
          "telemetry": planner.telemetry(), "launches": launches})
    return launches


def phase_delta_path(torch, core, build):
    """The delta subsystem at full width: a ``SortedView`` on the kernels
    (``merge_backend="pallas"``) holding 2^23 int32 keys and an int32
    payload folds Δ = 2^16, then Δ = 2^20 (K2 must launch); then
    ``near_sorted_sort`` of 2^23 streams with 1% of their keys displaced
    (appended, and scattered in place), against a cold ``bsp_sort_safe`` of
    the same stream. Outputs equal the stable sort byte for byte; the fold's
    long rank calls must launch the int64 K2. The launches are read after
    the checked folds and sorts; the timing reruns and the cold reference
    sorts come after them and are not counted."""
    import numpy as np

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import delta

    p, n = FULL["p"], KEYS
    rng = np.random.default_rng(9)
    base = np.sort(rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32))
    runs, folds, sorts = [], [], []
    build.reset_counts()
    view = delta.SortedView(p=p, merge_backend="pallas")
    view.install(base, [np.arange(n, dtype=np.int32)])
    hist_k, hist_v = torch.from_numpy(base).cuda(), torch.arange(n, dtype=torch.int32, device="cuda")
    for dn in (KEYS // 128, KEYS // 8):  # 2^16, 2^20
        dk = rng.integers(-(2**31), 2**31, dn, dtype=np.int64).astype(np.int32)
        dv = np.arange(n, n + dn, dtype=np.int32)
        torch.cuda.reset_peak_memory_stats()
        probe = view.clone()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        route = view.fold(dk, [dv])
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        if route != "fold":
            fail("delta_path", f"Δ = {dn}: took {route}, expected fold")
        hist_k = torch.cat([hist_k, torch.from_numpy(dk).cuda()])
        hist_v = torch.cat([hist_v, torch.from_numpy(dv).cuda()])
        want = torch.sort(hist_k, stable=True)
        if not (torch.equal(view.keys, want.values) and torch.equal(view.payloads[0], hist_v[want.indices])):
            fail("delta_path", f"Δ = {dn}: the view is not the stable sort of its history")
        runs.append(dict(run=f"view fold Δ={dn}", view_n=probe.n, first_s=first, peak_mem_gib=peak))
        folds.append((runs[-1], probe, dk, dv))
        n += dn
    require_launched(build.counts(), ["splitter_ranks"], "delta_path", "the view's folds")
    for pattern in ("appended", "scattered"):
        x = core.datagen.near_sorted(KEYS, 0.01, pattern, seed=10)
        torch.cuda.reset_peak_memory_stats()
        before = build.counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = delta.near_sorted_sort(x, p, backend="pallas")
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        if before.get("splitter_ranks_int64", 0) >= build.counts().get("splitter_ranks_int64", 0):
            fail("delta_path", f"near_sorted_sort {pattern} did not launch the int64 K2")
        if res.tier != "delta" or res.stats.retries:
            fail("delta_path", f"near_sorted_sort {pattern}: tier {res.tier}, {res.stats.retries} retries")
        t0 = time.perf_counter()
        delta_n = int(delta.split_sorted_run(x)[1].size)
        split_s = time.perf_counter() - t0
        runs.append(dict(run=f"near_sorted_sort 2^23, 1% {pattern}", delta_n=delta_n, host_split_s=split_s,
                         first_s=first, peak_mem_gib=peak))
        sorts.append((runs[-1], pattern, x, res))
    launches = build.counts()

    def k2_device_ms(fn):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(ms for k, (ms, _) in device_split(torch, prof).items() if "ranks_kernel" in k or "row_order" in k)

    # not counted from here on: warm walls, profiles and the cold reference
    # sorts; each timed fold takes a copy of the view made outside its window
    for row, probe, dk, dv in folds:
        views = [probe.clone() for _ in range(5)]  # 3 walls, the busy profile, the K2 profile
        torch.cuda.synchronize()
        row.update(where_time_goes(torch, lambda: views.pop().fold(dk, [dv]), reps=3))
        row["k2_device_ms"] = k2_device_ms(lambda: views.pop().fold(dk, [dv]))
    del folds, view, probe, views, hist_k, hist_v, want
    torch.cuda.empty_cache()
    vals = [torch.arange(KEYS, dtype=torch.int32, device="cuda").reshape(p, -1)]
    cold_cfg = {"whp": core.SortConfig(**FULL, **SLICE),
                "exact": core.SortConfig(**FULL, **dict(SLICE, pair_capacity="exact"))}
    for row, pattern, x, res in sorts:
        xt = torch.from_numpy(x).cuda().reshape(p, -1)
        cold, cvals, _ = core.bsp_sort_safe(xt, cold_cfg["exact"], values=vals)
        cold_order = torch.cat([cvals[0][k, :c] for k, c in enumerate(cold.count.tolist())])
        if not (torch.equal(res.keys[0], core.gathered_output(cold)) and torch.equal(res.order[0], cold_order)):
            fail("delta_path", f"near_sorted_sort {pattern} differs from the cold sort")
        row.update(where_time_goes(torch, lambda: delta.near_sorted_sort(x, p, backend="pallas"), reps=3))
        row["k2_device_ms"] = k2_device_ms(lambda: delta.near_sorted_sort(x, p, backend="pallas"))
        # the cold ladder on the same stream: from exact (one rung), and from
        # whp as the main path starts (sorted runs fault whp and whp2)
        for start, c in cold_cfg.items():
            if pattern == "appended" and start == "whp":
                continue
            _, _, cst = core.bsp_sort_safe(xt, c, values=vals)
            cold_row = dict(run=f"cold bsp_sort_safe, 1% {pattern}, det on the kernels + payload, from {start}",
                            tiers=list(cst.attempts))
            cold_row.update(where_time_goes(torch, lambda: core.bsp_sort_safe(xt, c, values=vals), reps=3))
            runs.append(cold_row)
    torch.cuda.empty_cache()
    emit({"phase": "delta_path", "ok": True, "p": p, "runs": runs, "launches": launches})
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
    """Where the full-width time goes: stage times by CUDA events, and the
    device's busy share and top operations under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.api import _PIPELINES, _positions

    cells = []
    for algo, dist, nv in (("det", "U", 0), ("det", "DD", 0), ("det", "U", 1),
                           ("iran", "U", 0), ("iran", "U", 1)):
        cfg = core.SortConfig(**FULL, **(SLICE if algo == "det" else IRAN))
        prepare, route = _PIPELINES[algo]
        x = torch.from_numpy(core.datagen.generate(dist, cfg.p, cfg.n_per_proc)).cuda()
        vals = [torch.arange(cfg.n, dtype=torch.int32, device="cuda").reshape(x.shape)][:nv]
        stages = {"prepare": time_ms(torch, lambda: prepare(x, cfg, vals), target_ms=50)}
        prep = prepare(x, cfg, vals)
        for rung, (tier, tier_cfg) in enumerate(cfg.tier_ladder()[:-1]):
            pos = _positions(tier_cfg, rung, None, x.device)
            stages[f"route_{tier}"] = time_ms(torch, lambda: route(prep, tier_cfg, pos), target_ms=50)
        walls_ms = [run_sort(torch, core, x, vals, cfg)[0] * 1e3 for _ in range(5)]
        wall_ms = statistics.median(walls_ms)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            core.bsp_sort_safe(x, cfg, values=vals)
            torch.cuda.synchronize()
            profiled_ms = (time.perf_counter() - t0) * 1e3
        rows = [(ms, k, c) for k, (ms, c) in device_split(torch, prof).items()]
        rows.sort(reverse=True)
        busy = sum(r[0] for r in rows)
        # idle share against the unprofiled wall: the profiler slows the host
        cells.append(dict(algorithm=algo, dist=dist, payload=bool(nv), stage_ms=stages, wall_ms=wall_ms,
                          walls_ms=walls_ms,
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
    emit({"phase": "build", "ok": True, "seconds": time.perf_counter() - t0,
          "ptxas": ptxas_report(build.build_log())})

    entries = phase_kernels(torch, (bops, bref, sops, sref, mops, mref))
    phase_small_parity(torch, core)
    # launches over the path phases, each counted from zero by the phase
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    for counted in (phase_main_path(torch, core, build), phase_iran_path(torch, core, build),
                    phase_sort_kv_path(torch, bops, build), phase_radix_path(torch, core, build),
                    phase_ring_path(torch, core, build), phase_float_path(torch, core, build),
                    phase_segmented_path(torch, core, build),
                    phase_obs_path(torch, core, build), phase_planner_path(torch, core, build),
                    phase_delta_path(torch, core, build)):
        for name in KERNEL_NAMES:
            launches[name] += counted.get(name, 0)
    phase_ladder(torch, core)
    phase_profile(torch, core)

    meta = {
        "K1": ("bitonic_sort_tiles", "src/repro_torch/csrc/bitonic_sort.cu",
               "src/repro/kernels/bitonic/kernel.py:102"),
        "K2": ("splitter_ranks", "src/repro_torch/csrc/splitter_ranks.cu",
               "src/repro/kernels/searchsorted/kernel.py:47"),
        "K3": ("merge_sorted_tiles", "src/repro_torch/csrc/merge_path.cu",
               "src/repro/kernels/merge_path/kernel.py:39"),
        "K4": ("bitonic_sort_kv_tiles", "src/repro_torch/csrc/bitonic_sort.cu",
               "src/repro/kernels/bitonic/kernel.py:125"),
        "K2_int64": ("splitter_ranks_int64", "src/repro_torch/csrc/splitter_ranks.cu",
                     "src/repro/kernels/searchsorted/kernel.py:47"),
        "K3_int64": ("merge_sorted_tiles_int64", "src/repro_torch/csrc/merge_path.cu",
                     "src/repro/kernels/merge_path/kernel.py:39"),
        "K3_float": ("merge_sorted_tiles_float", "src/repro_torch/csrc/merge_path.cu",
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
