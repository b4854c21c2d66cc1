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
                     windows with ±0.0 and NaN and on Ph2's rounds over
                     K1's tiles (pairs read in place at row stride 2W, W
                     16384 and 2^19, the last clipped short of 2^20); K2
                     and K3 on int64 rows
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
16. ``service_path``— (run after 14) the sort service,
                     ``ServiceConfig(p=128, max_batch_keys=2^21,
                     max_in_flight=2)``, on phase 11's 256 sizes with the
                     keys of the reference's service mixes (U, G, B, DD,
                     zipf): a warm service, then fresh services timed over
                     submit-all + ``flush()`` at depth 2 and depth 1 (median
                     of 3), every request checked against the stable sort,
                     ``in_flight_peak`` 2; the overlap check (a launch must
                     return while the earlier flight's device work runs:
                     ``LaunchEvents``, with its blocking-copy control on U);
                     busy, idle share, peak memory, latency p50/p99; then the
                     open-loop soak (Poisson arrivals at 256 Hz, a burst,
                     every request complete, no failsink error).
17. ``chaos_path`` — the reference's chaos table at full width: a clean
                     service, then one under its ``FaultPlan`` (capacity
                     faults, poison rids 11 and 42, transient launch faults,
                     two stragglers): no innocent fails, both poisons fail
                     naming their rid, innocents byte-identical to the clean
                     run; then a stream of 2^23 keys whose first fold (2^16
                     keys) is corrupted and must fall back to a resort equal
                     to a cold ``bsp_sort_safe``. Phases 16 and 17 launch no
                     K1–K4 (their batches carry the position payload and
                     ``ServiceConfig`` has no ``merge_backend``, as in the
                     JAX package); the count is printed.
18. ``lm_path``    — granite-moe-1b-a400m at full width cut to 12 of its
                     24 layers (``LM_CUT``; d_model
                     1024, 32 experts top-8, vocab 49155; weights from a
                     seeded generator on the card): on its float32 copy the
                     teacher-forced check (prefill 255 tokens and decode
                     the 256th against the prefill of 256, held where the
                     capacity rule dropped none of the last token's
                     records, and always at 64 tokens, where nothing can
                     drop), one layer's grouped GEMM against a per-token
                     loop at n = 512 records, and a 1024-token prompt's
                     overflow flags and dropped records, recounted from the
                     router; ``ServeEngine.serve`` of 32 requests (16–512
                     tokens) and 4 arrivals on 8 slots in bfloat16, greedy,
                     32 new tokens each: every request answered within its
                     budget, refills and prefetches, the admission order;
                     wall (median of 2 warm runs), tokens/s, prefill ms,
                     the decode step at 8 lanes, device busy and idle share
                     over a profiled window, peak memory; the float32
                     streams of 8 requests equal ``generate()`` of each
                     alone; tinyllama-1.1b's float32 teacher-forced check;
                     the reduced granite and tinyllama on the card against
                     the CPU. It launches no K1–K4 (the MoE dispatch sorts
                     with ``torch.sort``, as the reference with
                     ``jnp.argsort``); the count is printed.
19. ``train_path`` — granite-moe-1b-a400m trained at full width (12 of
                     its 24 layers, ``LM_CUT``) in bfloat16 with remat (weights from a seeded generator):
                     15 AdamW steps on the reference's memorizable batch at
                     4 x 4096 tokens (the last loss below 0.8 x the first,
                     every loss and gradient norm finite), one step
                     profiled (busy, idle share, top device ops) and its
                     aten ops counted; ``launch.train.train`` for 4 steps
                     (step walls, tokens/s, the model FLOPs share of the
                     dense-bf16 peak, peak memory); one step at
                     microbatches 2 against 1 from one state (atol 5e-2);
                     float32 gradients with remat equal to those without
                     it at 2 x 512 tokens, and the bfloat16 gradients'
                     error per leaf family; the reduced granite (128 and
                     768 records a layer) and tinyllama on the card
                     against the CPU (gradients, three steps); a restart
                     from a checkpoint on the card, bit for bit, and two
                     uninterrupted runs equal. It launches no K1–K4; the
                     count is printed.
20. ``recurrent_path`` — the recurrent families (their scans are Python
                     loops over time, the parity path): xlstm-350m at full
                     width cut to 12 of its 24 blocks (``REC_CUT``; d_model
                     1024, 4 heads, vocab 50 304;
                     seeded weights) — on its float32 copy a prefill of 64
                     tokens and 8 decode steps against the prefills of 65
                     .. 72 (1e-4 of the largest logit) and 8 ``serve()``
                     streams against ``generate()``; in bfloat16 16
                     requests of 16–64 tokens and 2 arrivals served on 8
                     slots (walls, tokens/s, prefill at 256 tokens, the
                     decode step at 8 lanes and its aten ops, a profiled
                     window's busy and idle share against its own wall,
                     peak memory), 15 memorization steps, one profiled and
                     one counted train step at 3 x 64 tokens, and the
                     ``launch.train`` driver's 4 steps at 3 x 512;
                     jamba-1.5-large-398b at its published widths cut to
                     one super-block (bfloat16 with 8 experts: the carried
                     state at lm_path's 6e-2, 8 requests on 4 slots,
                     prefill and decode times; float32 with 2 experts: the
                     carried state at 1e-4, streams against ``generate()``);
                     the reduced jamba (two super-blocks) and xlstm on the
                     card against the CPU (loss, every gradient leaf, three
                     AdamW steps). It launches no K1–K4; the count is
                     printed. Every time stands beside the card's
                     ``nvidia-smi`` name and power limit.
21. ``audio_path`` — whisper-tiny at its published width and depth (4
                     encoder and 4 decoder layers, d_model 384, 6 heads,
                     d_ff 1536, vocab 51 865, 1500 frames; seeded weights):
                     on its float32 copy a prefill of 64 tokens and 8
                     decode steps against the prefills of 65 .. 72 on one
                     set of frames (1e-4 of the largest logit) and
                     ``generate()`` of 8 requests as one batch against each
                     alone; in bfloat16 ``generate()`` of 32 requests of 64
                     tokens, each with its own frames, 32 new tokens (wall,
                     tokens/s, a profiled run's busy and idle share), the
                     prefill at prefill_32k's 32 x 32 768 tokens, the
                     decode step at decode_32k's 128 lanes on a 32 768-
                     position cache (ms, aten ops), 15 memorization steps,
                     one profiled and one counted train step and the
                     ``launch.train`` driver's 4 steps at 14 x 4096 tokens
                     (12 or 8 if 14 do not fit); the reduced whisper on the card
                     against the CPU (loss, every gradient leaf, three
                     AdamW steps, ``generate()`` streams). Each timed train
                     step, prefill and decode step here, and the train
                     steps of phases 19 and 20, stands beside the dry-run's
                     counted roofline terms at its own shape
                     (``launch.dryrun.lower_cell`` on ``meta`` tensors:
                     FLOPs and bytes of the matrix products, their seconds
                     at the H100 SXM's published peaks) and the wall over
                     the larger term. It launches no K1–K4; the count is
                     printed.
22. ``sharded_path`` — the multi-process runner (``launch.mesh.spawn``;
                     the kernels built by this process first, so the ranks
                     only load them): 4 gloo ranks sharing ``cuda:0``, one
                     processor a rank of p = 4 at n_per_proc = 2^21
                     (main_path's 2^23 keys and configuration):
                     ``bsp_sort_sharded_safe`` on U, DD, U + payload, iran
                     U and [BSI] U, each rank's row equal (sha256 of its
                     buffer, count and payload) to the matching row of one
                     process's ``bsp_sort_safe`` on the card, with the same
                     tiers; the adversarial input climbs whp -> whp2 ->
                     exact with one ``prepare`` entry; K1, K2 and K3 must
                     launch in the ranks. The MoE at granite-moe-1b-a400m's
                     widths (E = 32, top-8, D = 1024, F = 512; seeded
                     weights) on a (data = 2, model = 2) mesh with (4,
                     4096) tokens: ``moe_ep`` (cf 1.25, no drop),
                     ``moe_tp_sharded``, ``moe_ep_decode`` at 8 lanes,
                     float32 within 1e-4 of the largest |y| of the dense
                     evaluation of each rank's tokens and bfloat16 within
                     3e-2, and ``moe_ep_safe`` with a router biased to model
                     shard 0, which must walk whp -> full. Per rank: warm
                     walls (median of 5, every rank started together),
                     peak memory; rank 0: the collectives' ms and the
                     all_to_all's share of a sort's and a ``moe_ep``'s wall,
                     busy and idle share. Then a world of one over NCCL
                     (mesh (1, 1)), the same checks; its calls move no bytes
                     between cards. Walls over gloo go through the host on
                     one card and say nothing of NVLink.
23. ``mesh_path``  — the mesh half over DTensor: 4 gloo ranks sharing
                     ``cuda:0`` as a (data 2, model 2) mesh (NCCL refuses
                     two ranks of one communicator on one card). First
                     gloo's ``reduce_scatter_tensor`` and
                     ``all_gather_into_tensor`` on CUDA tensors over both
                     axes; then float32 parity with one process on the card
                     (rank 0 runs it): granite-moe-1b-a400m (1d: EP MoE,
                     TP attention, Megatron-SP) and tinyllama-1.1b (dp,
                     ZeRO-1; served under 1d) at published widths cut to
                     2 layers, one train step at 4 x 256 (AdamW eps 1),
                     prefill at 4 x 256 and 3 decode steps at 4 lanes: the
                     loss, every updated leaf and the logits within 1e-4
                     of their largest, the same records dropped; then
                     granite at full width cut to 8 of its 24 layers in
                     bf16 with remat: train at
                     4 x 4096 (2 steps: the first's wall, tokens/s, peak
                     a rank; the second profiled on every rank, the card's
                     busy time summed over the ranks, and on rank 0 the
                     device's top ops, idle share and ``HostSplit``: the
                     aten ops dispatched and the wall split into
                     collectives, host reads, other ops and Python),
                     prefill 8 x 512 (median of 2), decode at 8 lanes
                     over a 1024 cache; the same full-width steps in one
                     process beside them, one step under ``HostSplit``.
                     It launches no K1-K4.
24. ``mesh_families_path`` — the last mesh paths, 4 gloo ranks sharing
                     ``cuda:0``: one process first runs the float32
                     parity steps and the bf16 serving walls and frees the
                     card; then on (data 2, model 2) under 1d xlstm-350m
                     cut to 8 blocks, whisper-tiny uncut and jamba at its published
                     widths cut to one super-block, 4 experts and a d_ff
                     of 4096 (~6.2 B parameters), prefill 4 x 256 and 3
                     decode steps within 1e-4 of one process's logits;
                     one jamba train step under 2d on a jamba-shaped
                     model (d_model 1024, ~0.3 B) against rank 0's
                     one-process step (loss, every updated leaf, records
                     dropped); then on (data 1, model 4) under 1d in bf16
                     at published widths: jamba (one super-block, 4
                     experts, ~16.2 B) prefill 4 x 256 and decode at 4
                     lanes over 512, xlstm-350m prefill 8 x 512 and decode
                     at 8 lanes, whisper-tiny prefill 16 x 448 on its 1500
                     frames and decode at 16 lanes: walls a rank and one
                     process's, peak a rank, rank 0's ``HostSplit`` of a
                     decode step. Each rank draws its parameters leaf by
                     leaf and keeps only its blocks. It launches no
                     K1-K4.
25. ``mesh_train_families_path`` — the configurations the mesh took last,
                     gloo ranks sharing ``cuda:0``: one process first runs
                     the float32 steps and the bf16 walls and frees the
                     card; then 4 ranks on (data 2, model 2), AdamW eps 1,
                     each step held to one process's (the loss and every
                     updated leaf within 1e-4 of its largest, a leaf's
                     scale floored at 1e-3 of the model's largest; the
                     logits within 1e-4; the same records dropped):
                     xlstm-350m cut to 8 blocks (one sLSTM) trained at
                     4 x 64 under 1d and under 2d, whisper-tiny uncut
                     trained at 4 x 64 on 1500 frames under 1d,
                     granite-moe-1b-a400m cut to 2 layers trained at
                     4 x 255 under 1d (EP, 32 experts over model 2, a
                     sequence model 2 does not divide: the residual
                     replicated), tinyllama-1.1b cut to 2 layers served
                     under its own dp (prefill 4 x 256, 3 decode steps,
                     the cache re-laid to the sanitized ``cache_specs``);
                     then bf16 at published widths and full depth on
                     (data 1, model 4) under 1d: one xlstm-350m train step
                     at 4 x 64 and one whisper-tiny train step at 8 x 448
                     on 1500 frames (wall a rank, tokens/s, peak a rank,
                     one process's step beside it, rank 0's ``HostSplit``);
                     then a world of 3 ranks on (data 1, model 3):
                     tinyllama-1.1b cut to 2 layers under 1d, whose d_model,
                     d_ff and heads the model axis does not divide (its
                     weights whole), one train step at 4 x 256, prefill
                     4 x 256 and 3 decode steps against one process. Each
                     rank draws its parameters leaf by leaf and keeps only
                     its blocks. It launches no K1-K4.

Then the card's ``nvidia-smi`` name and power limit, one ``{"kernels": ...}``
summary line (``launches``: each kernel's launches over the path phases 5,
7, 8, 9, 10, 10a, 11, 12, 13, 14, 16, 17, 18, 19, 20, 21, 22, 23, 24 and 25, each counted
from zero just before the phase's checked runs and read just after, phase
22's summed over its ranks and also given as ``sharded_launches``, phase
24's as ``mesh_families_launches``, phase 25's as
``mesh_train_families_launches``; the int64
routes of K2 and K3 and K3's float route are listed and counted on their
own),
and as the last line ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the repository beside it, the script exits nonzero and
prints no result. ``--phases service_path,chaos_path`` (any of the path
phases 11, 13, 14, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25) runs the build and those phases
only, and prints no result line.
"""
from __future__ import annotations

import contextlib
import io
import json
import math
import re
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


def idle_share(busy_ms: float, wall_ms: float) -> float:
    """The device's idle share of one profiled run: 1 - its device busy
    time over that same run's wall (both in one unit), not clamped. A busy time
    above the wall (kernels of two streams overlapping, or the profiler's
    accounting) gives a negative share: a finding to print, not to hide."""
    return 1 - busy_ms / wall_ms


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
    clipped to n_max), on Ph2's rounds over K1's tiles (pairs read in place
    as the even and odd rows of one contiguous buffer, row stride 2W: the
    first round of 128 rows x 64 tiles of 16384, the last round to 2^20
    keys a row and the same clipped to n short of a power of two), widths
    that are no multiple of a span, one side all sentinel, all-equal keys,
    W = 1, and float windows with ±0.0 and NaN."""
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
    # Ph2's rounds (kernels/bitonic/ops.py): a pair is rows 2k and 2k + 1 of
    # the buffer K1 or the round before wrote, read where they lie
    for what, rows, w, out_w, plain_rows in (("Ph2 round 1", 8192, 16384, 32768, 4),
                                             ("Ph2 last round", 256, 2**19, 2**20, 2),
                                             ("Ph2 last round clipped", 256, 2**19, 2**20 - 4095, 2)):
        buf = sorted_rows(torch, rows, w, torch.int32, gen, True)
        a, b = buf[0::2], buf[1::2]
        tile, ap, bp = check(a, b, out_w, plain_rows, what)
        b_ms, b_by = bound(rows // 2 * (min(2 * w, out_w) + out_w) * 4, rows // 2 * out_w)
        details.append(dict(kernel="K3", round=what, shape=[rows // 2, w], row_stride=a.stride(0),
                            out_width=out_w,
                            **timed(torch, lambda: mops.merge_partitioned(a, b, width=out_w)),
                            bound_ms=b_ms, bound_by=b_by, plain_rows=plain_rows,
                            plain_ms=time_ms(torch, lambda: mref.merge_windows(ap, bp, tile, out_w),
                                             target_ms=1)))
        del buf, a, b
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
    ending in a sync); one more call under ``torch.profiler``: its own
    wall, its device busy time, the idle share against that wall
    (``idle_share``), and its top device operations."""
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
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((ms, k, c) for k, (ms, c) in device_split(torch, prof).items()), reverse=True)
    busy = sum(r[0] for r in rows)
    return dict(wall_ms=wall, walls_ms=walls, profiled_wall_ms=prof_wall, device_busy_ms=busy,
                idle_share=idle_share(busy, prof_wall), top=[dict(op=k[:80], ms=ms, calls=c) for ms, k, c in rows[:6]])


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
    from repro_torch.service.dispatch import plan_overrides

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


SERVICE_MIXES = ("U", "G", "B", "DD", "zipf")
SERVICE = dict(p=FULL["p"], max_batch_keys=2**21, max_in_flight=2)


def service_requests(core, mix, seed0):
    """``segmented_batch``'s 256 Zipf(1.2) sizes (2^23 keys in all), request
    i holding keys of ``mix`` drawn with seed ``seed0 + i`` (the JAX
    package's ``table_service`` and ``table_chaos`` inputs at this width)."""
    sizes = [len(a) for a in segmented_batch(core)]
    return [core.datagen.generate(mix, 1, n, seed=seed0 + i)[0] for i, n in enumerate(sizes)]


def stable_sorts(torch, arrays):
    """Each request's sorted keys and stable argsort, as numpy, by the
    library's stable sort on the card."""
    out = []
    for a in arrays:
        s = torch.sort(torch.from_numpy(a).cuda(), stable=True)
        out.append((s.values.cpu().numpy(), s.indices.cpu().numpy()))
    return out


def check_futures(futs, want, phase, what, skip=()):
    import numpy as np

    for i, (f, (keys, order)) in enumerate(zip(futs, want)):
        if i in skip:
            continue
        r = f.result()
        if not (np.array_equal(r.keys, keys) and np.array_equal(r.order, order)):
            fail(phase, f"{what}: request {i} is not its stable sort")


class LaunchEvents:
    """Wraps the dispatch module's ``segmented_sort_launch`` (in this script,
    not in the package): a CUDA event is recorded right after each launch
    returns, and at the return of an overlapped launch (another flight in
    the dispatcher) the previous launch's event is queried. A pending event
    there means the launch returned while the earlier flight's device work
    was still running: the launch path did not wait for the stream.

    The service's host work between two launches (plan and pack of the next
    batch) can outlast a flight's device work, and then every event is done
    whatever the launch path does. ``spacer_s`` makes the check independent
    of that ratio: after each launch the card spins for that long
    (``torch.cuda._sleep``) before the event, so a launch that returns with
    the event pending has not waited for the stream. Each launch also
    counts the synchronizing CUDA calls it made
    (``torch.cuda.set_sync_debug_mode``), by source line."""

    NAMES = ("segmented_sort_launch", "near_sorted_sort_launch")

    def __init__(self, torch, dispatch, spacer_s=0.0):
        self.torch, self.dispatch, self.spacer_s = torch, dispatch, spacer_s
        self.orig = {name: getattr(dispatch, name) for name in self.NAMES}
        self.dispatcher = None
        self.rows = []
        self.last = None

    def _wrap(self, orig, describe):
        import warnings

        torch = self.torch

        def launch(*args, **kw):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode(1)
                t0 = time.perf_counter()
                try:
                    inflight = orig(*args, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                host_ms = (time.perf_counter() - t0) * 1e3
            syncs = sorted({f"{Path(w.filename).name}:{w.lineno}" for w in caught
                            if "synchroniz" in str(w.message)})
            if self.spacer_s:
                torch.cuda._sleep(int(self.spacer_s * torch.cuda.clock_rate() * 1e6))
            ev = torch.cuda.Event()
            ev.record()
            overlapped = self.dispatcher is not None and self.dispatcher.in_flight >= 1
            pending = overlapped and self.last is not None and not self.last.query()
            self.rows.append(dict(describe(*args, **kw), overlapped=overlapped, prev_pending=pending,
                                  launch_ms=host_ms, syncs=syncs))
            self.last = ev
            return inflight

        return launch

    def __enter__(self):
        self.dispatch.segmented_sort_launch = self._wrap(
            self.orig["segmented_sort_launch"],
            lambda packed, **kw: dict(segments=len(packed.sizes), keys=packed.n_keys,
                                      route=kw.get("route", "sample")))
        self.dispatch.near_sorted_sort_launch = self._wrap(
            self.orig["near_sorted_sort_launch"],
            lambda keys, p, **kw: dict(segments=1, keys=len(keys), route="delta"))
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.dispatch, name, fn)
        return False

    def summary(self):
        over = [r for r in self.rows if r["overlapped"]]
        return dict(launches=len(self.rows), overlapped=len(over), prev_pending=sum(r["prev_pending"] for r in over),
                    radix_launches=sum(r["route"] == "radix" for r in self.rows),
                    delta_launches=sum(r["route"] == "delta" for r in self.rows),
                    launch_ms_max=max((r["launch_ms"] for r in self.rows), default=0.0),
                    syncs=sorted({x for r in self.rows for x in r["syncs"]}))


def blocking_copies():
    """A context in which the launch path's host-to-device copies are the
    blocking ``.to(device)`` of the tree before the pinned asynchronous
    copy (``core.types.to_device``): the overlap check's control."""
    import contextlib

    import torch

    from repro_torch.core import api, segmented, splitters
    from repro_torch.delta import fold

    @contextlib.contextmanager
    def ctx():
        mods = (api, segmented, splitters, fold)
        saved = [m.to_device for m in mods]
        for m in mods:
            m.to_device = lambda a, device: torch.as_tensor(a).to(torch.device(device))
        try:
            yield
        finally:
            for m, f in zip(mods, saved):
                m.to_device = f

    return ctx()


def timed_flush(torch, svc, arrays):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [svc.submit(a) for a in arrays]
    svc.flush()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, futs


def phase_service_path(torch, core, build):
    """The sort service at full width: ``ServiceConfig(p=128,
    max_batch_keys=2^21, max_in_flight=2)`` with the JAX package's other
    defaults (iran, the planner's starting tiers, lax local sort, merge by
    sort), on ``segmented_batch``'s 256 sizes with the keys of
    ``table_service``'s mixes. Per mix: one warm service, then fresh
    services timed over submit-all + ``flush()`` (median of 3) at depth 2
    and at depth 1, every future of every run checked against the stable
    sort; the overlap check (``LaunchEvents``) read plain on the timed
    depth-2 runs and required, with the card spacer, on one more run (the
    first mix also runs the spacer check with blocking copies, the
    control); device busy time and idle share of one profiled flush
    against its own wall.
    Then the open-loop soak of ``table_service_soak`` at this width."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.service import ServiceConfig, SortService
    from repro_torch.service import dispatch

    build.reset_counts()
    rows = []

    def overlap_run(arrays, want, what):
        with LaunchEvents(torch, dispatch, spacer_s=0.5) as le:
            svc = SortService(ServiceConfig(**SERVICE))
            le.dispatcher = svc.dispatcher
            _, futs = timed_flush(torch, svc, arrays)
        check_futures(futs, want, "service_path", what)
        return le.summary()

    for mix in SERVICE_MIXES:
        arrays = service_requests(core, mix, 100)
        want = stable_sorts(torch, arrays)
        torch.cuda.reset_peak_memory_stats()
        first, futs = timed_flush(torch, SortService(ServiceConfig(**SERVICE)), arrays)
        check_futures(futs, want, "service_path", f"{mix} warm")
        walls, tele = {}, None
        with LaunchEvents(torch, dispatch) as plain:
            for depth in (2, 1):
                ws = []
                for _ in range(3):
                    svc = SortService(ServiceConfig(**dict(SERVICE, max_in_flight=depth)))
                    plain.dispatcher = svc.dispatcher
                    wall, futs = timed_flush(torch, svc, arrays)
                    check_futures(futs, want, "service_path", f"{mix} depth {depth}")
                    ws.append(wall * 1e3)
                    if depth == 2:
                        tele = svc.telemetry()
                        if tele["batches"] >= 2 and tele["dispatch"]["in_flight_peak"] != 2:
                            fail("service_path", f"{mix}: in_flight_peak {tele['dispatch']['in_flight_peak']}")
                walls[depth] = ws
        peak = torch.cuda.max_memory_allocated() / 2**30
        spaced = overlap_run(arrays, want, f"{mix} overlap check")
        if not spaced["prev_pending"]:
            fail("service_path", f"{mix}: no overlapped launch returned before the earlier flight's event: {spaced}")
        control = None
        if mix == SERVICE_MIXES[0]:
            with blocking_copies():
                control = overlap_run(arrays, want, f"{mix} overlap control")
            if control["prev_pending"]:
                fail("service_path", f"{mix}: the control (blocking copies) found a pending event: {control}")
        svc = SortService(ServiceConfig(**SERVICE))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prof_wall, futs = timed_flush(torch, svc, arrays)
        check_futures(futs, want, "service_path", f"{mix} profiled")
        busy = sum(ms for ms, _ in device_split(torch, prof).values())
        wall2 = statistics.median(walls[2])
        d = tele["dispatch"]
        rows.append(dict(mix=mix, requests=len(arrays), keys=KEYS, batches=tele["batches"], buckets=tele["buckets"],
                         start_tiers=tele["start_tiers"], retries=tele["retries"],
                         in_flight_peak=d["in_flight_peak"], overlapped_launches=d["overlapped_launches"],
                         overlap_plain=plain.summary(), overlap_check=spaced, overlap_control=control,
                         first_s=first, wall_ms_depth2=wall2, walls_ms_depth2=walls[2],
                         wall_ms_depth1=statistics.median(walls[1]), walls_ms_depth1=walls[1],
                         keys_per_s=KEYS / (wall2 / 1e3), device_busy_ms=busy,
                         idle_share=idle_share(busy, prof_wall * 1e3), profiled_wall_ms=prof_wall * 1e3,
                         peak_mem_gib=peak, lat_p50_ms=tele["lat_p50_ms"], lat_p99_ms=tele["lat_p99_ms"],
                         launch_rows=plain.rows[:6]))
        torch.cuda.empty_cache()
    soak = service_soak(torch, core)
    launches = build.counts()
    emit({"phase": "service_path", "ok": True, "config": SERVICE, "runs": rows, "soak": soak, "launches": launches})
    return launches


def service_soak(torch, core):
    """``table_service_soak``'s open loop at this width: the zipf mix's 256
    requests arrive on a seeded Poisson clock at 256 Hz, each followed by
    ``flush_ready()``; then a burst of 16 requests of 2^21 / 8 keys and a
    closing ``flush()``. Every request checked; no failsink error."""
    import numpy as np

    from repro_torch.service import ServiceConfig, SortService

    arrays = service_requests(core, "zipf", 300)
    burst = [core.datagen.generate("zipf", 1, SERVICE["max_batch_keys"] // 8, seed=600 + i)[0] for i in range(16)]
    gaps = np.random.default_rng(21).exponential(1.0 / 256.0, len(arrays))
    arrivals = np.cumsum(gaps)
    cfg = ServiceConfig(**SERVICE)
    SortService(cfg).sort_many(arrays + burst)  # warm
    want = stable_sorts(torch, arrays + burst)
    svc = SortService(cfg)
    futs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, a in enumerate(arrays):  # open loop: the schedule never waits for the service
        lag = arrivals[i] - (time.perf_counter() - t0)
        if lag > 0:
            time.sleep(lag)
        futs.append(svc.submit(a))
        svc.flush_ready()
    futs += [svc.submit(a) for a in burst]
    svc.flush()
    wall = time.perf_counter() - t0
    check_futures(futs, want, "service_path", "soak")
    tele = svc.telemetry()
    if tele["dispatch"]["failsink_errors"]:
        fail("service_path", f"soak: {tele['dispatch']['failsink_errors']} failsink errors")
    n_keys = int(sum(a.size for a in arrays + burst))
    return dict(requests=len(futs), keys=n_keys, arrival_hz=256.0, complete=True,
                failsink_errors=tele["dispatch"]["failsink_errors"], batches=tele["batches"],
                in_flight_peak=tele["dispatch"]["in_flight_peak"],
                overlapped_launches=tele["dispatch"]["overlapped_launches"], wall_s=wall, keys_per_s=n_keys / wall,
                lat_p50_ms=tele["lat_p50_ms"], lat_p99_ms=tele["lat_p99_ms"], lat_mean_ms=tele["lat_mean_ms"],
                retries=tele["retries"], flush_triggers=tele["flush_triggers"])


def phase_chaos_path(torch, core, build):
    """``table_chaos`` at full width: the 256 sizes with zipf keys (seed
    900 + i) under ``service_path``'s config, a clean service, then one
    under the table's ``FaultPlan`` (capacity faults, two poison rids,
    transient launch faults, two straggled flights). Innocents complete
    with the clean run's bytes; both poisons fail naming their rid. Then a
    stream: 2^23 keys install the view, 2^16 more fold into it, and that
    fold (fold sequence 0) is corrupted: it must fall back to a resort
    equal to a cold ``bsp_sort_safe`` of the concatenation."""
    import numpy as np

    from repro_torch import obs
    from repro_torch.chaos import FaultPlan
    from repro_torch.service import ServiceConfig, SortService, SortServiceError

    build.reset_counts()
    arrays = service_requests(core, "zipf", 900)
    poison = (11, 42)
    cfg = ServiceConfig(**SERVICE)
    SortService(cfg).sort_many(arrays)  # warm
    ref_svc = SortService(cfg)
    ref_futs = [ref_svc.submit(a) for a in arrays]
    ref_svc.flush()
    want = [(f.result().keys, f.result().order) for f in ref_futs]
    check_futures(ref_futs, stable_sorts(torch, arrays), "chaos_path", "clean run")
    plan = FaultPlan(seed=23, capacity_fault_rate=0.25, capacity_fault_rungs=(0,), poison_rids=poison,
                     transient_error_rate=0.35, straggle_flights=(1, 5), straggle_s=0.002)
    svc = SortService(ServiceConfig(**SERVICE, chaos=plan))
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [svc.submit(a) for a in arrays]
    svc.flush()
    wall = time.perf_counter() - t0
    innocents_failed = poison_failed = 0
    for f in futs:
        exc = f.exception()
        if f.rid in poison:
            poison_failed += isinstance(exc, SortServiceError) and f"rid={f.rid}" in str(exc)
        elif exc is not None:
            innocents_failed += 1
    check_futures(futs, want, "chaos_path", "faulted run against the clean run", skip=poison)
    tele = svc.telemetry()
    inj = plan.injected
    launch_faults = inj.get("launch_error", 0) + inj.get("poison", 0)
    if innocents_failed or poison_failed != 2:
        fail("chaos_path", f"innocents_failed {innocents_failed}, poison_failed {poison_failed}")
    if not (inj.get("capacity_fault", 0) >= 1 and launch_faults >= 1 and tele["dispatch"]["recovered_batches"] >= 1):
        fail("chaos_path", f"faults not exercised: injected {inj}, dispatch {tele['dispatch']}")
    run = dict(requests=len(arrays), keys=KEYS, poison=list(poison), innocents_failed=innocents_failed,
               poison_failed=poison_failed, byte_identical=True, injected=inj, injected_total=plan.injected_total,
               recovered_batches=tele["dispatch"]["recovered_batches"],
               failsink_splits=tele["dispatch"]["failsink_splits"],
               failsink_solo_retries=tele["dispatch"]["failsink_solo_retries"],
               breaker_opened=tele["dispatch"]["breaker_opened"], batches=tele["batches"],
               start_tiers=tele["start_tiers"], retries=tele["retries"], wall_s=wall,
               clean_lat_p99_ms=ref_svc.telemetry()["lat_p99_ms"], lat_p99_ms=tele["lat_p99_ms"],
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    del ref_svc, ref_futs, svc, futs, want
    torch.cuda.empty_cache()

    # the stream: install 2^23 keys, fold 2^16 with the fold corrupted
    rng = np.random.default_rng(31)
    first = rng.integers(-(2**31), 2**31, KEYS, dtype=np.int64).astype(np.int32)
    more = rng.integers(-(2**31), 2**31, KEYS // 128, dtype=np.int64).astype(np.int32)
    splan = FaultPlan(corrupt_folds=(0,))
    ssvc = SortService(ServiceConfig(**SERVICE, chaos=splan))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r1 = ssvc.submit(first, stream="s").result()
    install_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r2 = ssvc.submit(more, stream="s").result()
    fold_s = time.perf_counter() - t0
    view = ssvc.dispatcher._stream_views["s"]
    fallbacks = {str(lbl["view"]): c.value
                 for lbl, c in obs.metrics().collect("delta.fold_fallback_resorts")}.get(view.label, 0)
    if splan.injected != {"fold_corruption": 1} or fallbacks != 1:
        fail("chaos_path", f"stream: injected {splan.injected}, fold_fallback_resorts {fallbacks}")
    cat = np.concatenate([first, more])
    p = FULL["p"]
    xt = torch.from_numpy(cat).cuda().reshape(p, -1)
    cold, cvals, _ = core.bsp_sort_safe(xt, core.SortConfig(p=p, n_per_proc=xt.shape[1], pair_capacity="exact"),
                                        values=[torch.arange(cat.size, device="cuda").reshape(p, -1)])
    cold_order = torch.cat([cvals[0][k, :c] for k, c in enumerate(cold.count.tolist())]).cpu().numpy()
    if not (np.array_equal(r2.keys, core.gathered_output(cold).cpu().numpy()) and np.array_equal(r2.order, cold_order)):
        fail("chaos_path", "stream: the fold's fallback differs from the cold sort")
    if not np.array_equal(r1.keys, np.sort(first)):
        fail("chaos_path", "stream: the installed view is not the sort of the first submit")
    stream = dict(installed=first.size, folded=more.size, injected=splan.injected, fold_fallback_resorts=fallbacks,
                  tier=r2.tier, install_s=install_s, fold_s=fold_s,
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    del ssvc, view, xt, cold, cvals
    torch.cuda.empty_cache()
    launches = build.counts()
    emit({"phase": "chaos_path", "ok": True, "config": SERVICE, "run": run, "stream": stream, "launches": launches})
    return launches


# ------------------------------------------------------------- the LM path
LM_ARCH = "granite-moe-1b-a400m"
#: ``lm_path``'s and ``train_path``'s cut of it: 12 of its 24 layers at
#: its published widths. Its serving is host-bound (~5 800 aten ops a
#: decode step at 24 layers, 115-259 s for ``lm_path`` between calls), and
#: the whole script has to fit its 1 200 s on a card whose host runs slower
LM_CUT = dict(n_layers=12)
DENSE_ARCH = "tinyllama-1.1b"
#: the teacher-forced checks on the card, relative to the logits' largest
#: magnitude: float32 without TF32 (prefill and decode GEMMs sum in other
#: orders over the layers); bfloat16 is printed, not held
TF_TOL = 1e-3
#: a MoE layer against the plain per-token loop, float32, same scale
MOE_TOL = 1e-5
#: the reduced models' prefill logits, card against CPU, float32 (absolute)
CPU_TOL = 1e-4


class MoETap:
    """Wraps ``transformer._mlp_block`` while in ``with``: for every MoE call
    of a prefill it recounts, from the router alone, the records the
    capacity rule drops, and how many of them belong to the last token,
    beside the layer's own overflow flag."""

    def __init__(self, torch, transformer, moe):
        self.torch, self.transformer, self.moe = torch, transformer, moe
        self.rows = []

    def __enter__(self):
        torch, moe, orig = self.torch, self.moe, self.transformer._mlp_block
        self.orig = orig

        def tapped(cfg, lp, h, mesh_info=None, lanes=1):
            y, aux = orig(cfg, lp, h, mesh_info, lanes)
            if cfg.moe_experts and lanes == 1:
                x2d = h.reshape(-1, h.shape[-1])
                E, k = cfg.moe_experts, cfg.moe_top_k
                _, experts, _ = moe._router(x2d, lp["router"], k)
                n = x2d.shape[0] * k
                cap = n if n <= 512 else int(-(-n * 1.25 // E))
                loads = torch.bincount(experts.reshape(-1).long(), minlength=E)
                before_last = torch.bincount(experts[:-1].reshape(-1).long(), minlength=E)
                self.rows.append(dict(overflow=bool(aux["overflow"]),
                                      dropped=int(torch.clamp(loads - cap, min=0).sum()),
                                      last_dropped=int((before_last[experts[-1].long()] >= cap).sum()), cap=cap))
            return y, aux

        self.transformer._mlp_block = tapped
        return self

    def __exit__(self, *exc):
        self.transformer._mlp_block = self.orig


def dispatch_count():
    """A dispatch mode counting the aten ops a block of code dispatches
    (views included): the host's work of an eager step."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    return Count()


def teacher_forced(torch, model, tokens, tap=None):
    """Prefill all but the last token and decode it, against the prefill of
    all: (max |difference| / max |logits|, max |logits|)."""
    n = tokens.shape[1]
    cache, _ = model.prefill({"tokens": tokens[:, :-1]}, cache_len=n)
    dec, _ = model.decode_step(cache, tokens[:, -1])
    if tap is not None:
        with tap:
            _, full = model.prefill({"tokens": tokens}, cache_len=n)
    else:
        _, full = model.prefill({"tokens": tokens}, cache_len=n)
    scale = full.float().abs().max().item()
    return (dec.float() - full.float()).abs().max().item() / scale, scale


def lm_requests(np, vocab, n=32, seed=19):
    """``n`` prompts: lengths from ``default_rng(seed).integers(16, 513, n)``,
    token ids from the same generator."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(16, 513, n)
    return [rng.integers(0, vocab, int(m)).astype(np.int32) for m in lengths], rng


def check_streams(streams, budgets, eos, what, phase="lm_path"):
    for i, (s, b) in enumerate(zip(streams, budgets)):
        if not 1 <= len(s) <= b:
            fail(phase, f"{what}: request {i} answered {len(s)} tokens against a budget of {b}")
        if eos in s.tolist()[:-1]:
            fail(phase, f"{what}: request {i} runs past its EOS")


def timed_serve(torch, eng, reqs, slots, sched=None, hook=None):
    """One ``serve()`` on the host clock around work ending in a sync:
    (seconds, streams, refills, admission prefetches); ``sched`` maps a
    decode step to the prompts arriving there, ``hook`` sees every step."""
    before = (eng.refills, eng.admission_prefetches)

    def arrivals(step):
        if hook is not None:
            hook(step)
        return (sched or {}).get(step)

    torch.cuda.synchronize()
    t = time.perf_counter()
    streams = eng.serve(reqs, slots=slots, arrivals=arrivals)
    torch.cuda.synchronize()
    return time.perf_counter() - t, streams, eng.refills - before[0], eng.admission_prefetches - before[1]


def profiled_window(torch, first, last):
    """A ``serve()`` hook that profiles decode steps ``first`` to ``last``
    (device activity only): ``(hook, result)``, the result holding the
    window's own wall in seconds and the profiler."""
    from torch.profiler import ProfilerActivity, profile

    window = {"prof": profile(activities=[ProfilerActivity.CUDA])}

    def hook(step):
        if step == first:
            torch.cuda.synchronize()
            window["prof"].start()
            window["t0"] = time.perf_counter()
        elif step == last:
            torch.cuda.synchronize()
            window["wall_s"] = time.perf_counter() - window["t0"]
            window["prof"].stop()

    return hook, window


def decode_rate(torch, model, prompt, lanes, steps=16):
    """The decode step's ms at ``lanes`` lanes (one position per lane, a
    cache of twice the prompt), and the aten ops one step dispatches."""
    cache, _ = model.prefill({"tokens": prompt[None].repeat(lanes, 1)}, cache_len=2 * prompt.shape[0])
    cache["pos"] = cache["pos"].expand(lanes).clone()
    tok = torch.zeros(lanes, dtype=torch.int32, device="cuda")
    for _ in range(3):
        model.decode_step(cache, tok)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        logits, cache = model.decode_step(cache, tok)
        tok = logits.argmax(-1).int()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3 / steps
    ops = dispatch_count()
    with ops:
        model.decode_step(cache, tok)
    return ms, ops.n


def prefill_ms(torch, model, prompt, cache_len):
    model.prefill({"tokens": prompt[None]}, cache_len=cache_len)  # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    model.prefill({"tokens": prompt[None]}, cache_len=cache_len)
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def streams_equal_generate(eng, streams, prompts):
    """The requests whose ``serve()`` stream differs from ``generate()`` of
    the request alone."""
    return [i for i, (s, p) in enumerate(zip(streams, prompts))
            if s.tolist() != eng.generate(p[None]).cpu().numpy()[0][: len(s)].tolist()]


def phase_lm_path(torch, core, build):
    """granite-moe-1b-a400m at full width, cut to ``LM_CUT``'s depth, on
    the card: the teacher-forced and MoE checks on its float32 copy,
    ``ServeEngine.serve`` of 32 requests plus 4 arrivals in bfloat16
    (timed, profiled), the float32 streams against ``generate()``;
    tinyllama-1.1b's teacher-forced check; the reduced granite and
    tinyllama on the card against the CPU."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.models import Model, moe, transformer
    from repro_torch.serve import ServeConfig, ServeEngine

    build.reset_counts()
    t_phase = time.perf_counter()
    out = {"seconds": {}}

    def lap(part):
        out["seconds"][part] = time.perf_counter() - t_phase - sum(out["seconds"].values())

    cfg = dataclasses.replace(get_arch(LM_ARCH), **LM_CUT)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg, seed=19)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    out["model"] = dict(arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads,
                        n_kv_heads=cfg.n_kv_heads, experts=cfg.moe_experts, top_k=cfg.moe_top_k, d_ff=cfg.d_ff,
                        vocab=cfg.vocab, params=n_params, cfg_param_count=cfg.param_count(),
                        active_param_count=cfg.active_param_count(), init_s=time.perf_counter() - t0)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = Model(cfg32, params={k: v.float() for k, v in model.state_dict().items()})
    gen = torch.Generator(device="cuda").manual_seed(19)

    # teacher-forced: prefill 255 and decode the 256th, against prefill 256;
    # and at 64 tokens (n = 512 records a layer: full capacity, nothing drops)
    toks = torch.randint(0, cfg.vocab, (1, 256), generator=gen, device="cuda", dtype=torch.int32)
    tap = MoETap(torch, transformer, moe)
    err32, scale32 = teacher_forced(torch, m32, toks, tap)
    err16, scale16 = teacher_forced(torch, model, toks)
    err64, _ = teacher_forced(torch, m32, toks[:, :64])
    last_dropped = sum(r["last_dropped"] for r in tap.rows)
    for r in tap.rows:
        if r["overflow"] != (r["dropped"] > 0):
            fail("lm_path", f"teacher-forced prefill: overflow flag {r['overflow']} with {r['dropped']} drops")
    if err64 > TF_TOL or (last_dropped == 0 and err32 > TF_TOL):
        fail("lm_path", f"teacher-forced float32: {err32} (256 tokens), {err64} (64 tokens) > {TF_TOL}")
    out["teacher_forced"] = dict(tokens=256, tol=TF_TOL, float32_rel_err=err32, bfloat16_rel_err=err16,
                                 logits_max=scale32, bf16_logits_max=scale16, tokens64_float32_rel_err=err64,
                                 layers_overflowing=sum(r["overflow"] for r in tap.rows),
                                 records_dropped=sum(r["dropped"] for r in tap.rows), cap=tap.rows[0]["cap"],
                                 last_token_records_dropped=last_dropped,
                                 held_at_256=last_dropped == 0)
    lap("teacher_forced")

    # one layer's grouped GEMM at n = 64 * 8 = 512 against the per-token loop
    lp = m32.layers[0]
    x = torch.randn((64, cfg.d_model), generator=gen, device="cuda")
    params = {k: lp[k] for k in ("router", "w_gate", "w_up", "w_down")}
    y, aux = moe._grouped_gemm_moe(params, x, cfg32, 1.25)
    probs, experts, _ = moe._router(x, lp["router"], cfg.moe_top_k)
    want = torch.zeros_like(x)
    for t, row in enumerate(experts.tolist()):
        for j, e in enumerate(row):
            want[t] += probs[t, j] * moe._expert_ffn(x[t:t + 1], lp["w_gate"][e], lp["w_up"][e], lp["w_down"][e])[0]
    moe_err = ((y - want).abs().max() / want.abs().max()).item()
    if moe_err > MOE_TOL or bool(aux["overflow"]):
        fail("lm_path", f"grouped GEMM against the per-token loop: {moe_err} > {MOE_TOL}, overflow {aux['overflow']}")
    tap = MoETap(torch, transformer, moe)
    with tap:
        m32.prefill({"tokens": torch.randint(0, cfg.vocab, (1, 1024), generator=gen, device="cuda")})
    for r in tap.rows:
        if r["overflow"] != (r["dropped"] > 0):
            fail("lm_path", f"1024-token prefill: overflow flag {r['overflow']} with {r['dropped']} drops")
    out["moe"] = dict(n512_rel_err=moe_err, tol=MOE_TOL, prompt1024_cap=tap.rows[0]["cap"],
                      prompt1024_overflow=[r["overflow"] for r in tap.rows],
                      prompt1024_dropped=[r["dropped"] for r in tap.rows],
                      prompt1024_dropped_total=sum(r["dropped"] for r in tap.rows),
                      prompt1024_records=1024 * cfg.moe_top_k * cfg.n_layers)
    lap("moe")

    # serving, bfloat16: 32 requests on 8 slots, 4 arrivals at steps 8 and 16
    prompts, rng = lm_requests(np, cfg.vocab)
    late = [rng.integers(0, cfg.vocab, int(m)).astype(np.int32) for m in rng.integers(16, 513, 4)]
    scfg = ServeConfig(max_new_tokens=32, temperature=0.0)
    lengths = np.asarray([len(p) for p in prompts], np.int32)

    sched = {8: late[:2], 16: late[2:]}

    # the profiler over a steady window of one more warm run: decode steps
    # 8 to 40 (two arrivals folding, refills and prefetched prefills in it);
    # the whole run's ~300k kernels would take minutes to tabulate
    hook, window = profiled_window(torch, 8, 40)

    eng = ServeEngine(model, scfg)
    first_s, streams, refills, prefetches = timed_serve(torch, eng, prompts, 8, sched)
    budgets = [scfg.max_new_tokens] * len(streams)
    if len(streams) != len(prompts) + len(late):
        fail("lm_path", f"{len(streams)} streams for {len(prompts) + len(late)} requests")
    check_streams(streams, budgets, scfg.eos_id, "serve")
    if not (refills >= 1 and prefetches >= refills):
        fail("lm_path", f"refills {refills}, admission prefetches {prefetches}")
    order = eng.admission_order(lengths)
    if not np.array_equal(order, np.argsort(lengths, kind="stable")):
        fail("lm_path", "the admission order is not the stable argsort of the prompt lengths")
    walls = []
    for _ in range(2):
        wall, again, _, _ = timed_serve(torch, eng, prompts, 8, sched)
        walls.append(wall)
        if [a.tolist() for a in again] != [s.tolist() for s in streams]:
            fail("lm_path", "a warm serve() gave other greedy streams")
    timed_serve(torch, eng, prompts, 8, sched, hook)
    split = device_split(torch, window["prof"])
    busy = sum(ms for ms, _ in split.values())
    lap("serve_timed_and_profiled")
    wall = statistics.median(walls)
    generated = sum(len(s) for s in streams)
    prefill_ms = []
    for p in prompts + late:
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.prefill({"tokens": torch.from_numpy(p)[None]}, cache_len=1024)
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t) * 1e3)
    # the pure decode rate at 8 lanes of a 544-token cache
    step_ms, step_ops = decode_rate(torch, model, torch.from_numpy(prompts[0][:512]).cuda(), 8, steps=32)
    rows = sorted(((ms, k, c) for k, (ms, c) in split.items()), reverse=True)
    bf16_match = 8 - len(streams_equal_generate(eng, streams[:8], prompts[:8]))
    out["serve"] = dict(requests=len(prompts), arrivals=len(late), slots=8, max_new_tokens=scfg.max_new_tokens,
                        eos_id=scfg.eos_id, prompt_tokens=int(lengths.sum() + sum(len(p) for p in late)),
                        tokens_generated=generated, refills=refills, admission_prefetches=prefetches,
                        first_s=first_s, wall_s=wall, walls_s=walls,
                        tokens_per_s=generated / wall, mean_prefill_ms=statistics.mean(prefill_ms),
                        max_prefill_ms=max(prefill_ms), decode_step_ms_8_lanes=step_ms,
                        decode_step_dispatched_ops=step_ops, host_us_per_op=step_ms * 1e3 / step_ops,
                        decode_tokens_per_s=8 / (step_ms / 1e3), profiled_steps="8-40",
                        profiled_wall_s=window["wall_s"], device_busy_s=busy / 1e3,
                        idle_share=idle_share(busy, window["wall_s"] * 1e3),
                        top=[dict(op=k[:80], ms=ms, calls=c) for ms, k, c in rows[:8]],
                        peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                        bf16_streams_equal_generate=f"{bf16_match} of 8")
    lap("serve_prefill_decode_generate")

    # float32: the same mix's first 8 requests, each stream against generate()
    eng32 = ServeEngine(m32, scfg)
    _, streams32, _, _ = timed_serve(torch, eng32, prompts[:8], 8)
    check_streams(streams32, budgets, scfg.eos_id, "float32 serve")
    differ = streams_equal_generate(eng32, streams32, prompts[:8])
    if differ:
        fail("lm_path", f"float32: serve() streams of requests {differ} differ from generate()")
    out["float32_streams_equal_generate"] = 8
    lap("float32_equality")
    del model, m32, eng, eng32
    torch.cuda.empty_cache()

    # the dense path at full width: tinyllama-1.1b's float32 teacher-forced check
    dcfg = dataclasses.replace(get_arch(DENSE_ARCH), dtype="float32")
    dense = Model(dcfg, seed=19)
    dtoks = torch.randint(0, dcfg.vocab, (1, 256), generator=gen, device="cuda", dtype=torch.int32)
    derr, dscale = teacher_forced(torch, dense, dtoks)
    if derr > TF_TOL:
        fail("lm_path", f"{DENSE_ARCH} teacher-forced float32: {derr} > {TF_TOL}")
    out["dense"] = dict(arch=dcfg.name, params=sum(p.numel() for p in dense.parameters()),
                        cfg_param_count=dcfg.param_count(), float32_rel_err=derr, logits_max=dscale, tol=TF_TOL)
    del dense
    torch.cuda.empty_cache()
    lap("dense")

    # the reduced models, float32: the card against the CPU
    card_cpu = []
    for arch in (LM_ARCH, DENSE_ARCH):
        rcfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
        cpu = Model(rcfg, device="cpu", seed=7)
        card = Model(rcfg, device="cuda", params=cpu.state_dict())
        reqs, _ = lm_requests(np, rcfg.vocab, n=6, seed=23)
        reqs = [r[:48] for r in reqs]
        _, lg_cpu = cpu.prefill({"tokens": reqs[0][None]})
        _, lg_card = card.prefill({"tokens": reqs[0][None]})
        err = (lg_card.cpu() - lg_cpu).abs().max().item()
        kw = ServeConfig(max_new_tokens=16, temperature=0.0, eos_id=rcfg.vocab)  # no EOS: every budget runs out
        s_card = [s.tolist() for s in ServeEngine(card, kw).serve(reqs, slots=3)]
        s_cpu = [s.tolist() for s in ServeEngine(cpu, kw).serve(reqs, slots=3)]
        if err > CPU_TOL or s_card != s_cpu:
            fail("lm_path", f"reduced {arch}: card against CPU logits {err} (> {CPU_TOL}?), streams equal {s_card == s_cpu}")
        card_cpu.append(dict(arch=arch, prefill_abs_err=err, tol=CPU_TOL, streams_equal=True, requests=len(reqs)))
    out["card_vs_cpu"] = card_cpu
    lap("card_vs_cpu")
    torch.cuda.empty_cache()
    launches = build.counts()
    emit({"phase": "lm_path", "ok": True, **out, "launches": launches, "phase_s": time.perf_counter() - t_phase})
    return launches


# ------------------------------------------------------------------ training
#: train_4k's sequence length; the global batch one card takes (train_4k's
#: is 256)
TRAIN_SEQ, TRAIN_BATCH = 4096, 4
#: one train step, card against CPU, reduced models in float32: gradients
#: (of each leaf's largest magnitude) and three steps' losses and norms
#: (relative)
TRAIN_GRAD_TOL, TRAIN_STEP_TOL = 1e-4, 1e-5
#: microbatches=2 against its step by hand (relative): loss, gradient norm
#: and first moments; the two differ only in float32 rounding (the norm's
#: order of summation, the clip scale's quotient)
MB_TOL = 1e-5


def roofline_beside(cfg, shape, wall_s, phase):
    """The dry-run's counted terms of ``shape``'s step (``lower_cell`` on
    ``meta`` tensors: the run's own batch and length, nothing computed)
    beside the run's measured wall, and the wall over the larger term. The
    terms are bounds at the H100 SXM's published peaks
    (``roofline.analysis.PEAK_FLOPS``, ``HBM_BW``). A train step's FLOPs
    share of the peak is given twice: by ``model_flops`` (6 · N_active ·
    tokens) and by the counted FLOPs (remat's recompute and the
    attention's quadratic work included)."""
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.roofline import PEAK_FLOPS

    info = lower_cell(cfg, shape)
    if info["status"] != "ok":
        fail(phase, f"{cfg.name} {shape}: the dry-run's trace: {info}")
    bound = max(info["t_compute_s"], info["t_memory_s"])
    out = dict(batch=shape.global_batch, seq=shape.seq_len, kind=shape.kind, wall_s=wall_s,
               dot_flops_per_dev=info["dot_flops_per_dev"], dot_bytes_per_dev=info["dot_bytes_per_dev"],
               t_compute_s=info["t_compute_s"], t_compute_model_s=info["t_compute_model_s"],
               t_memory_s=info["t_memory_s"], dominant=info["dominant"],
               useful_flops_ratio=info.get("useful_flops_ratio"), mem_args_gb=info["mem_args_gb"],
               counted_aten_ops=info["aten_ops"], trace_s=info["trace_s"], wall_over_bound=wall_s / bound,
               peak_flops=PEAK_FLOPS, terms_source="H100 SXM published peaks (repro_torch.roofline)")
    if shape.kind == "train":
        out["model_flops_share"] = info["model_flops_total"] / wall_s / PEAK_FLOPS
        out["counted_flops_share"] = info["dot_flops_per_dev"] / wall_s / PEAK_FLOPS
    return out


def train_grads(torch, model, batch):
    """(loss, aux, {name: gradient}) of one ``train_loss`` under autograd."""
    model.requires_grad_(True)
    loss, aux = model.train_loss(batch)
    names = [k for k, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return loss.detach(), aux, dict(zip(names, grads))


def microbatch_by_hand(torch, model, batch, mb):
    """The accumulating step's loss, gradient norm and gradients, taken by
    hand: ``train_loss``'s gradients on each of the batch's ``mb`` row
    splits, summed in float32 and divided by ``mb``; the losses averaged."""
    acc, losses = None, []
    for i in range(mb):
        part = {k: v.chunk(mb)[i] for k, v in batch.items()}
        loss, _, g = train_grads(torch, model, part)
        losses.append(loss.double().item())
        acc = {k: t.float() for k, t in g.items()} if acc is None else {k: acc[k] + t.float() for k, t in g.items()}
        del g
    grads = {k: t / mb for k, t in acc.items()}
    norm = math.sqrt(sum(t.double().square().sum().item() for t in grads.values()))
    return dict(loss=sum(losses) / mb, grad_norm=norm, grads=grads)


def microbatch_errors(torch, oc, hand, metrics, opt):
    """Relative errors of an accumulating step against ``hand``: its loss,
    its gradient norm, and its first moments against (1 - beta1) times the
    clipped hand gradients, over each leaf's largest magnitude (a moment
    is the gradient the optimizer saw: a sum in bfloat16, or one
    microbatch's gradient alone, moves it far past float32's rounding)."""
    scale = min(1.0, oc.clip_norm / hand["grad_norm"])
    m_err = 0.0
    for k, g in hand["grads"].items():
        want = (1 - oc.betas[0]) * scale * g
        m_err = max(m_err, ((opt["m"][k].float() - want).abs().max() / want.abs().max().clamp(min=1e-30)).item())
    return dict(loss=abs(float(metrics["loss"]) - hand["loss"]) / abs(hand["loss"]),
                grad_norm=abs(float(metrics["grad_norm"]) - hand["grad_norm"]) / hand["grad_norm"], m=m_err)


def profiled_step(torch, step, params, opt, data):
    """One train step under ``torch.profiler`` (device activity only: a
    step's host ops would take long to tabulate), then one more counted by
    ``dispatch_count``: ``(params, opt, own wall in s, device split, aten
    ops)``."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.start()
    t = time.perf_counter()
    params, opt, m = step(params, opt, data)
    float(m["loss"])
    wall_s = time.perf_counter() - t
    prof.stop()
    split = device_split(torch, prof)
    ops = dispatch_count()
    with ops:
        params, opt, m = step(params, opt, data)
        float(m["loss"])
    return params, opt, wall_s, split, ops.n


def driver_steps(torch, launch_train, cfg, batch, seq, phase):
    """``launch.train.train`` for 4 steps on synthetic batches; each step's
    wall read from the driver's own log line: ``(losses, walls)``."""
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        losses = launch_train.train(cfg, steps=4, batch=batch, seq=seq, ckpt_dir=None, log_every=1)[2]
    print(log.getvalue(), end="", flush=True)
    walls = [float(w) for w in re.findall(r"wall ([0-9.]+) s", log.getvalue())]
    if len(walls) != 4 or not all(math.isfinite(x) for x in losses):
        fail(phase, f"{cfg.name} launch.train: {len(walls)} step walls, losses {losses}")
    return losses, walls


def three_steps(torch, models, vocab, oc, init_all, make_train_step, extras=({}, {}, {})):
    """Three AdamW steps of each model from its own weights on the same
    CPU-made batches (4 x 32 tokens, and ``extras[i]`` beside step i's):
    the (loss, gradient norm) of every step, one list per model."""
    import numpy as np

    runs = []
    for mdl in models:
        params, opt = init_all(mdl, oc)
        stp, got = make_train_step(mdl, oc), []
        for i in range(3):
            t3 = torch.from_numpy(np.random.default_rng(100 + i).integers(0, vocab, (4, 32)).astype(np.int32))
            params, opt, m = stp(params, opt, {"tokens": t3, "labels": torch.roll(t3, -1, 1), **extras[i]})
            got.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append(got)
    return runs


def phase_train_path(torch, core, build):
    """granite-moe-1b-a400m trained at full width, cut to ``LM_CUT``'s
    depth, on the card (bfloat16, remat): 15 steps on memorizable data, the ``launch.train`` driver's
    steps timed and profiled, microbatches against the full batch,
    float32 gradients with and without remat; the reduced granite and
    tinyllama on the card against the CPU; a restart from a checkpoint."""
    import dataclasses
    import tempfile

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import synthetic_batch
    from repro_torch.launch import train as launch_train
    from repro_torch.models import Model
    from repro_torch.optim import OptConfig
    from repro_torch.roofline import model_flops
    from repro_torch.train import checkpoint, init_all, make_train_step

    build.reset_counts()
    t_phase = time.perf_counter()
    out = {"seconds": {}}

    def lap(part):
        out["seconds"][part] = time.perf_counter() - t_phase - sum(out["seconds"].values())

    def fresh():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30

    cfg = dataclasses.replace(get_arch(LM_ARCH), **LM_CUT)
    if not cfg.remat:
        fail("train_path", f"{cfg.name} does not rematerialize")
    shape = ShapeConfig("train_path", TRAIN_SEQ, TRAIN_BATCH, "train")
    tokens_a_step = TRAIN_SEQ * TRAIN_BATCH

    # 1. memorization at full width: the reference's test_train.py batch at
    # train_4k's sequence length
    fresh()
    model = Model(cfg, seed=20)
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=30)
    params, opt = init_all(model, oc)
    step = make_train_step(model, oc)
    tokens = torch.arange(TRAIN_SEQ, dtype=torch.int32, device="cuda")[None].repeat(TRAIN_BATCH, 1)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    rows = []
    for _ in range(15):
        torch.cuda.synchronize()
        t = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        row = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), lr=float(m["lr"]),
                   aux_overflow=bool(m["aux_overflow"]), step_s=time.perf_counter() - t)
        rows.append(row)
        print(json.dumps({"train_step": len(rows), **row}), flush=True)
    if not all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in rows):
        fail("train_path", f"memorization: a loss or gradient norm is not finite: {rows}")
    if not rows[-1]["loss"] < 0.8 * rows[0]["loss"]:
        fail("train_path", f"memorization: last loss {rows[-1]['loss']} not below 0.8 x {rows[0]['loss']}")
    out["memorize"] = dict(arch=cfg.name, dtype=cfg.dtype, remat=cfg.remat, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
                           params=sum(p.numel() for p in model.parameters()), cfg_param_count=cfg.param_count(),
                           active_param_count=cfg.active_param_count(), first_loss=rows[0]["loss"],
                           last_loss=rows[-1]["loss"], ratio=rows[-1]["loss"] / rows[0]["loss"],
                           criterion="last < 0.8 x first", peak_mem_gib=peak_gib())
    lap("memorize")

    # one more step on a synthetic batch, profiled, then its aten ops
    data = synthetic_batch(cfg, shape, 1000)
    params, opt, profiled_s, split, n_ops = profiled_step(torch, step, params, opt, data)
    busy_s = sum(ms for ms, _ in split.values()) / 1e3
    top = sorted(((ms, k, c) for k, (ms, c) in split.items()), reverse=True)[:10]
    del model, params, opt, step
    lap("profile")

    # 2. the normal entry point: launch.train.train on synthetic batches;
    # each step's wall is read from the driver's own log line
    fresh()
    losses, walls = driver_steps(torch, launch_train, cfg, TRAIN_BATCH, TRAIN_SEQ, "train_path")
    wall = statistics.median(walls[1:])
    out["train"] = dict(steps=4, losses=losses, step_walls_s=walls, first_step_s=walls[0], step_wall_s=wall,
                        tokens_per_step=tokens_a_step, tokens_per_s=tokens_a_step / wall,
                        model_flops_per_step=model_flops(cfg, shape),
                        roofline=roofline_beside(cfg, shape, wall, "train_path"),
                        peak_mem_gib=peak_gib(), profiled_step_s=profiled_s, device_busy_s=busy_s,
                        idle_share_profiled=idle_share(busy_s, profiled_s), aten_ops_a_step=n_ops,
                        top=[dict(op=k[:80], ms=ms, calls=c) for ms, k, c in top])
    lap("entry_point")

    # 3. microbatches: one step at microbatches=2 against the same step
    # taken by hand from the same state (each half's gradients summed in
    # float32 and halved, the losses averaged), then against one step at
    # microbatches=1 (the reference's OptConfig() and atol)
    data = synthetic_batch(cfg, shape, 100)
    oc_mb = OptConfig()
    mb_out, kept = {}, None
    for mb in (2, 1):
        fresh()
        model = Model(dataclasses.replace(cfg, microbatches=mb), seed=21)
        params, opt = init_all(model, oc_mb)
        if mb == 2:
            hand = microbatch_by_hand(torch, model, data, mb)
        params, opt, m = make_train_step(model, oc_mb)(params, opt, data)
        mb_out[f"mb{mb}"] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]), peak_mem_gib=peak_gib())
        if mb == 2:
            mb_err = microbatch_errors(torch, oc_mb, hand, m, opt)
            del hand
            kept = {k: p.detach().cpu() for k, p in params.items()}
        else:
            diff = max((p.detach().float() - kept[k].to("cuda").float()).abs().max().item()
                       for k, p in params.items())
        del model, params, opt, m
    if not (mb_err["loss"] <= MB_TOL and mb_err["grad_norm"] <= MB_TOL and mb_err["m"] <= MB_TOL):
        fail("train_path", f"microbatches=2 against its step by hand: {mb_err} (tolerance {MB_TOL})")
    if not diff <= 5e-2:
        fail("train_path", f"microbatches=2 against 1: parameters {diff} apart (atol 5e-2)")
    out["microbatches"] = dict(by_hand_rel_err=mb_err, by_hand_tol=MB_TOL, max_abs_param_diff_vs_mb1=diff,
                               atol_vs_mb1=5e-2, **mb_out)
    del kept
    lap("microbatches")

    # 4. gradients at full width in float32, with and without remat, on 2 x
    # 512 tokens (8192 records a layer: the capacity rule is active); and
    # the bfloat16 model's gradients against them, leaf family by family
    fresh()
    m16 = Model(cfg, seed=22)
    m32 = Model(dataclasses.replace(cfg, dtype="float32"), params={k: v.float() for k, v in m16.state_dict().items()})
    gen = torch.Generator(device="cuda").manual_seed(22)
    toks = torch.randint(0, cfg.vocab, (2, 512), generator=gen, device="cuda", dtype=torch.int32)
    gbatch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    loss_r, aux_r, g_remat = train_grads(torch, m32, gbatch)
    m32.cfg = dataclasses.replace(m32.cfg, remat=False)
    loss_p, aux_p, g_plain = train_grads(torch, m32, gbatch)
    unequal = [k for k in g_remat if not torch.equal(g_remat[k], g_plain[k])]
    if unequal or loss_r.item() != loss_p.item():
        fail("train_path", f"float32 gradients with remat differ from those without it: {unequal[:5]}")
    del g_plain
    _, aux16, g16 = train_grads(torch, m16, gbatch)
    fam = {}
    for k, g in g_remat.items():
        leaf = k.split(".")[-1]
        err, scale = fam.get(leaf, (0.0, 0.0))
        fam[leaf] = (max(err, (g16[k].float() - g).abs().max().item()), max(scale, g.abs().max().item()))
    out["grads_full_width"] = dict(tokens=list(toks.shape), records_a_layer=toks.numel() * cfg.moe_top_k,
                                   remat_equals_plain="bit for bit", loss=loss_r.item(),
                                   overflow=bool(aux_r["overflow"]), bf16_overflow=bool(aux16["overflow"]),
                                   bf16_rel_err={f: e / s for f, (e, s) in sorted(fam.items())},
                                   peak_mem_gib=peak_gib())
    del m16, m32, g_remat, g16
    torch.cuda.empty_cache()
    lap("grads_full_width")

    # 5. the reduced models in float32, card against CPU, batches made on
    # the CPU: granite on both sides of 512 records, tinyllama, and
    # tinyllama's three steps at microbatches=2
    card_cpu = []
    toc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    for arch, s, mb in ((LM_ARCH, 32, 1), (LM_ARCH, 192, 1), (DENSE_ARCH, 32, 1), (DENSE_ARCH, 32, 2)):
        rcfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32", microbatches=mb)
        rng = np.random.default_rng(s)
        toks = torch.from_numpy(rng.integers(0, rcfg.vocab, (2, s)).astype(np.int32))
        b = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
        cpu = Model(rcfg, device="cpu", seed=7)
        card = Model(rcfg, device="cuda", params=cpu.state_dict())
        _, aux_c, g_cpu = train_grads(torch, cpu, b)
        _, aux_g, g_card = train_grads(torch, card, b)
        err = max((g_card[k].cpu() - g).abs().max().item() / g.abs().max().item() for k, g in g_cpu.items())
        flags = [bool(a["overflow"]) for a in (aux_c, aux_g)] if "overflow" in aux_c else None
        runs = three_steps(torch, (cpu, card), rcfg.vocab, toc, init_all, make_train_step)
        step_err = float(np.max(np.abs(np.array(runs[1]) - np.array(runs[0])) / np.abs(np.array(runs[0]))))
        if err > TRAIN_GRAD_TOL or step_err > TRAIN_STEP_TOL or (flags and flags[0] != flags[1]):
            fail("train_path", f"reduced {arch} at {s} tokens, microbatches={mb}: card against CPU gradients {err}, "
                               f"steps {step_err}, overflow {flags}")
        card_cpu.append(dict(arch=arch, tokens=[2, s], microbatches=mb, records_a_layer=2 * s * rcfg.moe_top_k if rcfg.moe_experts else None,
                             overflow=flags, grad_rel_err=err, grad_tol=TRAIN_GRAD_TOL, steps_rel_err=step_err,
                             steps_tol=TRAIN_STEP_TOL))
    out["card_vs_cpu"] = card_cpu
    lap("card_vs_cpu")

    # 6. restart on the card, the reduced granite (bfloat16): 3 steps, save,
    # 2 more; restore and take the same 2 steps; and a second uninterrupted
    # run of 5 steps against the first
    rcfg = get_arch(LM_ARCH).reduced()
    rshape = ShapeConfig("tiny", 32, 4, "train")
    roc = OptConfig(total_steps=10)

    def state_of(params, opt):
        return {"params": {k: p.detach().clone() for k, p in params.items()},
                "opt": {"m": {k: t.clone() for k, t in opt["m"].items()},
                        "v": {k: t.clone() for k, t in opt["v"].items()}, "step": opt["step"].clone()}}

    def same(a, b):
        fa, fb = checkpoint._flatten(a), checkpoint._flatten(b)
        return [k for (k, x), (_, y) in zip(fa, fb) if not torch.equal(bits(torch, x.reshape(-1)), bits(torch, y.reshape(-1)))]

    finals = []
    with tempfile.TemporaryDirectory() as d:
        for run in range(2):
            model = Model(rcfg, seed=0)
            params, opt = init_all(model, roc)
            stp = make_train_step(model, roc)
            for s in range(5):
                if run == 0 and s == 3:
                    checkpoint.save(d, 3, {"params": params, "opt": opt})
                params, opt, _ = stp(params, opt, synthetic_batch(rcfg, rshape, s))
            finals.append(state_of(params, opt))
        spread = same(finals[0], finals[1])
        restored = checkpoint.restore(d, 3, {"params": params, "opt": opt})
        model.load_state_dict(restored["params"])
        params, opt = dict(model.named_parameters()), restored["opt"]
        for s in (3, 4):
            params, opt, _ = stp(params, opt, synthetic_batch(rcfg, rshape, s))
        differ = same(state_of(params, opt), finals[0])
    if differ or spread:
        fail("train_path", f"restart: {len(differ)} leaves differ from the uninterrupted run "
                           f"({differ[:4]}); two uninterrupted runs differ in {spread[:4]}")
    out["restart"] = dict(arch=rcfg.name, dtype=rcfg.dtype, steps="3 + save + 2, restored + 2",
                          equal="bit for bit", uninterrupted_runs_equal=True,
                          leaves=len(checkpoint._flatten(finals[0])))
    lap("restart")
    torch.cuda.empty_cache()
    launches = build.counts()
    emit({"phase": "train_path", "ok": True, **out, "launches": launches, "phase_s": time.perf_counter() - t_phase})
    return launches


# ------------------------------------------------------ the recurrent families
REC_ARCH, HYB_ARCH = "xlstm-350m", "jamba-1.5-large-398b"
#: ``recurrent_path``'s cut of xlstm-350m: 12 of its 24 blocks (11 mLSTM,
#: 1 sLSTM) at its published widths, for the script's time (its serving
#: and training are host-bound)
REC_CUT = dict(n_layers=12)
#: the xlstm driver's batch x length: each mLSTM step saves about 2 MB a
#: row for the backward pass (C and v k^T, float32), ~22 GB a row of 512
#: over the 21 mLSTM blocks of the uncut model (2 x 512 peaked at 47.4
#: GiB), so 3 x 512 fits the card's 80 GB and 4 x 512 does not. The step is host-bound (~10^6
#: aten ops at 512 tokens whatever the batch), so a longer row would
#: lengthen it and a wider batch does not
REC_TRAIN_BATCH, REC_TRAIN_SEQ = 3, 512
#: the profiled and the counted step's batch x length: the profiler takes
#: minutes to tabulate the ~10^6 kernels of a step at 512 tokens
REC_PROFILE_BATCH, REC_PROFILE_SEQ = 3, 64
#: the xlstm serving mix's longest prompt: 16 requests of 16 to 64 tokens
#: (a prefill runs ~500 aten ops a token on the host, ~10 ms a token: 256
#: would make each serve ~15 s, past the phase's time)
REC_PROMPT_MAX = 64
#: jamba at its published widths, cut to one super-block (8 layers: 7
#: Mamba, 1 attention, 4 dense and 4 MoE MLPs) and to 8 experts in bfloat16
#: (25.8 B parameters, ~52 GB) and 2 in float32 (11.3 B, ~45 GB): one
#: super-block with all 16 experts is 45.1 B parameters, 90 GB in bfloat16
HYB_CUT = dict(n_layers=8)
HYB_EXPERTS_BF16, HYB_EXPERTS_F32 = 8, 2
#: a prefill of S then k decode steps against prefills of S + 1 .. S + k,
#: relative to the largest logit: float32, and bfloat16 at lm_path's 6e-2
CARRY_TOL = {"float32": 1e-4, "bfloat16": 6e-2}


def carried_error(torch, model, tokens, s, extras=None):
    """Prefill ``tokens[:, :s]``, then decode the rest one token at a time:
    each step's logits against the last logits of a teacher-forced prefill
    of the same prefix (``extras``, whisper's frames, fed to every
    prefill). Returns (max |difference| / max |logits|, max |logits|) over
    the steps."""
    n, extras = tokens.shape[1], extras or {}
    cache, _ = model.prefill({"tokens": tokens[:, :s], **extras}, cache_len=n)
    err = scale = 0.0
    for j in range(s, n):
        dec, cache = model.decode_step(cache, tokens[:, j])
        _, full = model.prefill({"tokens": tokens[:, :j + 1], **extras}, cache_len=n)
        scale = max(scale, full.float().abs().max().item())
        err = max(err, (dec.float() - full.float()).abs().max().item())
    return err / scale, scale


def recurrent_requests(np, vocab, n, lo, hi, seed):
    """``n`` prompts: lengths from ``default_rng(seed).integers(lo, hi + 1)``,
    token ids from the same generator; and the generator."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, hi + 1, n)
    return [rng.integers(0, vocab, int(m)).astype(np.int32) for m in lengths], rng


def leaf_grad_errors(torch, got, want):
    """Each leaf's largest |got - want| over its largest |want|, that
    magnitude floored at 1e-3 of the largest over all leaves: a leaf whose
    gradient is rounding noise (mLSTM's ``b_i``, invisible to the
    normalised read) is held at the model's scale."""
    floor = 1e-3 * max(g.abs().max().item() for g in want.values())
    return {k: (got[k].cpu() - g).abs().max().item() / max(g.abs().max().item(), floor) for k, g in want.items()}


def phase_recurrent_path(torch, core, build):
    """The recurrent families on the card: xlstm-350m at full width, cut to
    ``REC_CUT``'s depth (float32 carried state against the scan, float32
    streams against ``generate()``, bfloat16 serving and training);
    jamba-1.5-large-398b at its published widths cut to one super-block
    (bfloat16 with 8 experts, float32 with 2); the reduced jamba (two
    super-blocks) and xlstm on the card against the CPU."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import synthetic_batch
    from repro_torch.launch import train as launch_train
    from repro_torch.models import Model
    from repro_torch.optim import OptConfig
    from repro_torch.roofline import PEAK_FLOPS, model_flops
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.train import init_all, make_train_step

    build.reset_counts()
    t_phase = time.perf_counter()
    out = {"seconds": {}, "device": nvidia_smi()}

    def lap(part):
        out["seconds"][part] = time.perf_counter() - t_phase - sum(out["seconds"].values())

    def fresh():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30

    # 1. xlstm-350m at full width, cut to REC_CUT's depth: its float32 copy first
    cfg = dataclasses.replace(get_arch(REC_ARCH), **REC_CUT)
    fresh()
    model = Model(cfg, seed=21)
    m32 = Model(dataclasses.replace(cfg, dtype="float32"), params={k: v.float() for k, v in model.state_dict().items()})
    gen = torch.Generator(device="cuda").manual_seed(21)
    toks = torch.randint(0, cfg.vocab, (1, 72), generator=gen, device="cuda", dtype=torch.int32)
    err32, scale32 = carried_error(torch, m32, toks, 64)
    err16, scale16 = carried_error(torch, model, toks, 64)  # printed, not held
    if err32 > CARRY_TOL["float32"]:
        fail("recurrent_path", f"{REC_ARCH}: decode after a prefill of 64 against prefills of 65..72: float32 "
                               f"{err32} > {CARRY_TOL['float32']}")
    n_params = sum(p.numel() for p in model.parameters())
    out["xlstm"] = dict(arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads,
                        vocab=cfg.vocab, slstm_blocks=len(model.slstm), params=n_params,
                        cfg_param_count=cfg.param_count(),
                        carried=dict(prefill=64, decode_steps=8, float32_rel_err=err32, bfloat16_rel_err=err16,
                                     logits_max=scale32, bf16_logits_max=scale16, tol=CARRY_TOL["float32"]))
    lap("xlstm_carried_state")

    scfg = ServeConfig(max_new_tokens=32, temperature=0.0)
    prompts, rng = recurrent_requests(np, cfg.vocab, 16, 16, REC_PROMPT_MAX, 21)
    late = [rng.integers(0, cfg.vocab, int(m)).astype(np.int32) for m in rng.integers(16, REC_PROMPT_MAX + 1, 2)]
    sched = {8: late[:1], 16: late[1:]}
    # float32: 8 requests (cut to 32 tokens) on 8 slots, 16 tokens each,
    # each stream against generate()
    eng32 = ServeEngine(m32, ServeConfig(max_new_tokens=16, temperature=0.0))
    short = [p[:32] for p in prompts[:8]]
    _, streams32, _, _ = timed_serve(torch, eng32, short, 8)
    check_streams(streams32, [16] * 8, scfg.eos_id, "xlstm float32 serve", "recurrent_path")
    differ = streams_equal_generate(eng32, streams32, short)
    if differ:
        fail("recurrent_path", f"{REC_ARCH} float32: serve() streams of requests {differ} differ from generate()")
    out["xlstm"]["float32_streams_equal_generate"] = len(short)
    del m32, eng32
    lap("xlstm_float32_streams")

    # bfloat16 serving: 16 requests + 2 arrivals on 8 slots, 32 greedy tokens each
    fresh()
    eng = ServeEngine(model, scfg)
    first_s, streams, refills, prefetches = timed_serve(torch, eng, prompts, 8, sched)
    if len(streams) != len(prompts) + len(late):
        fail("recurrent_path", f"{len(streams)} streams for {len(prompts) + len(late)} requests")
    check_streams(streams, [scfg.max_new_tokens] * len(streams), scfg.eos_id, "xlstm serve", "recurrent_path")
    if not (refills >= 1 and prefetches >= refills):
        fail("recurrent_path", f"xlstm serve: refills {refills}, admission prefetches {prefetches}")
    walls = []
    for _ in range(2):
        wall, again, _, _ = timed_serve(torch, eng, prompts, 8, sched)
        walls.append(wall)
        if [a.tolist() for a in again] != [s.tolist() for s in streams]:
            fail("recurrent_path", "xlstm: a warm serve() gave other greedy streams")
    hook, window = profiled_window(torch, 8, 24)
    timed_serve(torch, eng, prompts, 8, sched, hook)
    split = device_split(torch, window["prof"])
    busy_ms = sum(ms for ms, _ in split.values())
    top = sorted(((ms, k, c) for k, (ms, c) in split.items()), reverse=True)[:8]
    step_ms, step_ops = decode_rate(torch, model, torch.from_numpy(prompts[0][:64]).cuda(), 8)
    p256 = torch.randint(0, cfg.vocab, (256,), generator=gen, device="cuda", dtype=torch.int32)
    generated = sum(len(s) for s in streams)
    wall = statistics.median(walls)
    out["xlstm"]["serve"] = dict(
        requests=len(prompts), arrivals=len(late), slots=8, max_new_tokens=scfg.max_new_tokens,
        prompt_tokens=int(sum(len(p) for p in prompts + late)), tokens_generated=generated, refills=refills,
        admission_prefetches=prefetches, first_s=first_s, wall_s=wall, walls_s=walls, tokens_per_s=generated / wall,
        prefill_ms_256=prefill_ms(torch, model, p256, 288), decode_step_ms_8_lanes=step_ms,
        decode_step_aten_ops=step_ops, profiled_steps="8-24", profiled_wall_s=window["wall_s"],
        device_busy_s=busy_ms / 1e3, idle_share=idle_share(busy_ms, window["wall_s"] * 1e3),
        top=[dict(op=k[:80], ms=ms, calls=c) for ms, k, c in top], peak_mem_gib=peak_gib())
    del eng
    lap("xlstm_serve")

    # bfloat16 training with float32 AdamW moments: 15 memorization steps
    # at 2 x 32 tokens, one profiled step and one counted, then the
    # driver's own 4 steps
    fresh()
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=30)
    params, opt = init_all(model, oc)
    step = make_train_step(model, oc)
    tokens = torch.arange(32, dtype=torch.int32, device="cuda")[None].repeat(2, 1)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    losses = []
    for _ in range(15):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    if not all(map(math.isfinite, losses)) or not losses[-1] < 0.8 * losses[0]:
        fail("recurrent_path", f"{REC_ARCH} memorization: losses {losses}")
    pshape = ShapeConfig("recurrent_path", REC_PROFILE_SEQ, REC_PROFILE_BATCH, "train")
    data = synthetic_batch(cfg, pshape, 1000)
    params, opt, profiled_s, split, n_ops = profiled_step(torch, step, params, opt, data)
    busy_ms = sum(ms for ms, _ in split.values())
    top = sorted(((ms, k, c) for k, (ms, c) in split.items()), reverse=True)[:8]
    torch.cuda.synchronize()
    t = time.perf_counter()
    params, opt, m = step(params, opt, data)
    float(m["loss"])
    counted = roofline_beside(cfg, pshape, time.perf_counter() - t, "recurrent_path")
    del model, params, opt, step, m, split
    lap("xlstm_memorize_profile")
    fresh()
    dlosses, dwalls = driver_steps(torch, launch_train, cfg, REC_TRAIN_BATCH, REC_TRAIN_SEQ, "recurrent_path")
    tokens_a_step = REC_TRAIN_BATCH * REC_TRAIN_SEQ
    wall = statistics.median(dwalls[1:])
    dshape = ShapeConfig("recurrent_path", REC_TRAIN_SEQ, REC_TRAIN_BATCH, "train")
    flops = model_flops(cfg, dshape)
    out["xlstm"]["train"] = dict(
        batch=REC_TRAIN_BATCH, seq=REC_TRAIN_SEQ, memorize=dict(tokens=[2, 32], first_loss=losses[0],
                                                                 last_loss=losses[-1], ratio=losses[-1] / losses[0]),
        steps=4, losses=dlosses, step_walls_s=dwalls, step_wall_s=wall, tokens_per_s=tokens_a_step / wall,
        model_flops_per_step=flops, model_flops_share=flops / wall / PEAK_FLOPS, peak_flops=PEAK_FLOPS,
        roofline_at_profiled_tokens=counted,
        profiled_tokens=[REC_PROFILE_BATCH, REC_PROFILE_SEQ], profiled_step_s=profiled_s,
        device_busy_s=busy_ms / 1e3, idle_share=idle_share(busy_ms, profiled_s * 1e3), aten_ops_a_step=n_ops,
        top=[dict(op=k[:80], ms=ms, calls=c) for ms, k, c in top], peak_mem_gib=peak_gib())
    lap("xlstm_train")

    # 2. jamba at its published widths, one super-block: bfloat16, 8 experts
    fresh()
    jcfg = dataclasses.replace(get_arch(HYB_ARCH), moe_experts=HYB_EXPERTS_BF16, **HYB_CUT)
    jamba = Model(jcfg, seed=23)
    torch.cuda.synchronize()
    jout = dict(arch=jcfg.name, cut=dict(HYB_CUT, moe_experts=HYB_EXPERTS_BF16,
                                         moe_experts_float32=HYB_EXPERTS_F32,
                                         published=dict(n_layers=72, moe_experts=16)),
                d_model=jcfg.d_model, n_heads=jcfg.n_heads, n_kv_heads=jcfg.n_kv_heads, d_ff=jcfg.d_ff,
                vocab=jcfg.vocab, mamba=dict(d_state=jcfg.mamba_d_state, expand=jcfg.mamba_expand,
                                             d_conv=jcfg.mamba_d_conv),
                params=sum(p.numel() for p in jamba.parameters()), cfg_param_count=jcfg.param_count(),
                init_peak_gib=peak_gib())
    jtoks = torch.randint(0, jcfg.vocab, (1, 68), generator=gen, device="cuda", dtype=torch.int32)
    jerr16, jscale16 = carried_error(torch, jamba, jtoks, 64)
    if jerr16 > CARRY_TOL["bfloat16"]:
        fail("recurrent_path", f"{HYB_ARCH} bfloat16: decode after a prefill of 64: {jerr16} > {CARRY_TOL}")
    jprompts, _ = recurrent_requests(np, jcfg.vocab, 8, 16, 256, 22)
    jscfg = ServeConfig(max_new_tokens=16, temperature=0.0)
    jeng = ServeEngine(jamba, jscfg)
    jfirst, jstreams, jrefills, _ = timed_serve(torch, jeng, jprompts, 4)
    check_streams(jstreams, [jscfg.max_new_tokens] * len(jstreams), jscfg.eos_id, "jamba serve", "recurrent_path")
    jwall, again, _, _ = timed_serve(torch, jeng, jprompts, 4)
    if [a.tolist() for a in again] != [s.tolist() for s in jstreams]:
        fail("recurrent_path", "jamba: a warm serve() gave other greedy streams")
    jstep_ms, jstep_ops = decode_rate(torch, jamba, torch.from_numpy(jprompts[0]).cuda(), 4)
    jgen = sum(len(s) for s in jstreams)
    jout["bfloat16"] = dict(
        carried=dict(prefill=64, decode_steps=4, rel_err=jerr16, logits_max=jscale16, tol=CARRY_TOL["bfloat16"]),
        serve=dict(requests=len(jprompts), slots=4, max_new_tokens=jscfg.max_new_tokens,
                   prompt_tokens=int(sum(map(len, jprompts))), tokens_generated=jgen, refills=jrefills,
                   first_s=jfirst, warm_wall_s=jwall, tokens_per_s=jgen / jwall),
        prefill_ms_256=prefill_ms(torch, jamba, torch.randint(0, jcfg.vocab, (256,), generator=gen, device="cuda",
                                                              dtype=torch.int32), 288),
        decode_step_ms_4_lanes=jstep_ms, decode_step_aten_ops=jstep_ops, peak_mem_gib=peak_gib())
    del jamba, jeng
    lap("jamba_bf16")

    # float32, 2 experts: the carried state at 1e-4, and serve() against generate()
    fresh()
    j32 = Model(dataclasses.replace(jcfg, dtype="float32", moe_experts=HYB_EXPERTS_F32), seed=24)
    jerr32, jscale32 = carried_error(torch, j32, jtoks, 64)
    if jerr32 > CARRY_TOL["float32"]:
        fail("recurrent_path", f"{HYB_ARCH} float32: decode after a prefill of 64: {jerr32} > {CARRY_TOL}")
    jeng32 = ServeEngine(j32, ServeConfig(max_new_tokens=8, temperature=0.0))
    jshort = [p[:64] for p in jprompts[:4]]
    _, jstreams32, _, _ = timed_serve(torch, jeng32, jshort, 4)
    differ = streams_equal_generate(jeng32, jstreams32, jshort)
    if differ:
        fail("recurrent_path", f"{HYB_ARCH} float32: serve() streams of requests {differ} differ from generate()")
    jout["float32"] = dict(params=sum(p.numel() for p in j32.parameters()),
                           carried=dict(prefill=64, decode_steps=4, rel_err=jerr32, logits_max=jscale32,
                                        tol=CARRY_TOL["float32"]),
                           streams_equal_generate=len(jshort), peak_mem_gib=peak_gib())
    out["jamba"] = jout
    del j32, jeng32
    torch.cuda.empty_cache()
    lap("jamba_float32")

    # 3. the reduced models in float32, card against CPU: loss, every
    # gradient leaf, three AdamW steps' losses and norms
    card_cpu = []
    toc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    for arch, over in ((HYB_ARCH, dict(n_layers=16)), (REC_ARCH, {})):
        rcfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32", **over)
        r = np.random.default_rng(32)
        t2 = torch.from_numpy(r.integers(0, rcfg.vocab, (2, 32)).astype(np.int32))
        b = {"tokens": t2, "labels": torch.roll(t2, -1, 1)}
        cpu = Model(rcfg, device="cpu", seed=7)
        card = Model(rcfg, device="cuda", params=cpu.state_dict())
        loss_c, _, g_cpu = train_grads(torch, cpu, b)
        loss_g, _, g_card = train_grads(torch, card, b)
        gerr = max(leaf_grad_errors(torch, g_card, g_cpu).values())
        lerr = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
        runs = three_steps(torch, (cpu, card), rcfg.vocab, toc, init_all, make_train_step)
        serr = float(np.max(np.abs(np.array(runs[1]) - np.array(runs[0])) / np.abs(np.array(runs[0]))))
        if gerr > TRAIN_GRAD_TOL or lerr > TRAIN_STEP_TOL or serr > TRAIN_STEP_TOL:
            fail("recurrent_path", f"reduced {arch} {over}: card against CPU loss {lerr}, gradients {gerr}, "
                                   f"steps {serr}")
        card_cpu.append(dict(arch=arch, overrides=over, tokens=[2, 32], loss_rel_err=lerr, grad_rel_err=gerr,
                             grad_tol=TRAIN_GRAD_TOL, steps_rel_err=serr, steps_tol=TRAIN_STEP_TOL))
    out["card_vs_cpu"] = card_cpu
    lap("card_vs_cpu")
    torch.cuda.empty_cache()
    launches = build.counts()
    emit({"phase": "recurrent_path", "ok": True, **out, "launches": launches,
          "phase_s": time.perf_counter() - t_phase})
    return launches


# ------------------------------------------------------------ the audio family
AUDIO_ARCH = "whisper-tiny"
#: the serving mix: requests of 64-token prompts, each with its own 1500
#: frames, 32 greedy tokens each, generated as one batch (the reference
#: serves whisper only through ``generate`` with its frames)
AUDIO_REQUESTS, AUDIO_PROMPT, AUDIO_NEW = 32, 64, 32
#: prefill_32k's and decode_32k's shapes: 32 rows of 32 768 tokens; 128
#: lanes on a 32 768-position cache (K and V 25.8 GB in bfloat16)
AUDIO_PREFILL = (32, 32768)
AUDIO_DECODE = (128, 32768)
#: the driver's rows at train_4k's 4096 tokens (train_4k's global batch of
#: 256 cut to one card), the first that fits: on an NVIDIA H100 80GB HBM3
#: at 700 W, 8 rows peaked at 38.6 GiB (~4.7 GB a row, most of it the
#: float32 loss over 51 865-wide logits), 14 at 66.5 GiB, and 16 did not fit
AUDIO_TRAIN_SEQ, AUDIO_TRAIN_BATCHES = 4096, (14, 12, 8)
#: the memorization batch: rows x tokens 0 .. n-1, on one set of frames
AUDIO_MEMORIZE = (4, 1024)


def audio_frames(torch, gen, rows, cfg, dtype):
    """``rows`` sets of the encoder's input, (rows, 1500, d_model), drawn on the card."""
    return torch.randn((rows, cfg.enc_positions, cfg.d_model), generator=gen, device="cuda").to(dtype)


def timed_generate(torch, eng, prompts, frames):
    """One ``generate()`` on the host clock to a sync: (seconds, streams)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    streams = eng.generate(prompts, extras={"frames": frames})
    torch.cuda.synchronize()
    return time.perf_counter() - t, streams


def phase_audio_path(torch, core, build):
    """whisper-tiny at full width on the card (4 + 4 layers, d_model 384,
    vocab 51 865, 1500 frames; seeded weights): on its float32 copy the
    carried self-attention cache against prefills and a batch of
    ``generate()`` streams against each request alone; in bfloat16
    ``generate()`` of 32 requests with their frames, the prefill at
    prefill_32k's shape and the decode step at decode_32k's, 15
    memorization steps, one profiled and one counted train step, the
    ``launch.train`` driver at 4096 tokens; each timed run beside the
    dry-run's counted roofline terms at its own shape; the reduced whisper
    on the card against the CPU."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import synthetic_batch
    from repro_torch.launch import train as launch_train
    from repro_torch.models import Model
    from repro_torch.optim import OptConfig
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.train import init_all, make_train_step

    build.reset_counts()
    t_phase = time.perf_counter()
    out = {"seconds": {}, "device": nvidia_smi()}

    def lap(part):
        out["seconds"][part] = time.perf_counter() - t_phase - sum(out["seconds"].values())

    def fresh():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30

    # 1. the float32 copy: the carried self-attention cache against prefills
    # of the same prefix on one set of frames, and generate() of a batch
    # against each request alone
    cfg = get_arch(AUDIO_ARCH)
    fresh()
    model = Model(cfg, seed=22)
    m32 = Model(dataclasses.replace(cfg, dtype="float32"), params={k: v.float() for k, v in model.state_dict().items()})
    gen = torch.Generator(device="cuda").manual_seed(22)
    toks = torch.randint(0, cfg.vocab, (1, 72), generator=gen, device="cuda", dtype=torch.int32)
    f1 = audio_frames(torch, gen, 1, cfg, torch.float32)
    err32, scale32 = carried_error(torch, m32, toks, 64, {"frames": f1})
    err16, scale16 = carried_error(torch, model, toks, 64, {"frames": f1.to(torch.bfloat16)})  # printed, not held
    if err32 > CARRY_TOL["float32"]:
        fail("audio_path", f"{AUDIO_ARCH}: decode after a prefill of 64 against prefills of 65..72: float32 "
                           f"{err32} > {CARRY_TOL['float32']}")
    eng32 = ServeEngine(m32, ServeConfig(max_new_tokens=16, temperature=0.0))
    p8 = torch.randint(0, cfg.vocab, (8, AUDIO_PROMPT), generator=gen, device="cuda", dtype=torch.int32)
    f8 = audio_frames(torch, gen, 8, cfg, torch.float32)
    batch8 = eng32.generate(p8, extras={"frames": f8})
    alone = [eng32.generate(p8[i:i + 1], extras={"frames": f8[i:i + 1]})[0] for i in range(8)]
    differ = [i for i in range(8) if not torch.equal(batch8[i], alone[i])]
    if differ:
        fail("audio_path", f"{AUDIO_ARCH} float32: generate() of requests {differ} in a batch differs from alone")
    out["whisper"] = dict(arch=cfg.name, enc_layers=cfg.enc_layers, n_layers=cfg.n_layers, d_model=cfg.d_model,
                          n_heads=cfg.n_heads, d_ff=cfg.d_ff, vocab=cfg.vocab, frames=cfg.enc_positions,
                          params=sum(p.numel() for p in model.parameters()), cfg_param_count=cfg.param_count(),
                          carried=dict(prefill=64, decode_steps=8, float32_rel_err=err32, bfloat16_rel_err=err16,
                                       logits_max=scale32, bf16_logits_max=scale16, tol=CARRY_TOL["float32"]),
                          float32_batch_equals_alone=8)
    del m32, eng32
    lap("float32_checks")

    # 2. bfloat16 serving: generate() of 32 requests, each with its frames
    fresh()
    eng = ServeEngine(model, ServeConfig(max_new_tokens=AUDIO_NEW, temperature=0.0))
    prompts = torch.randint(0, cfg.vocab, (AUDIO_REQUESTS, AUDIO_PROMPT), generator=gen, device="cuda",
                            dtype=torch.int32)
    frames = audio_frames(torch, gen, AUDIO_REQUESTS, cfg, torch.bfloat16)
    first_s, streams = timed_generate(torch, eng, prompts, frames)
    if tuple(streams.shape) != (AUDIO_REQUESTS, AUDIO_NEW) or not bool(((streams >= 0) & (streams < cfg.vocab)).all()):
        fail("audio_path", f"generate(): streams of shape {tuple(streams.shape)} or ids outside the vocabulary")
    walls = []
    for _ in range(3):
        wall, again = timed_generate(torch, eng, prompts, frames)
        walls.append(wall)
        if not torch.equal(again, streams):
            fail("audio_path", "a warm generate() gave other greedy streams")
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.start()
    profiled_s, _ = timed_generate(torch, eng, prompts, frames)
    prof.stop()
    split = device_split(torch, prof)
    busy_ms = sum(ms for ms, _ in split.values())
    top = sorted(((ms, k, c) for k, (ms, c) in split.items()), reverse=True)[:8]
    wall = statistics.median(walls)
    generated = AUDIO_REQUESTS * AUDIO_NEW
    out["whisper"]["generate"] = dict(
        requests=AUDIO_REQUESTS, prompt_tokens=AUDIO_PROMPT, frames=cfg.enc_positions, max_new_tokens=AUDIO_NEW,
        first_s=first_s, walls_s=walls, wall_s=wall, tokens_per_s=generated / wall, profiled_wall_s=profiled_s,
        device_busy_s=busy_ms / 1e3, idle_share=idle_share(busy_ms, profiled_s * 1e3),
        top=[dict(op=k[:80], ms=ms, calls=c) for ms, k, c in top], peak_mem_gib=peak_gib())
    del eng, prof, split
    lap("generate")

    # 3. the prefill at prefill_32k's shape: 32 rows of 32 768 tokens
    fresh()
    rows, n = AUDIO_PREFILL
    ptoks = torch.randint(0, cfg.vocab, (rows, n), generator=gen, device="cuda", dtype=torch.int32)
    pframes = audio_frames(torch, gen, rows, cfg, torch.bfloat16)
    pre_s = []
    for _ in range(2):  # the first warms the allocator
        torch.cuda.synchronize()
        t = time.perf_counter()
        cache, logits = model.prefill({"tokens": ptoks, "frames": pframes}, cache_len=n)
        torch.cuda.synchronize()
        pre_s.append(time.perf_counter() - t)
        if not bool(torch.isfinite(logits).all()):
            fail("audio_path", f"prefill of {rows} x {n}: logits not finite")
        del cache, logits
    out["whisper"]["prefill_32k"] = dict(rows=rows, tokens=n, walls_s=pre_s, peak_mem_gib=peak_gib(),
                                         roofline=roofline_beside(cfg, ShapeConfig("prefill_32k", n, rows, "prefill"),
                                                                  pre_s[-1], "audio_path"))
    del ptoks, pframes
    lap("prefill_32k")

    # 4. the decode step at decode_32k's shape: 128 lanes on a 32 768-position
    # cache from a 64-token prefill; the step reads the whole cache, masked
    fresh()
    lanes, n = AUDIO_DECODE
    dtoks = torch.randint(0, cfg.vocab, (lanes, 64), generator=gen, device="cuda", dtype=torch.int32)
    cache, logits = model.prefill({"tokens": dtoks, "frames": audio_frames(torch, gen, lanes, cfg, torch.bfloat16)},
                                  cache_len=n)
    tok = logits.argmax(-1).int()
    for _ in range(3):
        logits, cache = model.decode_step(cache, tok)
        tok = logits.argmax(-1).int()
    steps = 16
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(steps):
        logits, cache = model.decode_step(cache, tok)
        tok = logits.argmax(-1).int()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t) / steps
    ops = dispatch_count()
    with ops:
        model.decode_step(cache, tok)
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CUDA])
    torch.cuda.synchronize()
    prof.start()
    t = time.perf_counter()
    model.decode_step(cache, tok)
    torch.cuda.synchronize()
    profiled_s = time.perf_counter() - t
    prof.stop()
    split = device_split(torch, prof)
    busy_ms = sum(ms for ms, _ in split.values())
    top = sorted(((ms, k, c) for k, (ms, c) in split.items()), reverse=True)[:6]
    if not bool(torch.isfinite(logits).all()) or int(cache["pos"]) != 63 + 3 + steps:
        fail("audio_path", f"decode at {lanes} lanes: logits not finite or pos {int(cache['pos'])}")
    cache_gb = sum(cache[k].numel() * cache[k].element_size() for k in ("k", "v", "xk", "xv")) / 1e9
    out["whisper"]["decode_32k"] = dict(lanes=lanes, cache_len=n, step_ms=step_s * 1e3, aten_ops=ops.n,
                                        cache_gb=cache_gb, peak_mem_gib=peak_gib(), profiled_step_s=profiled_s,
                                        device_busy_s=busy_ms / 1e3,
                                        idle_share=idle_share(busy_ms, profiled_s * 1e3),
                                        top=[dict(op=k[:80], ms=ms, calls=c) for ms, k, c in top],
                                        roofline=roofline_beside(cfg, ShapeConfig("decode_32k", n, lanes, "decode"),
                                                                 step_s, "audio_path"))
    del cache, logits, dtoks, prof, split
    lap("decode_32k")

    # 5. bfloat16 training with remat: 15 memorization steps at 4 x 1024
    # tokens on one set of frames, one profiled step and one counted at the
    # driver's shape, then the driver's own 4 steps
    fresh()
    if not cfg.remat:
        fail("audio_path", f"{cfg.name} does not rematerialize")
    oc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=30)
    params, opt = init_all(model, oc)
    step = make_train_step(model, oc)
    rows, n = AUDIO_MEMORIZE
    tokens = torch.arange(n, dtype=torch.int32, device="cuda")[None].repeat(rows, 1)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1),
             "frames": audio_frames(torch, gen, rows, cfg, torch.bfloat16)}
    losses = []
    for _ in range(15):
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
    if not all(map(math.isfinite, losses)) or not losses[-1] < 0.8 * losses[0]:
        fail("audio_path", f"{AUDIO_ARCH} memorization: losses {losses}")
    memorize = dict(tokens=[rows, n], first_loss=losses[0], last_loss=losses[-1], ratio=losses[-1] / losses[0],
                    criterion="last < 0.8 x first")
    del batch
    lap("memorize")
    train = None
    for b in AUDIO_TRAIN_BATCHES:
        fresh()
        tshape = ShapeConfig("audio_path", AUDIO_TRAIN_SEQ, b, "train")
        try:
            data = synthetic_batch(cfg, tshape, 1000)
            params, opt, profiled_s, split, n_ops = profiled_step(torch, step, params, opt, data)
            del data
            dlosses, dwalls = driver_steps(torch, launch_train, cfg, b, AUDIO_TRAIN_SEQ, "audio_path")
        except torch.cuda.OutOfMemoryError:
            print(json.dumps({"audio_path": f"{b} rows of {AUDIO_TRAIN_SEQ} do not fit; fewer"}), flush=True)
            continue
        busy_ms = sum(ms for ms, _ in split.values())
        top = sorted(((ms, k, c) for k, (ms, c) in split.items()), reverse=True)[:8]
        wall = statistics.median(dwalls[1:])
        train = dict(batch=b, seq=AUDIO_TRAIN_SEQ, cut=f"train_4k's global batch 256 -> {b}", memorize=memorize,
                     steps=4, losses=dlosses, step_walls_s=dwalls, step_wall_s=wall,
                     tokens_per_s=b * AUDIO_TRAIN_SEQ / wall, profiled_step_s=profiled_s,
                     device_busy_s=busy_ms / 1e3, idle_share=idle_share(busy_ms, profiled_s * 1e3),
                     aten_ops_a_step=n_ops, top=[dict(op=k[:80], ms=ms, calls=c) for ms, k, c in top],
                     peak_mem_gib=peak_gib(), roofline=roofline_beside(cfg, tshape, wall, "audio_path"))
        break
    if train is None:
        fail("audio_path", f"no batch of {AUDIO_TRAIN_BATCHES} rows fits at {AUDIO_TRAIN_SEQ} tokens")
    out["whisper"]["train"] = train
    del model, params, opt, step
    torch.cuda.empty_cache()
    lap("train")

    # 6. the reduced whisper in float32, card against CPU, inputs made on
    # the CPU: loss, every gradient leaf, three AdamW steps' losses and
    # norms, and generate() streams
    rcfg = dataclasses.replace(get_arch(AUDIO_ARCH).reduced(), dtype="float32")
    r = np.random.default_rng(33)

    def frames_of(rows):
        return torch.from_numpy(r.standard_normal((rows, rcfg.enc_positions, rcfg.d_model)).astype(np.float32))

    t2 = torch.from_numpy(r.integers(0, rcfg.vocab, (2, 32)).astype(np.int32))
    b2 = {"tokens": t2, "labels": torch.roll(t2, -1, 1), "frames": frames_of(2)}
    cpu = Model(rcfg, device="cpu", seed=7)
    card = Model(rcfg, device="cuda", params=cpu.state_dict())
    loss_c, _, g_cpu = train_grads(torch, cpu, b2)
    loss_g, _, g_card = train_grads(torch, card, b2)
    gerr = max(leaf_grad_errors(torch, g_card, g_cpu).values())
    lerr = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
    toc = OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    runs = three_steps(torch, (cpu, card), rcfg.vocab, toc, init_all, make_train_step,
                       extras=[{"frames": frames_of(4)} for _ in range(3)])
    serr = float(np.max(np.abs(np.array(runs[1]) - np.array(runs[0])) / np.abs(np.array(runs[0]))))
    gp = torch.from_numpy(r.integers(0, rcfg.vocab, (4, 12)).astype(np.int32))
    gf = frames_of(4)
    kw = ServeConfig(max_new_tokens=16, temperature=0.0, eos_id=rcfg.vocab)  # no EOS: every budget runs out
    s_card = ServeEngine(card, kw).generate(gp, extras={"frames": gf}).cpu()
    s_cpu = ServeEngine(cpu, kw).generate(gp, extras={"frames": gf})
    if gerr > TRAIN_GRAD_TOL or lerr > TRAIN_STEP_TOL or serr > TRAIN_STEP_TOL or not torch.equal(s_card, s_cpu):
        fail("audio_path", f"reduced {AUDIO_ARCH}: card against CPU loss {lerr}, gradients {gerr}, steps {serr}, "
                           f"streams equal {torch.equal(s_card, s_cpu)}")
    out["card_vs_cpu"] = dict(arch=AUDIO_ARCH, tokens=[2, 32], frames=rcfg.enc_positions, loss_rel_err=lerr,
                              grad_rel_err=gerr, grad_tol=TRAIN_GRAD_TOL, steps_rel_err=serr,
                              steps_tol=TRAIN_STEP_TOL, generate_streams_equal=True)
    lap("card_vs_cpu")
    torch.cuda.empty_cache()
    launches = build.counts()
    emit({"phase": "audio_path", "ok": True, **out, "launches": launches, "phase_s": time.perf_counter() - t_phase})
    return launches


def adversarial(p, n_p):
    import numpy as np

    return np.repeat((np.arange(p, dtype=np.int32) * 1000)[:, None], n_p, axis=1)


# ---------------------------------------------------------- sharded_path
#: one processor a rank: main_path's 2^23 keys on 4 ranks
SHARD = dict(p=4, n_per_proc=2**21)
#: (run, config, distribution, payloads): the checked sorts of every rank
SHARD_RUNS = (("det U", SLICE, "U", 0), ("det DD", SLICE, "DD", 0), ("det U+payload", SLICE, "U", 1),
              ("iran U", IRAN, "U", 0), ("bitonic U", dict(algorithm="bitonic", local_sort="bitonic"), "U", 0))
#: the MoE at granite-moe-1b-a400m's widths: (data, model) mesh, global
#: tokens (B, S), decode lanes; the biased router's lean on model shard 0
SHARD_MOE = dict(mesh=(2, 2), tokens=(4, 4096), lanes=8, bias=0.02)
SHARD_MOE_TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def shard_inputs(core, p, n_p, dist, nv):
    """(p, n_p) int32 keys (and an int32 payload) on the host, from a seed:
    every rank makes the same and keeps its row."""
    import numpy as np

    x = adversarial(p, n_p) if dist == "adversarial" else core.datagen.generate(dist, p, n_p)
    vals = [np.arange(p * n_p, dtype=np.int32).reshape(p, n_p)][:nv]
    return x, vals


def row_digest(torch, res, pvals, r):
    """sha256 of processor r's row of a result: buffer, count, payloads."""
    import hashlib

    h = hashlib.sha256()
    for t in (res.buf[r], res.count[r:r + 1], *[v[r] for v in pvals]):
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def moe_dense(torch, moe, params, x, k):
    """Every expert on every token, weighted by the router (the reference's
    own check of its EP paths)."""
    x2d = x.reshape(-1, x.shape[-1])
    probs, experts, _ = moe._router(x2d, params["router"], k)
    y = torch.zeros_like(x2d)
    for e in range(params["w_gate"].shape[0]):
        w = (probs * (experts == e)).sum(-1).to(x.dtype)
        y = y + w[:, None] * moe._expert_ffn(x2d, params["w_gate"][e], params["w_up"][e], params["w_down"][e])
    return y.reshape(x.shape)


def moe_error(torch, y, want, dtype):
    """Max error of ``y`` against the dense evaluation: float32 over 1e-4 of
    the largest |y| must stay below 1; bfloat16 the largest excess over
    3e-2 + 3e-2 |want| (``assert_allclose``'s rule) must be 0."""
    d = (y.float() - want.float()).abs()
    if dtype == "float32":
        return dict(max_abs_err=float(d.max()), tol=SHARD_MOE_TOL[dtype] * float(want.float().abs().max()))
    excess = d - SHARD_MOE_TOL[dtype] * (1 + want.float().abs())
    return dict(max_abs_err=float(d.max()), tol=SHARD_MOE_TOL[dtype], excess=float(excess.max().clamp(min=0)))


@contextlib.contextmanager
def collective_clock(dist, sync):
    """Host ms and calls of each ``torch.distributed`` collective the
    processor groups call, each timed from a synchronized card to its end
    on the card (the profiler gives gloo's CUDA work no time)."""
    spent = {}
    names = ("all_to_all_single", "all_gather", "all_reduce", "broadcast")
    originals = {name: getattr(dist, name) for name in names}

    def clocked(name, fn):
        def call(*args, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sync()
            ms, calls = spent.get(name, (0.0, 0))
            spent[name] = (ms + (time.perf_counter() - t0) * 1e3, calls + 1)
            return out

        return call

    for name, fn in originals.items():
        setattr(dist, name, clocked(name, fn))
    try:
        yield spent
    finally:
        for name, fn in originals.items():
            setattr(dist, name, fn)


def sharded_rank(rank, n, spec):
    """One rank of ``sharded_path``: its row of each checked sort (digests,
    tiers), the kernels it launched, the adversarial escalation, warm walls,
    one profiled sort's all_to_all share (rank 0), then the MoE's mesh paths
    at granite's widths against the dense evaluation of its tokens."""
    import dataclasses

    import torch
    import torch.distributed as dist

    import repro_torch.core as core
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build as build
    from repro_torch.launch.mesh import make_mesh, mesh_device
    from repro_torch.models import moe

    kind = spec["device"]
    mesh = make_mesh((n,), ("procs",), kind)
    dev = mesh_device(mesh)
    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    n_p = spec["n_per_proc"]
    out = dict(rank=rank, device=str(dev), backend=dist.get_backend(), runs=[])
    rows = {}
    build.reset_counts()
    for name, kw, dist_name, nv in SHARD_RUNS:
        x, vals = shard_inputs(core, n, n_p, dist_name, nv)
        row = torch.from_numpy(x[rank:rank + 1]).to(dev)
        rv = [torch.from_numpy(v[rank:rank + 1]).to(dev) for v in vals]
        cfg = core.SortConfig(p=n, n_per_proc=n_p, **kw)
        res, pvals, st = core.bsp_sort_sharded_safe(row, mesh, "procs", cfg, values=rv)
        rows[name] = (row, rv, cfg)
        out["runs"].append(dict(run=name, digest=row_digest(torch, res, pvals, 0), tiers=st.as_row()))
    sync()
    out["launches"] = build.counts()  # the checked runs only

    x, _ = shard_inputs(core, n, n_p, "adversarial", 0)
    ex = core.SortExecutor()
    cfg = core.SortConfig(p=n, n_per_proc=n_p, algorithm="iran", pair_capacity="whp")
    res, _, st = core.bsp_sort_sharded_safe(torch.from_numpy(x[rank:rank + 1]).to(dev), mesh, "procs", cfg,
                                            executor=ex)
    out["adversarial"] = dict(digest=row_digest(torch, res, [], 0), tiers=st.as_row(),
                              prepare_entries=sum(k[0] == "prepare" for k in ex.trace_counts))

    # warm walls with every rank starting together, then one profiled run
    row, rv, cfg = rows["det U+payload"]
    walls = []
    for _ in range(5):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        core.bsp_sort_sharded_safe(row, mesh, "procs", cfg, values=rv)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["sort_walls_ms"] = walls
    out["sort_wall_ms"] = statistics.median(walls)
    if rank == 0:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        dist.barrier()
        with profile(activities=acts) as prof, collective_clock(dist, sync) as coll:
            sync()
            t0 = time.perf_counter()
            core.bsp_sort_sharded_safe(row, mesh, "procs", cfg, values=rv)
            sync()
            prof_ms = (time.perf_counter() - t0) * 1e3
        a2a = coll.get("all_to_all_single", (0.0, 0))[0]
        busy = sum(v[0] for v in device_split(torch, prof).values()) if on_card else None
        out["profiled"] = dict(wall_ms=prof_ms, all_to_all_ms=a2a, all_to_all_share=a2a / prof_ms,
                               collectives={k: dict(ms=ms, calls=c) for k, (ms, c) in coll.items()},
                               device_busy_ms=busy, idle_share=None if busy is None else idle_share(busy, prof_ms))
    else:
        dist.barrier()
        core.bsp_sort_sharded_safe(row, mesh, "procs", cfg, values=rv)
    sync()

    # the MoE's mesh paths at granite's widths, every check on this rank's block
    m = spec["moe"]
    moe_mesh = make_mesh(m["mesh"], ("data", "model"), kind)
    mi = moe.MoEMeshInfo(mesh=moe_mesh, model_axis="model", data_axes=("data",))
    arch = dataclasses.replace(get_arch(LM_ARCH), **m.get("widths", {}))  # widths: a CPU rehearsal's cut
    gen = torch.Generator().manual_seed(23)
    full32 = moe.init_moe(gen, dataclasses.replace(arch, dtype="float32"))
    B, S = m["tokens"]
    tokens = torch.randn((B, S, arch.d_model), generator=gen)
    lanes = torch.randn((m["lanes"], 1, arch.d_model), generator=gen)
    checks = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(arch, dtype=dtype)
        dt = getattr(torch, dtype)
        full = {k: v.to(dev, torch.float32 if k == "router" else dt) for k, v in full32.items()}
        ep = moe.expert_block(full, mi)
        for path, x_all, seq in (("moe_ep", tokens, True), ("moe_tp_sharded", tokens, False),
                                 ("moe_ep_decode", lanes, False)):
            xl = moe.token_block(x_all, mi, seq_shard=seq).to(dev, dt)
            if path == "moe_ep":
                y, aux = moe.moe_ep(ep, xl, cfg, mi, capacity_factor=1.25)
            elif path == "moe_tp_sharded":
                y, aux = moe.moe_tp_sharded(moe.ffn_block(full, mi), xl, cfg, mi, capacity_factor=2.0)
            else:
                y, aux = moe.moe_ep_decode(ep, xl, cfg, mi)
            want = moe_dense(torch, moe, full, xl, arch.moe_top_k)
            checks[f"{path} {dtype}"] = dict(tokens=list(xl.shape[:2]), overflow=bool(aux["overflow"]),
                                             **moe_error(torch, y, want, dtype))
    cfg = dataclasses.replace(arch, dtype="float32")
    full = {k: v.to(dev) for k, v in full32.items()}
    full["router"] = full["router"].clone()
    full["router"][:, : arch.moe_experts // mi.model_size] += m["bias"]
    xl = moe.token_block(tokens + 1.0, mi, seq_shard=True).to(dev)
    stats = core.TierStats()
    y, aux, _ = moe.moe_ep_safe(moe.expert_block(full, mi), xl, cfg, mi, capacity_factor=1.25, stats=stats)
    checks["moe_ep_safe biased float32"] = dict(tiers=stats.as_row(), overflow=bool(aux["overflow"]),
                                                **moe_error(torch, y, moe_dense(torch, moe, full, xl, arch.moe_top_k),
                                                            "float32"))
    out["moe"] = checks
    x = moe.token_block(tokens, mi, seq_shard=True).to(dev, torch.bfloat16)
    ep = moe.expert_block({k: v.to(dev, torch.float32 if k == "router" else torch.bfloat16)
                           for k, v in full32.items()}, mi)
    walls = []
    for _ in range(5):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        moe.moe_ep(ep, x, arch, mi, capacity_factor=1.25)
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["moe_ep_walls_ms"] = walls
    out["moe_ep_wall_ms"] = statistics.median(walls)
    dist.barrier()
    with collective_clock(dist, sync) if rank == 0 else contextlib.nullcontext({}) as coll:
        sync()
        t0 = time.perf_counter()
        moe.moe_ep(ep, x, arch, mi, capacity_factor=1.25)
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    if rank == 0:
        a2a = coll.get("all_to_all_single", (0.0, 0))[0]
        out["moe_ep_clocked"] = dict(wall_ms=wall, all_to_all_ms=a2a, all_to_all_share=a2a / wall,
                                     collectives={k: dict(ms=ms, calls=c) for k, (ms, c) in coll.items()})
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else None
    return out


def sharded_world(torch, core, build, n, backend, device, n_p, moe_spec):
    """Run ``sharded_rank`` on ``n`` ranks and hold each against the
    single-process sorts on the same device; returns (line, launches)."""
    from repro_torch.launch.mesh import spawn

    dev = torch.device(device)
    want, tiers = {}, {}
    for name, kw, dist_name, nv in (*SHARD_RUNS, ("adversarial", dict(algorithm="iran", pair_capacity="whp"),
                                                  "adversarial", 0)):
        x, vals = shard_inputs(core, n, n_p, dist_name, nv)
        xt, vt = torch.from_numpy(x).to(dev), [torch.from_numpy(v).to(dev) for v in vals]
        res, pvals, st = core.bsp_sort_safe(xt, core.SortConfig(p=n, n_per_proc=n_p, **kw), values=vt, device=dev)
        check_sort(torch, core, xt, vt, res, pvals, st, "sharded_path", f"{name} on one process")
        want[name] = [row_digest(torch, res, pvals, r) for r in range(n)]
        tiers[name] = st.as_row()
    t0 = time.perf_counter()
    ranks = spawn(sharded_rank, n, backend=backend, device=device,
                  args=(dict(device=device, n_per_proc=n_p, moe=dict(moe_spec, mesh=(1, 1) if n == 1 else
                                                                       moe_spec["mesh"])),))
    spawn_s = time.perf_counter() - t0
    what = f"{backend} x{n}"
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    for r in ranks:
        if r["device"].split(":")[0] != device or r["backend"] != backend:
            fail("sharded_path", f"{what}: rank {r['rank']} ran on {r['device']} over {r['backend']}")
        for got in r["runs"]:
            if got["digest"] != want[got["run"]][r["rank"]]:
                fail("sharded_path", f"{what}: rank {r['rank']}'s row of {got['run']} differs from bsp_sort_safe's")
            if got["tiers"] != tiers[got["run"]]:
                fail("sharded_path", f"{what}: {got['run']} walked {got['tiers']}, bsp_sort_safe {tiers[got['run']]}")
        adv = r["adversarial"]
        # one processor cannot overflow: the escalation needs two or more
        if adv["digest"] != want["adversarial"][r["rank"]] or adv["prepare_entries"] != 1 \
                or (n > 1 and adv["tiers"]["retries"] < 1):
            fail("sharded_path", f"{what}: adversarial escalation {adv}")
        for path, c in r["moe"].items():
            if c["overflow"] or (c["max_abs_err"] > c["tol"] if "excess" not in c else c["excess"] > 0):
                fail("sharded_path", f"{what}: rank {r['rank']} {path} {c}")
        safe = r["moe"]["moe_ep_safe biased float32"]["tiers"]
        if n > 1 and (safe["retries"] < 1 or safe.get("ok_full") != 1):
            fail("sharded_path", f"{what}: moe_ep_safe did not climb past whp: {safe}")
        if device == "cuda":
            # every rank launches the path's kernels; one processor receives
            # one run and merges nothing, so a world of one launches K1 only
            require_launched(r["launches"], KERNEL_NAMES[:3] if n > 1 else KERNEL_NAMES[:1], "sharded_path",
                             f"{what} rank {r['rank']}")
        for name in KERNEL_NAMES:
            launches[name] += r["launches"].get(name, 0)
    line = dict(phase="sharded_path", ok=True, backend=backend, ranks=n, n_per_proc=n_p, spawn_and_run_s=spawn_s,
                transport=("gloo through the host, every rank on one card: says nothing of NVLink"
                           if backend == "gloo" else "NCCL in a world of one: its calls move no bytes between cards"),
                runs={r: tiers[r] for r in tiers}, launches=launches,
                rank_launches=[{k: v for k, v in r["launches"].items() if v} for r in ranks],
                sort_wall_ms=[r["sort_wall_ms"] for r in ranks], moe_ep_wall_ms=[r["moe_ep_wall_ms"] for r in ranks],
                peak_mem_gib=[r["peak_mem_gib"] for r in ranks], profiled=ranks[0]["profiled"],
                moe_ep_clocked=ranks[0]["moe_ep_clocked"],
                moe={path: [r["moe"][path] for r in ranks] for path in ranks[0]["moe"]},
                adversarial=ranks[0]["adversarial"]["tiers"])
    return line, launches


def phase_sharded_path(torch, core, build, device="cuda", n_p=SHARD["n_per_proc"], moe_spec=SHARD_MOE):
    """The multi-process runner: 4 gloo ranks sharing the card, then a world
    of one over NCCL (gloo on the host in a CPU rehearsal, with ``n_p`` and
    ``moe_spec`` cut)."""
    t_phase = time.perf_counter()
    worlds, launches = [], dict.fromkeys(KERNEL_NAMES, 0)
    for n, backend in ((SHARD["p"], "gloo"), (1, "nccl" if device == "cuda" else "gloo")):
        line, counted = sharded_world(torch, core, build, n, backend, device, n_p, moe_spec)
        emit(line)  # one line a world, as it ends
        worlds.append(dict(backend=backend, ranks=n, spawn_and_run_s=line["spawn_and_run_s"],
                           sort_wall_ms=line["sort_wall_ms"], moe_ep_wall_ms=line["moe_ep_wall_ms"],
                           all_to_all_share=line["profiled"]["all_to_all_share"],
                           moe_ep_all_to_all_share=line["moe_ep_clocked"]["all_to_all_share"],
                           peak_mem_gib=line["peak_mem_gib"]))
        for name in KERNEL_NAMES:
            launches[name] += counted[name]
    emit({"phase": "sharded_path", "ok": True, "config": dict(SHARD, **SLICE), "runs": [r[0] for r in SHARD_RUNS],
          "moe": dict(moe_spec, arch=LM_ARCH), "worlds": worlds, "launches": launches,
          "nvidia_smi": nvidia_smi() if device == "cuda" else None, "phase_s": time.perf_counter() - t_phase})
    return launches


# ------------------------------------------------------------- mesh_path
#: the mesh half: 4 gloo ranks sharing the card as a (data 2, model 2)
#: mesh. Parity in float32 at published widths cut to ``parity_layers``
#: layers: (arch, train policy, serving policy); then granite at full depth
#: in bf16 with remat: the train batch (B, S) (one step), the prefill
#: (B, S) and decode (lanes, cache)
MESH_SPEC = dict(mesh=(2, 2), parity_layers=2, parity_train=(4, 256), parity_prefill=(4, 256), parity_lanes=4,
                 decode_steps=3, parity=((LM_ARCH, "1d", "1d"), (DENSE_ARCH, "dp", "1d")),
                 train=(4, 4096), prefill=(8, 512), decode=(8, 1024), full_layers=8, reduced=False)
#: the mesh's float32 parity with the one-process step on the card,
#: relative to each leaf's (or the logits') largest magnitude
MESH_TOL = 1e-4
#: the parity step's AdamW: eps 1 makes its first update about lr · g, where
#: the default eps gives about lr · sign(g) whatever |g| (an element whose
#: gradient is rounding noise would move by lr either way)
MESH_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1.0)


class HostSplit:
    """Where one step's wall goes on the host, with no sync added. A
    dispatch mode counts the aten ops the step dispatches (a ``DTensor`` op
    counted as the local ops it becomes; views included, as
    ``dispatch_count`` counts) and times each on the host's clock, split
    in three: the collectives (the ``c10d`` ops, each ``wait_tensor`` of
    ``DTensor``'s, and ``torch.distributed``'s own calls timed whole,
    their wait included), the host reads (``_local_scalar_dense`` and
    copies from the card to the host: ``.item()``, ``.tolist()``,
    ``bool()``), each waiting for the card to reach it, and every other
    op (its dispatch and launch). What is left of the wall is Python
    outside the ops. Each collective's ms, calls and bytes (of its
    largest buffer) are kept by name."""

    NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
    DIST = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor", "all_to_all_single", "all_gather",
            "broadcast", "barrier")

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        split = self
        self.ops, self.depth, self.t0 = 0, 0, 0.0
        self.ms = dict(collectives=0.0, host_reads=0.0, other_ops=0.0)
        self.calls = dict(collectives=0, host_reads=0)
        self.by = {}  # collective -> [ms, calls, bytes of its largest buffer]

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor

                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                split.ops += 1
                if split.depth:  # inside a timed torch.distributed call
                    return func(*args, **(kwargs or {}))
                t0 = time.perf_counter()
                out = func(*args, **(kwargs or {}))
                ms = (time.perf_counter() - t0) * 1e3
                if func.namespace in split.NAMESPACES:
                    kind = "collectives"
                    split.add(func.overloadpacket.__name__, ms, args)
                elif split.host_read(func, args, out):
                    kind = "host_reads"
                else:
                    kind = "other_ops"
                split.ms[kind] += ms
                if kind in split.calls:
                    split.calls[kind] += 1
                return out

        self.mode = Mode()

    @staticmethod
    def host_read(func, args, out) -> bool:
        import torch

        if func.__name__.startswith("_local_scalar_dense"):
            return True
        return (isinstance(out, torch.Tensor) and out.device.type == "cpu"
                and any(isinstance(a, torch.Tensor) and a.device.type == "cuda" for a in args))

    def add(self, name: str, ms: float, args) -> None:
        import torch

        flat = [a for x in args for a in (x if isinstance(x, (list, tuple)) else [x])]
        nbytes = max([a.numel() * a.element_size() for a in flat if isinstance(a, torch.Tensor)] or [0])
        row = self.by.setdefault(name, [0.0, 0, 0])
        row[0] += ms
        row[1] += 1
        row[2] += nbytes

    def _timed(self, fn):
        def call(*args, **kw):
            outer = self.depth == 0
            self.depth += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.depth -= 1
                if outer:
                    ms = (time.perf_counter() - t0) * 1e3
                    self.ms["collectives"] += ms
                    self.calls["collectives"] += 1
                    self.add(fn.__name__, ms, args)
        return call

    def __enter__(self):
        import torch.distributed as dist

        self.saved = {n: getattr(dist, n) for n in self.DIST} if dist.is_initialized() else {}
        for n, fn in self.saved.items():
            setattr(dist, n, self._timed(fn))
        self.mode.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        self.wall_ms = (time.perf_counter() - self.t0) * 1e3
        self.mode.__exit__(*exc)
        for n, fn in self.saved.items():
            setattr(dist, n, fn)

    def row(self) -> dict:
        """The split of the wall (ms): collectives, host reads, the other
        ops' dispatch, Python (the rest); the ops and the calls counted."""
        python = self.wall_ms - sum(self.ms.values())
        return dict(wall_ms=self.wall_ms, aten_ops=self.ops, **{f"{k}_ms": v for k, v in self.ms.items()},
                    python_ms=python, collective_calls=self.calls["collectives"],
                    host_read_calls=self.calls["host_reads"],
                    by_collective={k: dict(ms=v[0], calls=v[1], bytes=v[2]) for k, v in self.by.items()})


def mesh_cfg(torch, spec, arch, **kw):
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = get_arch(arch).reduced() if spec["reduced"] else get_arch(arch)
    return dataclasses.replace(cfg, **kw)


def mesh_full_cfg(torch, spec):
    """The full-width granite of ``mesh_path``'s bf16 steps, cut to
    ``spec["full_layers"]`` layers (at all 24 the phase took 105 s of the
    script's 1200 on an H100)."""
    cfg = mesh_cfg(torch, spec, LM_ARCH)
    return mesh_cfg(torch, spec, LM_ARCH, n_layers=min(cfg.n_layers, spec["full_layers"]))


def mesh_batches(torch, cfg, spec, dev):
    """The parity run's inputs, the same on every rank: train tokens and
    labels, the prompt, the decode tokens."""
    gen = torch.Generator().manual_seed(24)
    b, s = spec["parity_train"]
    toks = torch.randint(0, cfg.vocab, (b, s), generator=gen, dtype=torch.int32)
    prompt = torch.randint(0, cfg.vocab, spec["parity_prefill"], generator=gen, dtype=torch.int32)
    decode = torch.randint(0, cfg.vocab, (spec["decode_steps"], spec["parity_prefill"][0]), generator=gen,
                           dtype=torch.int32)
    return ({"tokens": toks.to(dev), "labels": torch.roll(toks, -1, 1).to(dev)}, prompt.to(dev), decode.to(dev))


def mesh_serve(torch, model, mesh, prompt, decode, cache_len):
    """Prefill, then a decode step per row of ``decode``: the logits of each."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    pre = make_prefill_step(model, mesh, cache_len)
    dec = make_decode_step(model, mesh, prompt.shape[0], cache_len)
    with torch.no_grad():
        cache, logits = pre({"tokens": prompt})
        out = [logits.float()]
        for t in decode:
            logits, cache = dec(cache, t)
            out.append(logits.float())
    return out


def mesh_full(t):
    from repro_torch.models.sharding import full

    return full(t).detach()


def mesh_parity(torch, spec, mesh, dev, rank, arch, policy, serve_policy):
    """One arch's float32 train step and serving on the mesh against the
    same steps in one process (rank 0's): the loss, each updated leaf and
    each logits' largest error over its largest magnitude."""
    from repro_torch.models import Model
    from repro_torch.optim import OptConfig
    from repro_torch.train import init_all, make_train_step

    cfg = mesh_cfg(torch, spec, arch, dtype="float32", n_layers=spec["parity_layers"], param_sharding=policy)
    scfg = mesh_cfg(torch, spec, arch, dtype="float32", n_layers=spec["parity_layers"],
                    param_sharding=serve_policy)
    oc = OptConfig(**MESH_OPT)
    batch, prompt, decode = mesh_batches(torch, cfg, spec, dev)
    cache_len = 2 * prompt.shape[1]
    model = Model(cfg, device=dev, seed=0)
    params, opt = init_all(model, oc, mesh)
    params, opt, met = make_train_step(model, oc, mesh)(params, opt, batch)
    got = {k: mesh_full(p) for k, p in params.items()}
    served = mesh_serve(torch, Model(scfg, device=dev, seed=0), mesh, prompt, decode, cache_len)
    out = dict(arch=arch, policy=policy, serve_policy=serve_policy, loss=float(met["loss"]),
               overflow=bool(met.get("aux_overflow", False)))
    if rank == 0:
        one = Model(cfg, device=dev, seed=0)
        p1, o1 = init_all(one, oc)
        p1, o1, m1 = make_train_step(one, oc)(p1, o1, batch)
        out.update(one_loss=float(m1["loss"]), one_overflow=bool(m1.get("aux_overflow", False)),
                   loss_rel_err=abs(float(met["loss"]) - float(m1["loss"])) / abs(float(m1["loss"])))
        errs = {k: float((got[k].float() - p.detach().float()).abs().max() / p.detach().float().abs().max())
                for k, p in p1.items()}
        out["leaf_worst"] = max(errs.items(), key=lambda kv: kv[1])
        del one, p1, o1
        want = mesh_serve(torch, Model(scfg, device=dev, seed=0), None, prompt, decode, cache_len)
        out["logits_rel_err"] = [float((g - w).abs().max() / w.abs().max()) for g, w in zip(served, want)]
    return out


def mesh_rank(rank, n, spec):
    """One rank of ``mesh_path`` (see the phase)."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import synthetic_batch
    from repro_torch.kernels import _build as build
    from repro_torch.launch.mesh import make_mesh, mesh_device
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import Model
    from repro_torch.optim import OptConfig
    from repro_torch.train import init_all, make_train_step

    mesh = make_mesh(spec["mesh"], ("data", "model"), spec["device"])
    dev = mesh_device(mesh)
    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)
    build.reset_counts()
    out = dict(rank=rank, device=str(dev), backend=dist.get_backend())
    # the collectives DTensor's redistributes need, on this device, first
    probe = {}
    for axis in ("data", "model"):
        g, p = mesh.get_group(axis), mesh.size(mesh.mesh_dim_names.index(axis))
        x = torch.arange(4 * p, dtype=torch.float32, device=dev) + rank
        rs = torch.empty(4, dtype=torch.float32, device=dev)
        dist.reduce_scatter_tensor(rs, x, group=g)
        ag = torch.empty(4 * p, dtype=torch.float32, device=dev)
        dist.all_gather_into_tensor(ag, x[:4].contiguous(), group=g)
        members = dist.get_process_group_ranks(g)
        i = members.index(rank)
        want_rs = sum(torch.arange(4 * p, dtype=torch.float32) + r for r in members)[4 * i: 4 * i + 4]
        want_ag = torch.cat([torch.arange(4, dtype=torch.float32) + r for r in members])
        probe[axis] = dict(reduce_scatter_tensor=bool(torch.equal(rs.cpu(), want_rs)),
                           all_gather_into_tensor=bool(torch.equal(ag.cpu(), want_ag)))
    out["probe"] = probe
    out["parity"] = [mesh_parity(torch, spec, mesh, dev, rank, *p) for p in spec["parity"]]
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)

    # granite at full width (cut to spec["full_layers"]) in bf16 with remat:
    # train, then serve
    cfg = mesh_full_cfg(torch, spec)
    b, s = spec["train"]
    model = Model(cfg, device=dev, seed=0)
    oc = OptConfig()
    params, opt = init_all(model, oc, mesh)
    step = make_train_step(model, oc, mesh)
    shape = ShapeConfig("mesh", s, b, "train")
    # one step, every rank under the profiler (the card's busy time of each
    # rank's own work), rank 0's also under the host split; an eager step
    # compiles nothing, and the parity runs warmed the card for this process
    data = synthetic_batch(cfg, shape, 0, device=dev)
    dist.barrier()
    prof = profile(activities=[ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU])
    sync()
    prof.start()
    host = HostSplit() if rank == 0 else contextlib.nullcontext()
    t0 = time.perf_counter()
    with host:
        params, opt, met = step(params, opt, data)
        loss = float(met["loss"])
    wall = time.perf_counter() - t0
    prof.stop()
    split = device_split(torch, prof) if on_card else {}
    busy = sum(v[0] for v in split.values()) if on_card else None
    out.update(train_wall_s=wall, tokens_per_s=b * s / wall, losses=[loss], device_busy_ms=busy,
               overflow=bool(met.get("aux_overflow", False)))
    if rank == 0:
        top = sorted(((ms, k, c) for k, (ms, c) in split.items()), reverse=True)[:8]
        row = host.row()
        out["profiled"] = dict(wall_s=wall, device_busy_ms=busy,
                               top=[dict(op=k[:80], ms=ms, calls=c) for ms, k, c in top],
                               idle_share=idle_share(busy, wall * 1e3) if on_card else None,
                               collectives_ms=row["collectives_ms"],
                               collectives_share=row["collectives_ms"] / (wall * 1e3), host_split=row)
    out["train_peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else None
    del opt, data
    model.requires_grad_(False)
    pb, ps = spec["prefill"]
    lanes, cache_len = spec["decode"]
    gen = torch.Generator().manual_seed(7)
    prompt = torch.randint(0, cfg.vocab, (pb, ps), generator=gen, dtype=torch.int32).to(dev)
    pre = make_prefill_step(model, mesh, ps)
    with torch.no_grad():
        pre_walls = []
        for _ in range(2):
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            _, logits = pre({"tokens": prompt})
            sync()
            pre_walls.append(time.perf_counter() - t0)
        out["prefill_wall_s"] = statistics.median(pre_walls)
        dprompt = torch.randint(0, cfg.vocab, (lanes, cache_len // 2), generator=gen, dtype=torch.int32).to(dev)
        cache, logits = make_prefill_step(model, mesh, cache_len)({"tokens": dprompt})
        dec = make_decode_step(model, mesh, lanes, cache_len)
        tok = logits.argmax(-1).to(torch.int32)
        dec_walls = []
        for _ in range(spec["decode_steps"] + 1):
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            logits, cache = dec(cache, tok)
            tok = logits.argmax(-1).to(torch.int32)
            sync()
            dec_walls.append(time.perf_counter() - t0)
        out["decode_step_s"] = statistics.median(dec_walls[1:])
        out["logits_finite"] = bool(torch.isfinite(logits).all())
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else None
    out["launches"] = build.counts()
    return out


def mesh_one_process(torch, spec, dev):
    """The same full-width steps in one process on the device: the train
    step at the same global batch (its wall, device busy time and host
    split), prefill and decode walls."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import synthetic_batch
    from repro_torch.models import Model
    from repro_torch.optim import OptConfig
    from repro_torch.train import init_all, make_train_step

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    cfg = mesh_full_cfg(torch, spec)
    b, s = spec["train"]
    model = Model(cfg, device=dev, seed=0)
    oc = OptConfig()
    params, opt = init_all(model, oc)
    step = make_train_step(model, oc)
    shape = ShapeConfig("mesh", s, b, "train")
    # a warm step (the process's first on the card), then the step as the
    # mesh's rank 0 runs it: profiled, under the host split
    params, opt, met = step(params, opt, synthetic_batch(cfg, shape, 0, device=dev))
    float(met["loss"])
    d = synthetic_batch(cfg, shape, 1, device=dev)
    prof = profile(activities=[ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU])
    sync()
    prof.start()
    with HostSplit() as host:
        params, opt, met = step(params, opt, d)
        float(met["loss"])
    prof.stop()
    row = host.row()
    busy = sum(v[0] for v in device_split(torch, prof).values()) if on_card else None
    out = dict(train_wall_s=row["wall_ms"] / 1e3, device_busy_ms=busy, host_split=row,
               idle_share=idle_share(busy, row["wall_ms"]) if on_card else None,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30 if on_card else None)
    out["tokens_per_s"] = b * s / out["train_wall_s"]
    del opt
    model.requires_grad_(False)
    pb, ps = spec["prefill"]
    lanes, cache_len = spec["decode"]
    gen = torch.Generator().manual_seed(7)
    prompt = torch.randint(0, cfg.vocab, (pb, ps), generator=gen, dtype=torch.int32).to(dev)
    with torch.no_grad():
        pre = []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            model.prefill({"tokens": prompt}, cache_len=ps)
            sync()
            pre.append(time.perf_counter() - t0)
        dprompt = torch.randint(0, cfg.vocab, (lanes, cache_len // 2), generator=gen, dtype=torch.int32).to(dev)
        cache, logits = model.prefill({"tokens": dprompt}, cache_len=cache_len)
        tok = logits.argmax(-1).to(torch.int32)
        dec = []
        for _ in range(spec["decode_steps"] + 1):
            sync()
            t0 = time.perf_counter()
            logits, cache = model.decode_step(cache, tok)
            tok = logits.argmax(-1).to(torch.int32)
            sync()
            dec.append(time.perf_counter() - t0)
    out.update(prefill_wall_s=statistics.median(pre), decode_step_s=statistics.median(dec[1:]))
    return out


def phase_mesh_path(torch, core, build, device="cuda", spec=MESH_SPEC):
    """The mesh half over DTensor: 4 gloo ranks on one (data 2, model 2)
    mesh sharing the card (NCCL refuses two ranks of one communicator on
    one card). First the gloo probe of ``reduce_scatter_tensor`` and
    ``all_gather_into_tensor`` on the device's tensors; then the float32
    parity of the mesh's train step, prefill and decode with one process's
    on the device; then granite at full depth in bf16 with remat: train
    walls, tokens/s, peak memory a rank, the collectives' share of one
    profiled rank's wall; prefill and decode walls; the same steps in one
    process beside them. It launches none of K1-K4."""
    from repro_torch.launch.mesh import spawn

    import gc

    t_phase = time.perf_counter()
    dev = torch.device(device)
    one = mesh_one_process(torch, spec, dev)
    # the one-process model's memory back to the card before the four ranks
    # take ~17 GiB each (this process keeps its allocator's cache otherwise)
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    n = spec["mesh"][0] * spec["mesh"][1]
    t0 = time.perf_counter()
    ranks = spawn(mesh_rank, n, backend="gloo", device=device, args=(dict(spec, device=device),))
    spawn_s = time.perf_counter() - t0
    launches = dict.fromkeys(KERNEL_NAMES, 0)
    for r in ranks:
        if r["device"].split(":")[0] != device or r["backend"] != "gloo":
            fail("mesh_path", f"rank {r['rank']} ran on {r['device']} over {r['backend']}")
        bad = {a: ops for a, ops in r["probe"].items() if not all(ops.values())}
        if bad:
            fail("mesh_path", f"rank {r['rank']}: gloo on {device} tensors: {bad}")
        if not all(math.isfinite(x) for x in r["losses"]) or not r["logits_finite"]:
            fail("mesh_path", f"rank {r['rank']}: losses {r['losses']}, logits finite {r['logits_finite']}")
        for name in KERNEL_NAMES:
            launches[name] += r["launches"].get(name, 0)
    for par in ranks[0]["parity"]:
        what = f"{par['arch']} {par['policy']}"
        if par["overflow"] != par["one_overflow"]:
            fail("mesh_path", f"{what}: records dropped {par['overflow']}, one process {par['one_overflow']}")
        if par["loss_rel_err"] > MESH_TOL or par["leaf_worst"][1] > MESH_TOL or max(par["logits_rel_err"]) > MESH_TOL:
            fail("mesh_path", f"{what}: parity with one process {par}")
    if any(launches.values()):
        fail("mesh_path", f"launched {launches}")
    rank_keys = ("train_wall_s", "tokens_per_s", "train_peak_mem_gib", "peak_mem_gib", "prefill_wall_s",
                 "decode_step_s", "losses", "overflow", "device_busy_ms")
    # the card's busy time over the four ranks' step: each rank's own
    # kernels and copies, summed, over rank 0's wall of that step
    busy = [r["device_busy_ms"] for r in ranks]
    card_busy = (sum(busy) / (ranks[0]["train_wall_s"] * 1e3)) if device == "cuda" else None
    emit({"phase": "mesh_path", "ok": True, "mesh": spec["mesh"], "backend": "gloo", "ranks": n,
          "transport": "gloo through the host, every rank on one card: says nothing of NVLink",
          "probe": ranks[0]["probe"], "parity": ranks[0]["parity"], "tol": MESH_TOL, "parity_opt": MESH_OPT,
          "full": dict(arch=LM_ARCH, n_layers=spec["full_layers"], dtype="bfloat16", remat=True,
                       train=spec["train"], prefill=spec["prefill"],
                       decode=spec["decode"], steps=1),
          "per_rank": {k: [r[k] for r in ranks] for k in rank_keys}, "profiled_rank0": ranks[0]["profiled"],
          "card_busy_share_of_four_ranks": card_busy,
          "aten_ops": dict(mesh_rank0=ranks[0]["profiled"]["host_split"]["aten_ops"],
                           one_process=one["host_split"]["aten_ops"]),
          "one_process": one, "launches": launches, "spawn_and_run_s": spawn_s,
          "nvidia_smi": nvidia_smi() if device == "cuda" else None, "phase_s": time.perf_counter() - t_phase})
    return launches


# ------------------------------------------------------ mesh_families_path
#: the last mesh paths: xlstm and whisper served tensor-parallel, jamba's
#: super-block served and trained on a mesh; 4 gloo ranks sharing the card.
#: (a) float32 parity with one process on ``parity_mesh``: each (name,
#: arch, overrides, held to ``MESH_TOL``) served at ``parity_prefill``
#: then ``decode_steps`` steps, and one jamba train step under 2d at
#: ``train_batch``. One process's own float32 logits of xlstm-350m move
#: by 8.0e-5 of the largest when the prompt's batch is halved (the
#: phase's ``one_process_spread`` on an NVIDIA H100 80GB HBM3 at 700 W):
#: its mLSTM blocks amplify a rounding difference, and 24 of them compound
#: it (the mesh's error at 24 blocks, 1.33e-4 on the card, is of that
#: size). The check at ``MESH_TOL`` holds its first 8 blocks (7 mLSTM,
#: 1 sLSTM), whose spread is 1.2e-5; the whole depth's float32 row is
#: left out for time (its bf16 serving below is whole); (b) bf16
#: serving at published widths on ``serve_mesh``: (arch, overrides,
#: prefill (B, S), decode (lanes, cache)). jamba is cut to one super-block
#: (8 layers) and 4 experts, and for its float32 parity to a d_ff of 4096
#: (xlstm's state does not grow with the context: its decode "cache" of
#: 1024 only lets the timed prefill of 512 seed the decode steps)
#: (~6.2 B parameters, ~23 GiB); its train step runs on a jamba-shaped
#: model of d_model 1024 (~0.3 B parameters): 6.2 B parameters at 16 B
#: each (weights, gradients, AdamW's moments) would be ~99 GB
MESH_FAMILIES_SPEC = dict(
    parity_mesh=(2, 2), serve_mesh=(1, 4), parity_prefill=(4, 256), decode_steps=3,
    parity=((f"{REC_ARCH}, 8 blocks", REC_ARCH, dict(n_layers=8), True),
            (AUDIO_ARCH, AUDIO_ARCH, {}, True), (HYB_ARCH, HYB_ARCH, dict(HYB_CUT, moe_experts=4, d_ff=4096), True)),
    train=(HYB_ARCH, dict(HYB_CUT, d_model=1024, n_heads=8, n_kv_heads=2, d_ff=2048, moe_experts=4)),
    train_batch=(4, 256),
    serve=((HYB_ARCH, dict(HYB_CUT, moe_experts=4), (4, 256), (4, 512)), (REC_ARCH, {}, (8, 512), (8, 1024)),
           (AUDIO_ARCH, {}, (16, 448), (16, 448))),
    reduced=False)
#: the CPU rehearsal's cut (tests/test_torch_mesh_families.py): the reduced
#: configs, jamba at one super-block
MESH_FAMILIES_REHEARSAL = dict(
    MESH_FAMILIES_SPEC, parity_prefill=(4, 16), train_batch=(4, 32), reduced=True,
    parity=((REC_ARCH, REC_ARCH, {}, True), (AUDIO_ARCH, AUDIO_ARCH, {}, True), (HYB_ARCH, HYB_ARCH, HYB_CUT, True)),
    train=(HYB_ARCH, HYB_CUT),
    serve=((HYB_ARCH, HYB_CUT, (4, 16), (4, 32)), (REC_ARCH, {}, (4, 16), (4, 32)),
           (AUDIO_ARCH, {}, (4, 16), (4, 16))))


def family_cfg(spec, arch, over, **kw):
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = get_arch(arch).reduced() if spec["reduced"] else get_arch(arch)
    return dataclasses.replace(cfg, **{**over, **kw})


def leaf_value(torch, name, meta, dev, gen):
    """One parameter drawn on ``dev`` as the families' init draws it: the
    norms, gates and Mamba constants as their init sets them, every other
    leaf a normal draw over the root of its fan-in."""
    leaf, shape = name.split(".")[-1], tuple(meta.shape)
    const = {"D": 1.0, "conv_b": 0.0, "b_i": 0.0, "b_zifo": 0.0, "b_dt": -4.6, "b_f": 3.0}
    if "norm" in name or leaf in const:
        return torch.full(shape, const.get(leaf, 1.0), dtype=meta.dtype, device=dev)
    if leaf == "A_log":
        return torch.log(torch.arange(1, shape[1] + 1, dtype=meta.dtype, device=dev)).expand(shape).clone()
    fan_in = shape[-1] if leaf == "embed" else shape[-2]
    return (torch.randn(shape, generator=gen, device=dev) / math.sqrt(fan_in)).to(meta.dtype)


def family_model(torch, cfg, dev, seed, mesh=None):
    """``cfg``'s model on ``dev``, its parameters drawn one after another
    from one generator seeded with ``seed`` and, on ``mesh``, each placed
    by its sanitized spec as soon as it is drawn: a rank holds its blocks
    and one whole leaf at most (jamba's float32 cut is ~23 GiB whole, and
    four ranks share the card)."""
    from torch import nn

    from repro_torch.models import Model
    from repro_torch.models import sharding as shd
    from repro_torch.models.lm import model_axis_size

    model = Model(cfg, device="meta")
    model.device = dev
    shapes = dict(model.named_parameters())
    specs = None
    if mesh is not None:
        specs = shd.sanitize_specs(mesh, shd.param_specs(cfg, shapes, model_axis_size(mesh)), shapes)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for name, meta in shapes.items():
        t = leaf_value(torch, name, meta, dev, gen)
        if specs is not None:
            t = shd.place(t, mesh, specs[name])
        *path, leaf = name.split(".")
        owner = model.get_submodule(".".join(path)) if path else model
        p = nn.Parameter(t, requires_grad=False)
        if isinstance(owner, nn.ParameterList):
            owner[int(leaf)] = p
        elif isinstance(owner, nn.ParameterDict):
            owner[leaf] = p
        else:
            setattr(owner, leaf, p)
    model.mesh = mesh
    return model


def family_batch(torch, cfg, dev, rows, s, seed):
    """A prompt batch of ``rows`` x ``s`` tokens (whisper's with its
    frames), drawn from ``seed`` on the host, the same in every process."""
    from repro_torch.models.layers import dtype_of

    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab, (rows, s), generator=gen, dtype=torch.int32).to(dev)}
    if cfg.family == "audio":
        batch["frames"] = torch.randn((rows, cfg.enc_positions, cfg.d_model), generator=gen).to(dev, dtype_of(cfg))
    return batch


def family_serve(torch, model, mesh, batch, steps, cache_len):
    """Prefill, then ``steps`` decode steps of tokens drawn from a seed:
    the logits of each."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    rows = batch["tokens"].shape[0]
    gen = torch.Generator().manual_seed(28)
    toks = torch.randint(0, model.cfg.vocab, (steps, rows), generator=gen, dtype=torch.int32).to(model.device)
    with torch.no_grad():
        cache, logits = make_prefill_step(model, mesh, cache_len)(batch)
        out = [logits.float()]
        dec = make_decode_step(model, mesh, rows, cache_len)
        for t in toks:
            logits, cache = dec(cache, t)
            out.append(logits.float())
    return out


def family_walls(torch, model, mesh, batch, dbatch, cache_len, steps, sync, barrier, host=None):
    """Serving walls of one family: prefill (median of 2, every rank
    started together) and decode steps (median after one warm step) from a
    prefill of ``dbatch`` at ``cache_len``; on a mesh one more decode step
    on every rank, rank 0's under ``host`` (a ``HostSplit``)."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step

    pre = make_prefill_step(model, mesh, cache_len)
    walls = []
    with torch.no_grad():
        for _ in range(2):
            barrier()
            sync()
            t0 = time.perf_counter()
            cache, logits = pre(batch)
            sync()
            walls.append(time.perf_counter() - t0)
        if dbatch is not batch:
            cache, logits = pre(dbatch)
        dec = make_decode_step(model, mesh, dbatch["tokens"].shape[0], cache_len)
        tok = logits.argmax(-1).to(torch.int32)
        dec_walls = []
        for _ in range(steps + 1):
            barrier()
            sync()
            t0 = time.perf_counter()
            logits, cache = dec(cache, tok)
            tok = logits.argmax(-1).to(torch.int32)
            sync()
            dec_walls.append(time.perf_counter() - t0)
        split = None
        if mesh is not None:
            with host or contextlib.nullcontext():
                logits, cache = dec(cache, tok)
                sync()
            split = host.row() if host is not None else None
    return dict(prefill_wall_s=statistics.median(walls), decode_step_s=statistics.median(dec_walls[1:]),
                logits_finite=bool(torch.isfinite(logits).all()), host_split=split)


def decode_batch(torch, cfg, dev, batch, decode):
    """The decode walls' prefill: the timed prefill itself where its
    prompt leaves room in the decode cache, else ``lanes`` x cache / 2."""
    lanes, cache_len = decode
    if batch["tokens"].shape[1] < cache_len and batch["tokens"].shape[0] == lanes:
        return batch
    return family_batch(torch, cfg, dev, lanes, cache_len // 2, 8)


def mesh_families_rank(rank, n, spec):
    """One rank of ``mesh_families_path`` (see the phase)."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import _build as build
    from repro_torch.launch.mesh import make_mesh, mesh_device
    from repro_torch.optim import OptConfig
    from repro_torch.train import init_all, make_train_step

    mesh = make_mesh(spec["parity_mesh"], ("data", "model"), spec["device"])
    dev = mesh_device(mesh)
    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

    build.reset_counts()
    out = dict(rank=rank, device=str(dev), backend=dist.get_backend(), parity={})
    b, s = spec["parity_prefill"]
    for name, arch, over, _ in spec["parity"]:
        cfg = family_cfg(spec, arch, over, dtype="float32", param_sharding="1d")
        model = family_model(torch, cfg, dev, 0, mesh)
        logits = family_serve(torch, model, mesh, family_batch(torch, cfg, dev, b, s, 25), spec["decode_steps"],
                              2 * s)
        out["parity"][name] = [t.cpu() for t in logits] if rank == 0 else None
        del model
        free()
    # one jamba train step under 2d, against one process on rank 0
    arch, over = spec["train"]
    cfg = family_cfg(spec, arch, over, dtype="float32", param_sharding="2d")
    oc = OptConfig(**MESH_OPT)
    tb, ts = spec["train_batch"]
    toks = family_batch(torch, cfg, dev, tb, ts, 26)["tokens"]
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    model = family_model(torch, cfg, dev, 1, mesh)
    params, opt = init_all(model, oc, mesh)
    params, opt, met = make_train_step(model, oc, mesh)(params, opt, batch)
    got = {k: mesh_full(p) for k, p in params.items()}
    train = dict(arch=arch, loss=float(met["loss"]), overflow=bool(met["aux_overflow"]))
    del model, params, opt
    if rank == 0:
        one = family_model(torch, cfg, dev, 1)
        p1, o1 = init_all(one, oc)
        p1, o1, m1 = make_train_step(one, oc)(p1, o1, batch)
        train.update(one_loss=float(m1["loss"]), one_overflow=bool(m1["aux_overflow"]),
                     loss_rel_err=abs(train["loss"] - float(m1["loss"])) / abs(float(m1["loss"])))
        errs = {k: float((got[k].float() - p.detach().float()).abs().max() / p.detach().float().abs().max())
                for k, p in p1.items()}
        train["leaf_worst"] = max(errs.items(), key=lambda kv: kv[1])
        del one, p1, o1
    out["train"] = train
    del got
    free()

    # (b) bf16 at published widths on the serving mesh
    smesh = make_mesh(spec["serve_mesh"], ("data", "model"), spec["device"])
    out["serve"] = {}
    for arch, over, prefill, decode in spec["serve"]:
        cfg = family_cfg(spec, arch, over, param_sharding="1d")
        model = family_model(torch, cfg, dev, 2, smesh)
        batch = family_batch(torch, cfg, dev, *prefill, 27)
        row = family_walls(torch, model, smesh, batch, decode_batch(torch, cfg, dev, batch, decode), decode[1],
                           spec["decode_steps"], sync, dist.barrier, HostSplit() if rank == 0 else None)
        row["peak_mem_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else None
        out["serve"][arch] = row
        del model
        free()
    out["launches"] = build.counts()
    return out


def mesh_families_one_process(torch, spec, dev):
    """One process's side of the phase on the device: the float32 parity
    runs' logits and their own spread (the prefill of the first half of
    the rows alone against the same rows of the whole batch), and the
    bf16 serving walls and peak."""
    import gc

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()

    out = dict(parity={}, spread={}, params={}, serve={})
    b, s = spec["parity_prefill"]
    for name, arch, over, _ in spec["parity"]:
        cfg = family_cfg(spec, arch, over, dtype="float32", param_sharding="1d")
        model = family_model(torch, cfg, dev, 0)
        batch = family_batch(torch, cfg, dev, b, s, 25)
        logits = [t.cpu() for t in family_serve(torch, model, None, batch, spec["decode_steps"], 2 * s)]
        half = family_serve(torch, model, None, {k: v[: b // 2] for k, v in batch.items()}, 0, 2 * s)[0].cpu()
        out["parity"][name], out["params"][name] = logits, cfg.param_count()
        out["spread"][name] = float((half - logits[0][: b // 2]).abs().max() / logits[0][: b // 2].abs().max())
        del model
        free()
    for arch, over, prefill, decode in spec["serve"]:
        cfg = family_cfg(spec, arch, over, param_sharding="1d")
        model = family_model(torch, cfg, dev, 2)
        batch = family_batch(torch, cfg, dev, *prefill, 27)
        row = family_walls(torch, model, None, batch, decode_batch(torch, cfg, dev, batch, decode), decode[1],
                           spec["decode_steps"], sync, lambda: None)
        row.update(peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30 if on_card else None,
                   params=cfg.param_count())
        del row["host_split"]
        out["serve"][arch] = row
        del model
        free()
    return out


def phase_mesh_families_path(torch, core, build, device="cuda", spec=MESH_FAMILIES_SPEC):
    """The last mesh paths (see ``MESH_FAMILIES_SPEC``): 4 gloo ranks
    sharing the card, as ``mesh_path``'s. One process first computes the
    float32 parity runs' logits and the bf16 serving walls, and frees the
    card; then the ranks run the same on the meshes: the float32 logits of
    xlstm, whisper and jamba within 1e-4 of one process's, one jamba train
    step under 2d (loss, every updated leaf, records dropped) against
    rank 0's one-process step, then each family's bf16 prefill and decode
    walls, peak a rank and rank 0's ``HostSplit`` of one decode step. It
    launches none of K1-K4; a rank that fails fails the phase."""
    import gc

    from repro_torch.launch.mesh import spawn

    t_phase = time.perf_counter()
    dev = torch.device(device)
    build.reset_counts()
    one = mesh_families_one_process(torch, spec, dev)
    launches = {k: v for k, v in build.counts().items() if k in KERNEL_NAMES}
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    n = math.prod(spec["parity_mesh"])
    if math.prod(spec["serve_mesh"]) != n:
        fail("mesh_families_path", f"the two meshes {spec['parity_mesh']}, {spec['serve_mesh']} differ in size")
    t0 = time.perf_counter()
    ranks = spawn(mesh_families_rank, n, backend="gloo", device=device, args=(dict(spec, device=device),))
    spawn_s = time.perf_counter() - t0
    launches = {name: launches.get(name, 0) + sum(r["launches"].get(name, 0) for r in ranks)
                for name in KERNEL_NAMES}
    for r in ranks:
        if r["device"].split(":")[0] != device or r["backend"] != "gloo":
            fail("mesh_families_path", f"rank {r['rank']} ran on {r['device']} over {r['backend']}")
        bad = [a for a, row in r["serve"].items() if not row["logits_finite"]]
        if bad:
            fail("mesh_families_path", f"rank {r['rank']}: non-finite bf16 logits of {bad}")
    parity, problems = {}, []
    for name, arch, over, held in spec["parity"]:
        got, want = ranks[0]["parity"][name], one["parity"][name]
        errs = [float((g - w).abs().max() / w.abs().max()) for g, w in zip(got, want)]
        parity[name] = dict(cut=over, logits_rel_err=errs, held_to_tol=held, params=one["params"][name],
                            one_process_spread=one["spread"][name])
        if len(got) != len(want) or (held and max(errs) > MESH_TOL):
            problems.append(f"{name} float32 on the mesh against one process: {errs}")
    train = ranks[0]["train"]
    if train["overflow"] != train["one_overflow"]:
        problems.append(f"jamba train: records dropped {train['overflow']}, one process {train['one_overflow']}")
    if train["loss_rel_err"] > MESH_TOL or train["leaf_worst"][1] > MESH_TOL:
        problems.append(f"jamba train step on the mesh against one process: {train}")
    if any(launches.values()):
        problems.append(f"launched {launches}")
    serve = {}
    for arch, over, prefill, decode in spec["serve"]:
        serve[arch] = dict(cut=over, prefill=prefill, decode=decode, params=one["serve"][arch]["params"],
                           per_rank={k: [r["serve"][arch][k] for r in ranks]
                                     for k in ("prefill_wall_s", "decode_step_s", "peak_mem_gib")},
                           host_split_rank0=ranks[0]["serve"][arch]["host_split"],
                           one_process=one["serve"][arch])
    emit({"phase": "mesh_families_path", "ok": not problems, "parity_mesh": spec["parity_mesh"],
          "serve_mesh": spec["serve_mesh"], "backend": "gloo", "ranks": n,
          "transport": "gloo through the host, every rank on one card: says nothing of NVLink",
          "parity": parity, "tol": MESH_TOL,
          "train": dict(train, cut=spec["train"][1], batch=spec["train_batch"], policy="2d", opt=MESH_OPT),
          "serve": serve, "launches": launches, "spawn_and_run_s": spawn_s,
          "nvidia_smi": nvidia_smi() if device == "cuda" else None, "phase_s": time.perf_counter() - t_phase})
    if problems:
        fail("mesh_families_path", "; ".join(problems))
    return launches

# ------------------------------------------------- mesh_train_families_path
#: the configurations the mesh took last: xlstm and whisper trained
#: tensor-parallel, a train step whose sequence does not divide the model
#: axis (the residual replicated over it), serving under the dp policy
#: (the cache re-laid by one exchange), widths that do not divide the model
#: axis (the weights whole). (a) float32 on ``parity_mesh`` against one
#: process, AdamW eps 1: each train case (name, arch, overrides, policy,
#: (B, S)) one step; each serve case (name, arch, overrides, policy,
#: prefill (B, S)) prefill at a cache of 2 S and ``decode_steps`` steps.
#: xlstm-350m is cut to its first 8 blocks (7 mLSTM, 1 sLSTM): at 24 its
#: own float32 spread is 1.33e-4 of the largest logit (``mesh_families_path``);
#: (b) bf16 at published widths and full depth on ``walls_mesh``: one train
#: step of each (arch, overrides, (B, S)), a rank against one process;
#: (c) float32 on ``uneven_mesh`` (3 ranks), the ``uneven`` case trained at
#: its (B, S) and served at its prefill against one process.
MESH_TRAIN_FAMILIES_SPEC = dict(
    parity_mesh=(2, 2), decode_steps=3,
    train=((f"{REC_ARCH}, 8 blocks, 1d", REC_ARCH, dict(n_layers=8), "1d", (4, 64)),
           (f"{REC_ARCH}, 8 blocks, 2d", REC_ARCH, dict(n_layers=8), "2d", (4, 64)),
           (f"{AUDIO_ARCH}, 1d", AUDIO_ARCH, {}, "1d", (4, 64)),
           (f"{LM_ARCH}, 2 layers, 1d, S 255", LM_ARCH, dict(n_layers=2), "1d", (4, 255))),
    serve=((f"{DENSE_ARCH}, 2 layers, dp", DENSE_ARCH, dict(n_layers=2), "dp", (4, 256)),),
    walls_mesh=(1, 4), walls=((REC_ARCH, {}, (4, 64)), (AUDIO_ARCH, {}, (8, 448))),
    uneven_mesh=(1, 3),
    uneven=(f"{DENSE_ARCH}, 2 layers, 1d on model 3", DENSE_ARCH, dict(n_layers=2), "1d", (4, 256), (4, 256)),
    reduced=False)
#: the CPU rehearsal's cut (tests/test_torch_mesh_train_families_rehearsal.py):
#: the reduced configs at short sequences (model 3 divides none of the
#: reduced tinyllama's widths either: 128, 256 and 4 heads)
MESH_TRAIN_FAMILIES_REHEARSAL = dict(
    MESH_TRAIN_FAMILIES_SPEC, reduced=True,
    train=((f"{REC_ARCH}, 1d", REC_ARCH, dict(n_layers=4, slstm_every=2), "1d", (4, 16)),
           (f"{AUDIO_ARCH}, 1d", AUDIO_ARCH, {}, "1d", (4, 16)),
           (f"{LM_ARCH}, 1d, S 15", LM_ARCH, {}, "1d", (4, 15))),
    serve=((f"{DENSE_ARCH}, dp", DENSE_ARCH, {}, "dp", (4, 16)),),
    walls=((REC_ARCH, dict(n_layers=4, slstm_every=2), (4, 16)), (AUDIO_ARCH, {}, (4, 16))),
    uneven=(f"{DENSE_ARCH}, 1d on model 3", DENSE_ARCH, {}, "1d", (4, 16), (4, 16)))


def train_families_batch(torch, cfg, dev, b, s, seed):
    """A train batch of ``b`` x ``s`` tokens (whisper's with its frames),
    the labels the tokens shifted by one."""
    batch = family_batch(torch, cfg, dev, b, s, seed)
    batch["labels"] = torch.roll(batch["tokens"], -1, 1)
    return batch


def train_families_step(torch, cfg, dev, batch, mesh=None):
    """One float32 train step from the seeded parameters: (loss, the overflow
    flag, the records each MoE call dropped over the whole batch, every
    updated leaf as a full tensor on the host; on a mesh only rank 0's)."""
    from repro_torch.models.moe import counting_drops
    from repro_torch.optim import OptConfig
    from repro_torch.train import init_all, make_train_step

    oc = OptConfig(**MESH_OPT)
    model = family_model(torch, cfg, dev, 0, mesh)
    params, opt = init_all(model, oc, mesh)
    with counting_drops() as drops:
        params, opt, met = make_train_step(model, oc, mesh)(params, opt, batch)
    full = {k: mesh_full(p) for k, p in params.items()}
    first = mesh is None or torch.distributed.get_rank() == 0
    return dict(loss=float(met["loss"]), overflow=bool(met.get("aux_overflow", False)),
                drops=[int(n) for n in drops],
                params={k: t.float().cpu() for k, t in full.items()} if first else None)


def train_families_serve(torch, cfg, dev, prefill, steps, mesh=None):
    """Prefill at a cache of twice the prompt and ``steps`` decode steps:
    the logits on the host, and on a mesh whether every cache leaf is
    placed as the sanitized ``cache_specs`` place it."""
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import sharding as shd

    model = family_model(torch, cfg, dev, 0, mesh)
    batch = family_batch(torch, cfg, dev, *prefill, 25)
    rows, cache_len = prefill[0], 2 * prefill[1]
    toks = torch.randint(0, cfg.vocab, (steps, rows), generator=torch.Generator().manual_seed(28),
                         dtype=torch.int32).to(dev)
    with torch.no_grad():
        cache, logits = make_prefill_step(model, mesh, cache_len)(batch)
        out = [logits.float().cpu()]
        dec = make_decode_step(model, mesh, rows, cache_len)
        for t in toks:
            logits, cache = dec(cache, t)
            out.append(logits.float().cpu())
    placed = None
    if mesh is not None:
        flat = {k: v for k, v in cache.items() if k != "pos"}
        same = []
        shd.tree_map(lambda spec, t: same.append(list(t.placements) == shd.to_placements(mesh, spec)),
                     shd.sanitize_specs(mesh, shd.cache_specs(cfg, mesh, flat), flat), flat)
        placed = all(same)
    return dict(logits=out, placed=placed)


def train_families_wall(torch, cfg, dev, batch, sync, barrier, mesh=None, host=None):
    """Two bf16 train steps (default AdamW): each step's wall, every rank
    started together; the second under ``host`` (a ``HostSplit``); the
    peak of the card's memory over both."""
    from repro_torch.optim import OptConfig
    from repro_torch.train import init_all, make_train_step

    oc = OptConfig()
    model = family_model(torch, cfg, dev, 2, mesh)
    params, opt = init_all(model, oc, mesh)
    step = make_train_step(model, oc, mesh)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    walls, losses = [], []
    for i in range(2):
        barrier()
        sync()
        t0 = time.perf_counter()
        with (host if i == 1 and host is not None else contextlib.nullcontext()):
            params, opt, met = step(params, opt, batch)
            losses.append(float(met["loss"]))
        sync()
        walls.append(time.perf_counter() - t0)
    b, s = batch["tokens"].shape
    return dict(walls_s=walls, tokens_per_s=b * s / walls[1], losses=losses,
                peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else None,
                host_split=host.row() if host is not None else None)


def train_families_rank(rank, n, spec):
    """One rank of ``mesh_train_families_path``: with ``spec["world"]`` 4,
    the parity cases on ``parity_mesh`` and the bf16 walls on
    ``walls_mesh``; with 3, the ``uneven`` case on ``uneven_mesh``."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.kernels import _build as build
    from repro_torch.launch.mesh import make_mesh, mesh_device

    on_card = spec["device"] == "cuda"

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    build.reset_counts()
    out = dict(rank=rank, train={}, serve={}, walls={})
    if spec["world"] == "uneven":
        mesh = make_mesh(spec["uneven_mesh"], ("data", "model"), spec["device"])
        dev = mesh_device(mesh)
        name, arch, over, policy, tbs, prefill = spec["uneven"]
        cfg = family_cfg(spec, arch, over, dtype="float32", param_sharding=policy)
        out["train"][name] = train_families_step(torch, cfg, dev, train_families_batch(torch, cfg, dev, *tbs, 26),
                                                 mesh)
        free()
        out["serve"][name] = train_families_serve(torch, cfg, dev, prefill, spec["decode_steps"], mesh)
    else:
        mesh = make_mesh(spec["parity_mesh"], ("data", "model"), spec["device"])
        dev = mesh_device(mesh)
        for name, arch, over, policy, tbs in spec["train"]:
            cfg = family_cfg(spec, arch, over, dtype="float32", param_sharding=policy)
            out["train"][name] = train_families_step(torch, cfg, dev,
                                                     train_families_batch(torch, cfg, dev, *tbs, 26), mesh)
            free()
        for name, arch, over, policy, prefill in spec["serve"]:
            cfg = family_cfg(spec, arch, over, dtype="float32", param_sharding=policy)
            out["serve"][name] = train_families_serve(torch, cfg, dev, prefill, spec["decode_steps"], mesh)
            free()
        wmesh = make_mesh(spec["walls_mesh"], ("data", "model"), spec["device"])
        sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)
        for arch, over, tbs in spec["walls"]:
            cfg = family_cfg(spec, arch, over, param_sharding="1d")
            batch = train_families_batch(torch, cfg, dev, *tbs, 27)
            out["walls"][arch] = train_families_wall(torch, cfg, dev, batch, sync, dist.barrier, wmesh,
                                                     HostSplit() if rank == 0 else None)
            free()
    out["device"], out["backend"] = str(dev), dist.get_backend()
    out["launches"] = build.counts()
    return out if rank == 0 else {k: out[k] for k in ("rank", "device", "backend", "launches", "walls")}


def train_families_one_process(torch, spec, dev):
    """One process's side of the phase on the device: every float32 step
    and the bf16 walls."""
    import gc

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def free():
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    out = dict(train={}, serve={}, walls={})
    name, arch, over, policy, tbs, prefill = spec["uneven"]
    train = list(spec["train"]) + [(name, arch, over, policy, tbs)]
    for name, arch, over, policy, (b, s) in train:
        cfg = family_cfg(spec, arch, over, dtype="float32", param_sharding=policy)
        out["train"][name] = train_families_step(torch, cfg, dev, train_families_batch(torch, cfg, dev, b, s, 26))
        free()
    serve = list(spec["serve"]) + [(name, arch, over, policy, prefill)]
    for name, arch, over, policy, prefill in serve:
        cfg = family_cfg(spec, arch, over, dtype="float32", param_sharding=policy)
        out["serve"][name] = train_families_serve(torch, cfg, dev, prefill, spec["decode_steps"])
        free()
    for arch, over, tbs in spec["walls"]:
        cfg = family_cfg(spec, arch, over, param_sharding="1d")
        batch = train_families_batch(torch, cfg, dev, *tbs, 27)
        out["walls"][arch] = train_families_wall(torch, cfg, dev, batch, sync, lambda: None)
        out["walls"][arch]["params"] = cfg.param_count()
        free()
    return out


def leaf_errors(got: dict, want: dict):
    """The worst updated leaf: its largest error over its largest magnitude,
    the scale floored at 1e-3 of the model's largest (mLSTM's ``b_i``
    moves by rounding noise)."""
    top = max(float(w.abs().max()) for w in want.values())
    errs = {k: float((got[k] - w).abs().max()) / max(float(w.abs().max()), 1e-3 * top) for k, w in want.items()}
    return max(errs.items(), key=lambda kv: kv[1])


def phase_mesh_train_families_path(torch, core, build, device="cuda", spec=MESH_TRAIN_FAMILIES_SPEC):
    """The configurations the mesh took last (see
    ``MESH_TRAIN_FAMILIES_SPEC``): one process first runs every float32
    step and the bf16 walls and frees the card; then 4 gloo ranks sharing
    it run the float32 steps on (data 2, model 2) and the bf16 walls on
    (data 1, model 4), and 3 ranks the uneven widths on (data 1, model 3).
    Each float32 train step is held to one process's (loss, every updated
    leaf, records dropped), each served case's logits too, its cache
    placed as the sanitized ``cache_specs`` place it. It launches none of
    K1-K4; a rank that fails fails the phase."""
    import gc

    from repro_torch.launch.mesh import spawn

    phase = "mesh_train_families_path"
    t_phase = time.perf_counter()
    dev = torch.device(device)
    build.reset_counts()
    one = train_families_one_process(torch, spec, dev)
    launches = {k: v for k, v in build.counts().items() if k in KERNEL_NAMES}
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn(train_families_rank, math.prod(spec["parity_mesh"]), backend="gloo", device=device,
                  args=(dict(spec, device=device, world="parity"),))
    if math.prod(spec["walls_mesh"]) != len(ranks):
        fail(phase, f"the meshes {spec['parity_mesh']} and {spec['walls_mesh']} differ in size")
    uneven = spawn(train_families_rank, math.prod(spec["uneven_mesh"]), backend="gloo", device=device,
                   args=(dict(spec, device=device, world="uneven"),))
    spawn_s = time.perf_counter() - t0
    launches = {k: launches.get(k, 0) + sum(r["launches"].get(k, 0) for r in ranks + uneven) for k in KERNEL_NAMES}
    for r in ranks + uneven:
        if r["device"].split(":")[0] != device or r["backend"] != "gloo":
            fail(phase, f"rank {r['rank']} ran on {r['device']} over {r['backend']}")
    problems, train, serve = [], {}, {}
    for got_rank in (ranks[0], uneven[0]):
        for name, got in got_rank["train"].items():
            want = one["train"][name]
            worst = leaf_errors(got["params"], want["params"])
            rel = abs(got["loss"] - want["loss"]) / abs(want["loss"])
            train[name] = dict(loss=got["loss"], one_loss=want["loss"], loss_rel_err=rel, leaf_worst=worst,
                               overflow=got["overflow"], one_overflow=want["overflow"],
                               dropped=got["drops"], one_dropped=want["drops"])
            if (rel > MESH_TOL or worst[1] > MESH_TOL or got["overflow"] != want["overflow"]
                    or got["drops"] != want["drops"]):
                problems.append(f"{name} train step on the mesh against one process: {train[name]}")
        for name, got in got_rank["serve"].items():
            want = one["serve"][name]["logits"]
            errs = [float((g - w).abs().max() / w.abs().max()) for g, w in zip(got["logits"], want)]
            serve[name] = dict(logits_rel_err=errs, cache_placed_by_cache_specs=got["placed"])
            if len(errs) != len(want) or max(errs) > MESH_TOL or not got["placed"]:
                problems.append(f"{name} served on the mesh against one process: {serve[name]}")
    walls = {}
    for arch, over, tbs in spec["walls"]:
        rows = [r["walls"][arch] for r in ranks]
        if not all(math.isfinite(x) for row in rows for x in row["losses"]):
            problems.append(f"{arch} bf16 losses {[row['losses'] for row in rows]}")
        walls[arch] = dict(cut=over, batch=tbs, params=one["walls"][arch]["params"], mesh=spec["walls_mesh"],
                           per_rank={k: [row[k] for row in rows] for k in ("walls_s", "tokens_per_s",
                                                                            "peak_mem_gib", "losses")},
                           host_split_rank0=rows[0]["host_split"],
                           one_process={k: v for k, v in one["walls"][arch].items() if k != "host_split"})
    if any(launches.values()):
        problems.append(f"launched {launches}")
    emit({"phase": phase, "ok": not problems, "parity_mesh": spec["parity_mesh"],
          "uneven_mesh": spec["uneven_mesh"], "backend": "gloo", "ranks": [len(ranks), len(uneven)],
          "transport": "gloo through the host, every rank on one card: says nothing of NVLink",
          "train": train, "serve": serve, "tol": MESH_TOL, "opt": MESH_OPT,
          "cases": dict(train=spec["train"], serve=spec["serve"], uneven=spec["uneven"]),
          "walls": walls, "launches": launches, "spawn_and_run_s": spawn_s,
          "nvidia_smi": nvidia_smi() if device == "cuda" else None, "phase_s": time.perf_counter() - t_phase})
    if problems:
        fail(phase, "; ".join(problems))
    return launches


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
        cells.append(dict(algorithm=algo, dist=dist, payload=bool(nv), stage_ms=stages, wall_ms=wall_ms,
                          walls_ms=walls_ms,
                          profiled_wall_ms=profiled_ms, device_busy_ms=busy,
                          idle_share=idle_share(busy, profiled_ms),
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

    if len(sys.argv) > 2 and sys.argv[1] == "--phases":
        # a quicker run of some path phases only, for work on one of them;
        # it prints no kernels line and no result line
        paths = {"service_path": phase_service_path, "chaos_path": phase_chaos_path,
                 "segmented_path": phase_segmented_path, "planner_path": phase_planner_path,
                 "delta_path": phase_delta_path, "lm_path": phase_lm_path,
                 "train_path": phase_train_path, "recurrent_path": phase_recurrent_path,
                 "audio_path": phase_audio_path, "sharded_path": phase_sharded_path,
                 "mesh_path": phase_mesh_path, "mesh_families_path": phase_mesh_families_path,
                 "mesh_train_families_path": phase_mesh_train_families_path}
        for name in sys.argv[2].split(","):
            paths[name](torch, core, build)
        return 0
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
    # the service paths launch none of K1-K4: their batches carry the
    # position payload (Ph2 takes the stable sort) and ServiceConfig has no
    # merge_backend (the tree merge's kernels are not asked for), as in the
    # JAX package
    service_launches = dict.fromkeys(KERNEL_NAMES, 0)
    for counted in (phase_service_path(torch, core, build), phase_chaos_path(torch, core, build)):
        for name in KERNEL_NAMES:
            service_launches[name] += counted.get(name, 0)
            launches[name] += counted.get(name, 0)
    emit({"phase": "service_launches", "ok": True, "launches": service_launches,
          "none_as_expected": not any(service_launches.values())})
    # nor does the LM path: the MoE dispatch sorts with torch.sort (the
    # reference's jnp.argsort), admission goes through the service and the
    # admission view keeps merge_backend="xla"
    lm_launches = phase_lm_path(torch, core, build)
    for name in KERNEL_NAMES:
        launches[name] += lm_launches.get(name, 0)
    emit({"phase": "lm_launches", "ok": True, "launches": lm_launches,
          "none_as_expected": not any(lm_launches.values())})
    # nor does training: the same model under autograd, as in the JAX package
    train_launches = phase_train_path(torch, core, build)
    for name in KERNEL_NAMES:
        launches[name] += train_launches.get(name, 0)
    emit({"phase": "train_launches", "ok": True, "launches": train_launches,
          "none_as_expected": not any(train_launches.values())})
    # nor do the recurrent families: their scans are Python loops over time,
    # the hybrid's MoE dispatch sorts with torch.sort, as in the JAX package
    recurrent_launches = phase_recurrent_path(torch, core, build)
    for name in KERNEL_NAMES:
        launches[name] += recurrent_launches.get(name, 0)
    emit({"phase": "recurrent_launches", "ok": True, "launches": recurrent_launches,
          "none_as_expected": not any(recurrent_launches.values())})
    # nor does the audio family: its attention is plain torch, and no sort
    # runs in it, as in the JAX package
    audio_launches = phase_audio_path(torch, core, build)
    for name in KERNEL_NAMES:
        launches[name] += audio_launches.get(name, 0)
    emit({"phase": "audio_launches", "ok": True, "launches": audio_launches,
          "none_as_expected": not any(audio_launches.values())})
    # the multi-process runner: K1-K3 run inside every rank
    sharded_launches = phase_sharded_path(torch, core, build)
    for name in KERNEL_NAMES:
        launches[name] += sharded_launches.get(name, 0)
    emit({"phase": "sharded_launches", "ok": True, "launches": sharded_launches})
    # nor does the mesh half: its collectives are torch.distributed's, the
    # MoE dispatch sorts with torch.sort
    mesh_launches = phase_mesh_path(torch, core, build)
    for name in KERNEL_NAMES:
        launches[name] += mesh_launches.get(name, 0)
    emit({"phase": "mesh_launches", "ok": True, "launches": mesh_launches,
          "none_as_expected": not any(mesh_launches.values())})
    # nor do the recurrent and audio families on a mesh
    families_launches = phase_mesh_families_path(torch, core, build)
    for name in KERNEL_NAMES:
        launches[name] += families_launches.get(name, 0)
    emit({"phase": "mesh_families_launches", "ok": True, "launches": families_launches,
          "none_as_expected": not any(families_launches.values())})
    # nor do the families trained on a mesh, dp serving or uneven widths
    train_families_launches = phase_mesh_train_families_path(torch, core, build)
    for name in KERNEL_NAMES:
        launches[name] += train_families_launches.get(name, 0)
    emit({"phase": "mesh_train_families_launches", "ok": True, "launches": train_families_launches,
          "none_as_expected": not any(train_families_launches.values())})
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
                            library_ms=e["library_ms"], sharded_launches=sharded_launches[name],
                            mesh_families_launches=families_launches[name],
                            mesh_train_families_launches=train_families_launches[name]))
    print(smi, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
