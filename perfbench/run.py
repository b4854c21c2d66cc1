#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for (without them it exits 2 and prints no result). Set-up, from the
process's start to the first timed call: imports, the kernels' library
(built by ``nvcc`` under ``build/repro_torch/`` on a checkout's first
run), the pool of inputs made on the device from ``--seed``, and warm
calls over every input of the pool. The window then calls the entry in a
closed loop, each call's result synchronized before the next starts,
for ``--seconds``.

``--trace 0`` reports the cell's end-to-end metrics. ``--trace 1``
reports its per-layer metrics: the window's first calls run under
``torch.profiler`` with ranges around the program's stages, the rest
with the program's own tracer, whose synchronized spans cost time.

Once the window has closed and its memory peak is read, a sample of its
answers drawn from the seed is judged against the plain reference
(``reference.py``). Each number compared is printed beside its limit as
the last lines on standard error, and under ``checks``, the last key of
the result line, the last line on standard output. A run whose process
has loaded JAX, flax or the JAX package by then exits 4 with no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

#: top-level module names no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: answers of the window judged against the reference, drawn from the seed
CHECK_SAMPLE = 3
#: calls of a traced run's window under the profiler: a few MB of trace
PROFILED_CALLS = 8


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules (or ``names``) whose top-level name, before the first
    dot, is forbidden: ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def process_env() -> None:
    """Kernel caches at fixed paths inside the checkout, and one host
    thread for torch's pool: the load is one process's."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["OMP_NUM_THREADS"] = "1"


@dataclass
class Context:
    """What a per-layer metric's reader (``metrics/<name>.py``) reads.

    ``calls``/``rung_attempts``: the whole window's calls and rungs walked;
    ``trace``: ``devtrace.reduce`` of the profiled part, which held
    ``profiled_calls`` calls; ``spans``: the program's tracer spans of the
    other ``traced_calls`` calls; ``stage_bytes``: a call's bytes by range.
    """

    calls: int
    rung_attempts: int
    profiled_calls: int
    trace: Dict
    traced_calls: int
    spans: List[Dict]
    stage_bytes: Dict[str, int] = field(default_factory=dict)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda", sizes=None,
             t_start: Optional[float] = None) -> Dict:
    """One run of one cell; returns the result line as a dict.

    ``device``/``sizes`` let a test drive a cut cell on the CPU; a run from
    the command line takes the card and the files' sizes.
    """
    import torch

    from perfbench import devtrace, manifest, measure, reference

    t_start = time.perf_counter() if t_start is None else t_start
    bench = manifest.load()
    wl = manifest.workload(bench, workload)
    conf = manifest.config(bench, wl["config"])
    traffic = manifest.traffic(wl["traffic"])
    entry = manifest.entry(conf["spec"]["entry"])
    device = torch.device(device)
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    t_cell = time.perf_counter()
    cell = entry.Cell(conf["spec"], traffic, seed, device, sizes)
    sync()
    t_warm = time.perf_counter()
    keep = CHECK_SAMPLE
    # every input once, and as many answers held at once as the window
    # holds, so that its blocks are cached before the window opens
    warm = [cell.call(i) for i in range(max(len(cell.pool), keep + 2))]
    sync()
    del warm
    if on_card:
        # what set-up made stays: no collection in the window walks it
        gc.collect()
        gc.freeze()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    draw = random.Random(seed)
    kept: list = []
    records: List[measure.Record] = []

    def one(i: int) -> None:
        t0 = time.perf_counter()
        answer = cell.call(i)
        sync()
        records.append((t0, time.perf_counter(), cell.keys_per_call))
        # a reservoir of ``keep`` answers, each call equally likely
        if len(kept) < keep:
            kept.append(answer)
        else:
            j = draw.randrange(i + 1)
            if j < keep:
                kept[j] = answer

    cell.start_window()
    window0 = time.perf_counter()
    profiled_calls = PROFILED_CALLS if trace else 0
    dev_trace: Dict = {}
    if trace:
        def profiled_part() -> None:
            with devtrace.ranges(cell.ranges + [(cell, "call", "call")]):
                for i in range(profiled_calls):
                    one(i)

        dev_trace = devtrace.profiled(profiled_part, device.type)
        from repro_torch.obs import Tracer

        tracer = Tracer()
        cell.trace_with(tracer)
    i = profiled_calls
    while True:
        one(i)
        i += 1
        if records[-1][1] - window0 >= seconds and i - profiled_calls >= 2:
            break
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    calls, attempts = len(records), cell.rung_attempts()

    metrics: Dict[str, Dict] = {}
    if not trace:
        e2e = measure.end_to_end(records, peak, setup_s)
        for m in manifest.end_to_end(bench, workload):
            metrics[m["name"]] = {"value": e2e[m["name"]][0], "unit": m["unit"]}
    else:
        ctx = Context(calls=calls, rung_attempts=attempts, profiled_calls=profiled_calls, trace=dev_trace,
                      traced_calls=calls - profiled_calls, spans=list(tracer.spans),
                      stage_bytes=dict(cell.stage_bytes))
        for m in manifest.per_layer(bench, workload):
            value = manifest.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the reference runs after the window, its peak read; only the pool
    # and the sampled answers stay
    if on_card:
        torch.cuda.empty_cache()
    worst: Dict[str, int] = {}
    failed = 0
    while kept:
        nums = cell.check(kept.pop())
        failed += any(v > reference.LIMITS[k] for k, v in nums.items())
        for k, v in nums.items():
            worst[k] = max(worst.get(k, 0), v)
    checks = {k: {"value": v, "limit": reference.LIMITS[k]} for k, v in worst.items()}

    dev = {
        "platform": "gpu" if on_card else device.type,
        "kind": torch.cuda.get_device_name(device) if on_card else device.type,
        "count": int(wl["chips"]) if on_card else 1,
        "memory_peak_bytes": int(peak),
    }
    if trace:
        dev.update(busy_s=dev_trace["busy_s"], window_s=dev_trace["window_s"])
    result = {
        "correct": bool(worst) and failed == 0,
        "attempted": calls,
        "failed": failed,
        "metrics": metrics,
        "device": dev,
    }
    if trace:
        result["breakdown"] = {"device_ops": dev_trace["device_ops"], "idle_gaps": dev_trace["idle_gaps"]}
    result["checks"] = checks
    parts = {"torch and the harness": t_cell - t_start, "the program, the card and the inputs": t_warm - t_cell,
             "the library and the warm calls": setup_s - (t_warm - t_start)}
    if on_card:
        print(f"perfbench: {workload} seed {seed} on {dev['kind']}, power limit {power_limit()}; {calls} calls, "
              f"{attempts} rungs, setup {setup_s:.3f} s: {json.dumps(parts)}", file=sys.stderr)
    if trace:
        print(f"perfbench: device s by range over {profiled_calls} calls {json.dumps(dev_trace['range_device_s'])}, "
              f"ops {json.dumps(dev_trace['range_device_ops'])}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    process_env()

    import torch

    torch.set_num_threads(1)

    from perfbench import manifest

    chips = int(manifest.workload(manifest.load(), args.workload)["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); this machine has {have}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    found = forbidden_modules()
    if found:  # the window has closed: what the port loaded in this process
        print(f"perfbench: the process loaded {', '.join(found)}; no result", file=sys.stderr)
        return 4
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
