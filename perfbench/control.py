#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the card at its own size.

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 [--program] [--controls int16,unstable]

For every seed the cell's pool is made as a run makes it. ``--program``
sorts each input of the pool through the cell's entry and judges the
answer against the reference (the lower readings); each control of
``reference.control`` stands in the program's place on the same inputs
(the upper readings). One JSON line per seed, side and input; the
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def readings(workload: str, seeds, program: bool, controls, device="cuda", sizes=None):
    """Yield one dict of counts per (seed, side, input of the pool)."""
    import torch

    from perfbench import manifest, reference

    bench = manifest.load()
    wl = manifest.workload(bench, workload)
    conf = manifest.config(bench, wl["config"])
    traffic = manifest.traffic(wl["traffic"])
    entry = manifest.entry(conf["spec"]["entry"])
    for seed in seeds:
        cell = entry.Cell(conf["spec"], traffic, seed, torch.device(device), sizes)
        vals = cell.values[0] if cell.values else None
        for k, keys in enumerate(cell.pool):
            if program:
                nums = cell.check(cell.call(k))
                yield dict(workload=workload, seed=seed, input=k, side="program", **nums)
            for mode in controls:
                gen = torch.Generator(device=device).manual_seed(seed)
                got_keys, got_vals = reference.control(keys, vals, mode, gen)
                nums = reference.judge(got_keys, got_vals, keys, vals)
                yield dict(workload=workload, seed=seed, input=k, side=f"control:{mode}", **nums)
        del cell
        if device == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--controls", default="int16")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    controls = [c for c in args.controls.split(",") if c]
    for row in readings(args.workload, seeds, args.program, controls):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
