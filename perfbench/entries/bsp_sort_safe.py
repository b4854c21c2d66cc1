"""The entry the sort configurations run: ``repro_torch.core.bsp_sort_safe``.

One call sorts one input of the pool, ``(p, n / p)`` int32 keys and, where
the configuration carries a payload, the key's row id (its index in the
row-major flattened input), through the overflow-safe driver under the
configuration's ``SortConfig``, which walks the capacity ladder. The
answer judged is the whole pipeline's output: every processor's run up
to its count, in processor order, and the payload carried with each key.

The program is looked up through its modules at call time, so the trace
can open a range around each stage where its caller looks it up: Ph2
``sort_det.local_sort``, Ph3 ``splitters.splitter_stage``, Ph4
``splitters.searchsorted_tagged``, Ph5 ``routing.recv_rows`` and Ph6
``merge.merge_tree`` (``routing`` calls both through their modules).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from perfbench import reference, roofline
from perfbench import traffic as gen

PAYLOADS = {"row_id"}


class Cell:
    """The program under one configuration and one traffic mix, its pool
    of inputs made from ``seed``. ``sizes`` (``p``, ``n``) cut the cell for
    a test on the CPU; a run on the card takes the files' sizes."""

    def __init__(self, spec: Dict, traffic: Dict, seed: int, device, sizes: Optional[Dict] = None) -> None:
        from repro_torch import core
        from repro_torch.core import merge, routing, sort_det, splitters

        sizes = sizes or {}
        if spec.get("key_dtype") != "int32":
            raise ValueError(f"this entry sorts int32 keys, not {spec.get('key_dtype')!r}")
        if not set(spec.get("payloads", ())) <= PAYLOADS:
            raise ValueError(f"unknown payloads {spec['payloads']} (known: {sorted(PAYLOADS)})")
        sc = dict(spec["sort_config"])
        p = int(sizes.get("p", sc.pop("p")))
        n = int(sizes.get("n", traffic["n"]))
        if n % p:
            raise ValueError(f"n = {n} keys do not divide over p = {p} processors")
        self.core = core
        self.device = torch.device(device)
        self.keys_per_call = n
        self.cfg = core.SortConfig(p=p, n_per_proc=n // p, **sc)
        self.cfg.validate()
        self.pool = gen.make_pool(traffic, p, n // p, seed, self.device)
        self.values = [
            torch.arange(n, dtype=torch.int32, device=self.device).reshape(p, n // p)
            for _ in spec.get("payloads", ())
        ]
        self.stats = core.TierStats()
        payload_bytes = 4 * len(self.values)
        self.ranges = [
            (sort_det, "local_sort", "local_sort"),
            (splitters, "splitter_stage", "splitters"),
            (splitters, "searchsorted_tagged", "partition"),
            (routing, "recv_rows", "exchange"),
            (merge, "merge_tree", "merge_tree"),
        ]
        self.stage_bytes = {
            "local_sort": roofline.sort_stage_bytes(n, 4, payload_bytes),
            "merge_tree": roofline.sort_stage_bytes(n, 4, payload_bytes),
        }

    def start_window(self) -> None:
        self.stats = self.core.TierStats()

    def rung_attempts(self) -> int:
        return sum(self.stats.attempts.values())

    def trace_with(self, tracer) -> None:
        """Record the program's ``prepare``/``route`` spans from now on."""
        self.cfg = dataclasses.replace(self.cfg, obs=tracer)

    def call(self, i: int):
        k = i % len(self.pool)
        res, vbufs, _ = self.core.bsp_sort_safe(
            self.pool[k], self.cfg, values=self.values, stats=self.stats, device=self.device
        )
        return k, res, vbufs

    def check(self, answer) -> Dict[str, int]:
        """The reference's counts for one answer of :meth:`call`."""
        k, res, vbufs = answer
        valid = torch.arange(res.buf.shape[1], device=res.buf.device) < res.count[:, None]
        keys = res.buf[valid]
        vals = vbufs[0][valid] if vbufs else None
        return reference.judge(keys, vals, self.pool[k], self.values[0] if self.values else None)
