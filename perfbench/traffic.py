"""The one general generator of the benchmark's key sets.

A traffic file (``traffic/<name>.json``) holds only parameters::

    {"keys": {"dist": "uniform", "low": 0, "high": 2147483647}, "n": 134217728}

``keys`` names a distribution and its parameters, ``n`` the keys of one
call. A run draws a pool of ``POOL`` distinct inputs and cycles through
it, so no call sorts what the call before it sorted and the working set
exceeds the card's 50 MB L2. Every draw comes from one ``torch.Generator``
seeded by the run's ``--seed``, on the device the run uses, so a seed
fixes the inputs. The distributions are copies of the port's
``core/datagen.py`` generators made on the device; they need not match
numpy's draws bit for bit. Each distribution here can be named by a
traffic file alone, so a cell that a later change adds on one of them
needs no new code.

* ``uniform`` — [U]: keys uniform in ``[low, high)``.
* ``zipf`` — [zipf]: value v with frequency ∝ v^-alpha (numpy's rejection
  sampler, Devroye's algorithm), clamped to ``cap``.
* ``dd`` — [DD], the paper's deterministic duplicates: seedless.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

INT32_MAX = 2**31 - 1
POOL = 4


def uniform(spec: Dict, p: int, n_p: int, gen: torch.Generator, device) -> torch.Tensor:
    low, high = int(spec.get("low", 0)), int(spec.get("high", INT32_MAX))
    return torch.randint(low, high, (p, n_p), generator=gen, device=device, dtype=torch.int32)


def zipf(spec: Dict, p: int, n_p: int, gen: torch.Generator, device) -> torch.Tensor:
    """Zipf(alpha) keys by rejection, as ``numpy.random.Generator.zipf``
    draws them, in float64 on the device; values above ``cap`` clamp to it."""
    alpha = float(spec["alpha"])
    cap = int(spec.get("cap", INT32_MAX - 1))
    am1 = alpha - 1.0
    b = 2.0**am1
    need = p * n_p
    parts, have = [], 0
    while have < need:
        m = int((need - have) * 1.25) + 1024
        u = 1.0 - torch.rand(m, generator=gen, device=device, dtype=torch.float64)  # (0, 1]
        v = torch.rand(m, generator=gen, device=device, dtype=torch.float64)
        x = torch.floor(u.pow(-1.0 / am1))
        t = (1.0 + 1.0 / x).pow(am1)
        ok = (x >= 1.0) & (v * x * (t - 1.0) / (b - 1.0) <= t / b)
        got = x[ok][: need - have]
        parts.append(torch.clamp(got, max=float(cap)).to(torch.int32))
        have += got.numel()
    return torch.cat(parts).reshape(p, n_p)


def dd(spec: Dict, p: int, n_p: int, gen: torch.Generator, device) -> torch.Tensor:
    """[DD]: the first p/2 processors hold lg n, the next p/4 lg(n/2), ...;
    the last processor's run is halved into runs of lg(n/p), lg(n/2p), ..."""
    n = p * n_p
    x = torch.zeros((p, n_p), dtype=torch.int32, device=device)
    start, size, v = 0, max(p // 2, 1), int(math.log2(max(n, 2)))
    while start < p - 1 and size >= 1:
        x[start : min(start + size, p - 1)] = v
        start += size
        size = max(size // 2, 1)
        v = max(v - 1, 0)
        if size == 1 and start >= p - 1:
            break
    off, run, v = 0, max(n_p // 2, 1), int(math.log2(max(n // p, 2)))
    while off < n_p:
        x[p - 1, off : off + run] = v
        off += run
        run = max(run // 2, 1)
        v = max(v - 1, 0)
    return x


DISTRIBUTIONS = {"uniform": uniform, "zipf": zipf, "dd": dd}


def make_keys(spec: Dict, p: int, n_p: int, gen: torch.Generator, device) -> torch.Tensor:
    """One (p, n_p) int32 input of the distribution ``spec["dist"]``."""
    return DISTRIBUTIONS[spec["dist"]](spec, p, n_p, gen, device)


def make_pool(traffic: Dict, p: int, n_p: int, seed: int, device) -> list:
    """The window's ``POOL`` distinct inputs, all drawn from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return [make_keys(traffic["keys"], p, n_p, gen, device) for _ in range(POOL)]
