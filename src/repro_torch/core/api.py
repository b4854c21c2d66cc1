"""Public entry points of the port: the paper's sorts on p simulated processors.

* :func:`bsp_sort` — one sort of a (p, n_per_proc) array at the
  configuration's capacity; the result carries the ``overflow`` flag.
* :func:`bsp_sort_safe` / :func:`bsp_sort_safe_launch` — the overflow-safe
  sort: prepare once, then run the route stage at each rung of
  ``SortConfig.tier_ladder()`` until the flag is clean. The terminal rung's
  receive buffer holds the whole input, so no key is ever dropped.
  :class:`InFlightSort` splits it at the one host sync: reading a rung's
  overflow flag.

``algorithm`` is ``det`` (SORT_DET_BSP), ``iran`` (SORT_IRAN_BSP), ``ran``
(SORT_RAN_BSP) or ``bitonic`` ([BSI]). ``route="radix"`` replaces Ph3–Ph4
of any of the first three by one counting pass (``core/sort_radix.py``):
the launch driver reads the counted boundaries once and runs a single
rung sized to them (:func:`_radix_exact_ladder`), which cannot overflow.
``local_sort="radix"`` gives the paper's [DSR]/[RSR] and ``routing="ring"``
the p−1 rotation schedule. The
randomized sorts draw their sample positions from ``generator``, a CPU
``torch.Generator``, the counterpart of the JAX package's ``rng``: every
rung draws the next positions from it. Without one, rung r draws from a
generator seeded from ``(cfg.seed, r)``. Either way the card and the CPU
take the same sample; ``jax.random``'s own draws cannot be reproduced.

Keys are int32, uint32, float32 or bfloat16 (the kernels' dtypes; the
plain path takes the other dtypes ``torch.sort`` takes). uint32 keys are
carried as order-keeping biased int32 from entry to exit, since torch
lacks uint32 gathers and compares.
Entry points run on the CUDA device unless the caller passes ``device``
(the tests pass ``"cpu"``); with no card and no device given they raise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import primitives as prim
from .bitonic import sort_bitonic_spmd
from .sort_det import prepare_det_spmd, route_det_spmd
from .sort_iran import prepare_iran_spmd, route_iran_spmd
from .sort_radix import host_send_counts, prepare_radix_spmd, route_radix_spmd
from .sort_ran import prepare_ran_spmd, route_ran_spmd
from .splitters import sample_positions
from .types import PreparedSort, SortConfig, SortResult, resolve_device


def _prepare_bitonic_spmd(x, cfg, values=()) -> PreparedSort:
    """[BSI] is perfectly balanced (a single-rung ladder): nothing to carry."""
    return PreparedSort(xs=x, vals=tuple(values), splits=None)


def _route_bitonic_spmd(prep: PreparedSort, cfg: SortConfig, positions=None):
    return sort_bitonic_spmd(prep.xs, cfg, values=list(prep.vals))


def _route_det(prep: PreparedSort, cfg: SortConfig, positions=None):
    return route_det_spmd(prep, cfg)


#: algorithm -> (prepare(x, cfg, values), route(prep, cfg, positions));
#: the sort body is route(prepare(x)).
_PIPELINES = {
    "det": (prepare_det_spmd, _route_det),
    "iran": (prepare_iran_spmd, route_iran_spmd),
    "ran": (prepare_ran_spmd, route_ran_spmd),
    "bitonic": (_prepare_bitonic_spmd, _route_bitonic_spmd),
}
_RANDOMIZED = ("iran", "ran")


def _pipeline(cfg: SortConfig):
    """(prepare, route) of ``cfg``: ``route="radix"`` takes the counting
    pass whatever the algorithm (it replaces Ph3–Ph4, not Ph2's method)."""
    if cfg.route == "radix":
        return prepare_radix_spmd, route_radix_spmd
    return _PIPELINES[cfg.algorithm]


def _inputs(x, values, device) -> Tuple[torch.Tensor, List[torch.Tensor], torch.dtype]:
    """Tensors on the run's device, uint32 keys biased to int32; and the
    keys' own dtype, which :func:`_result` restores."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    key_dtype = x.dtype
    if key_dtype == torch.uint32:
        x = prim.bias_unsigned(x)
    return x, [torch.as_tensor(v, device=dev) for v in values], key_dtype


def _config(x: torch.Tensor, cfg: Optional[SortConfig], overrides) -> SortConfig:
    p, n_p = x.shape
    if cfg is None:
        cfg = SortConfig(p=p, n_per_proc=n_p, **overrides)
    if (cfg.p, cfg.n_per_proc) != (p, n_p):
        raise ValueError(f"config (p={cfg.p}, n_per_proc={cfg.n_per_proc}) does not match layout {tuple(x.shape)}")
    cfg.validate()
    return cfg


def _rung_generator(cfg: SortConfig, rung: int, generator: Optional[torch.Generator]):
    """The generator rung ``rung`` draws its sample from (see module doc)."""
    if generator is not None:
        return generator
    return torch.Generator().manual_seed((cfg.seed * 1_000_003 + rung) % (2**63))


def _positions(cfg: SortConfig, rung: int, generator, device) -> Optional[torch.Tensor]:
    if cfg.algorithm not in _RANDOMIZED or cfg.route == "radix":
        return None
    return sample_positions(cfg, _rung_generator(cfg, rung, generator), device)


def _result(buf, vbufs, count, overflow, key_dtype) -> Tuple[SortResult, List[torch.Tensor]]:
    if key_dtype == torch.uint32:
        buf = prim.unbias_unsigned(buf)
    return SortResult(buf=buf, count=count, overflow=overflow.any()), list(vbufs)


def bsp_sort(
    x,
    cfg: Optional[SortConfig] = None,
    *,
    values: Sequence = (),
    generator: Optional[torch.Generator] = None,
    device=None,
    **overrides,
) -> Tuple[SortResult, List[torch.Tensor]]:
    """Sort a (p, n_per_proc) array with simulated processors (one tier)."""
    x, values, key_dtype = _inputs(x, values, device)
    cfg = _config(x, cfg, overrides)
    prepare, route = _pipeline(cfg)
    out = route(prepare(x, cfg, values), cfg, _positions(cfg, 0, generator, x.device))
    return _result(*out, key_dtype)


# ------------------------------------------------- overflow-safe drivers
@dataclasses.dataclass
class TierStats:
    """Per-tier attempt counters of the capacity-escalation driver.

    ``attempts[tier]`` counts runs started at a tier, ``successes[tier]``
    the runs whose overflow flag was clean, ``retries`` the re-runs forced
    by overflow. Accumulates when one instance is passed to many calls.
    """

    attempts: Dict[str, int] = dataclasses.field(default_factory=dict)
    successes: Dict[str, int] = dataclasses.field(default_factory=dict)
    last_tier: Optional[str] = None
    retries: int = 0

    def record(self, tier: str, ok: bool) -> None:
        self.attempts[tier] = self.attempts.get(tier, 0) + 1
        if ok:
            self.successes[tier] = self.successes.get(tier, 0) + 1
            self.last_tier = tier
        else:
            self.retries += 1

    def as_row(self) -> Dict[str, int]:
        """Flat counter row: attempts, clean-run counts, total retries."""
        row = {f"tier_{t}": n for t, n in self.attempts.items()}
        row |= {f"ok_{t}": n for t, n in self.successes.items()}
        row["retries"] = self.retries
        return row


class InFlightSort:
    """A launched overflow-safe sort whose completion has not been awaited.

    Construction enqueues the first rung's route stage on the device and
    returns (PyTorch's CUDA calls are asynchronous). :meth:`wait` is the
    only host sync: it reads the rung's overflow flag and, on a fault,
    launches the next rung. ``run_tier(tier_cfg, rung) -> (SortResult,
    vbufs)``; ``rung`` is the rung's index, from which a randomized sort
    draws a fresh sample.
    ``wait`` is idempotent.
    """

    def __init__(self, ladder: tuple, stats: Optional[TierStats], run_tier: Callable) -> None:
        self.stats = stats if stats is not None else TierStats()
        self._ladder = ladder
        self._run_tier = run_tier
        self._out: Optional[Tuple[SortResult, List[torch.Tensor], TierStats]] = None
        self._i = 0
        self._pending = run_tier(ladder[0][1], 0)

    def done(self) -> bool:
        """Whether :meth:`wait` has already resolved (never blocks)."""
        return self._out is not None

    def wait(self) -> Tuple[SortResult, List[torch.Tensor], TierStats]:
        """Block until a rung's overflow flag is clean; escalate on faults."""
        if self._out is not None:
            return self._out
        while True:
            res, vbufs = self._pending
            tier = self._ladder[self._i][0]
            ok = not bool(res.overflow)  # host sync: the retry decision point
            self.stats.record(tier, ok)
            if ok:
                self._out = (res, vbufs, self.stats)
                return self._out
            self._i += 1
            if self._i >= len(self._ladder):
                raise RuntimeError(
                    "capacity escalation exhausted — unreachable: the "
                    "allgather/full tier cannot overflow (ladder: "
                    f"{[t for t, _ in self._ladder]})"
                )
            self._pending = self._run_tier(self._ladder[self._i][1], self._i)


def _radix_exact_ladder(cfg: SortConfig, prep: PreparedSort) -> tuple:
    """The radix route's whole ladder: ONE rung at the host-counted capacity.

    ``prep.splits[0]`` holds the counted (p, p+1) boundaries, so the true
    per-(src, dst) maximum and the true receive total are known before any
    data moves (a (p, p+1) int32 host read). Both are rounded up on a
    relative 1/16 grid (``step`` = the top four bits of the count) and
    clamped to the exact-tier sizes; the capacity then covers every pair,
    so the rung cannot overflow. The JAX package's sizing, unchanged.
    """
    sendc = host_send_counts(prep.splits[0])  # counts[src, dst]
    pair_true = int(sendc.max())
    recv_true = int(sendc.sum(axis=0).max())

    def _quant(true, hi):
        step = max(cfg.pad_align, 1 << max(0, true.bit_length() - 4))
        return min(hi, -(-max(true, 1) // step) * step)

    tier = dataclasses.replace(
        cfg,
        pair_capacity="planned",
        pair_cap_override=_quant(pair_true, cfg.n_per_proc),
        capacity_factor=1.0,
        n_max_mode="bound",
        n_max_override=_quant(recv_true, cfg.n),
    )
    return (("radix", tier),)


def bsp_sort_safe_launch(
    x,
    cfg: Optional[SortConfig] = None,
    *,
    values: Sequence = (),
    stats: Optional[TierStats] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
    **overrides,
) -> InFlightSort:
    """Launch an overflow-safe sort: prepare once, enqueue the first rung."""
    x, values, key_dtype = _inputs(x, values, device)
    cfg = _config(x, cfg, overrides)
    prepare, route = _pipeline(cfg)
    prep = prepare(x, cfg, values)
    ladder = cfg.tier_ladder()
    if cfg.route == "radix":
        # the counts are in hand: one rung sized to the true maxima
        ladder = _radix_exact_ladder(cfg, prep)

    def run_tier(tier_cfg: SortConfig, rung: int):
        positions = _positions(tier_cfg, rung, generator, x.device)
        return _result(*route(prep, tier_cfg, positions), key_dtype)

    return InFlightSort(ladder, stats, run_tier)


def bsp_sort_safe(
    x,
    cfg: Optional[SortConfig] = None,
    *,
    values: Sequence = (),
    stats: Optional[TierStats] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
    **overrides,
) -> Tuple[SortResult, List[torch.Tensor], TierStats]:
    """Overflow-safe :func:`bsp_sort`: escalate through the capacity ladder.

    Returns ``(result, value_bufs, stats)``; the blocking form of
    :func:`bsp_sort_safe_launch`.
    """
    return bsp_sort_safe_launch(
        x, cfg, values=values, stats=stats, generator=generator, device=device, **overrides
    ).wait()


def gathered_output(result: SortResult) -> torch.Tensor:
    """The valid prefixes of every processor, concatenated: the sorted input."""
    counts = result.count.tolist()
    return torch.cat([result.buf[k, :c] for k, c in enumerate(counts)])
