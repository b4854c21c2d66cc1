"""Public entry points of the port: SORT_DET_BSP on p simulated processors.

* :func:`bsp_sort` — one sort of a (p, n_per_proc) array at the
  configuration's capacity; the result carries the ``overflow`` flag.
* :func:`bsp_sort_safe` / :func:`bsp_sort_safe_launch` — the overflow-safe
  driver: prepare (Ph2 + Ph3) once, then run the route stage (Ph4–Ph6) at
  each rung of ``SortConfig.tier_ladder()`` until the flag is clean. The
  terminal rung's receive buffer holds the whole input, so no key is ever
  dropped. :class:`InFlightSort` splits it at the one host sync: reading a
  rung's overflow flag.

Entry points run on the CUDA device unless the caller passes ``device``
(the tests pass ``"cpu"``); with no card and no device given they raise.
Only ``algorithm="det"`` with ``route="sample"`` is ported so far.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from .sort_det import prepare_det_spmd, route_det_spmd, sort_det_spmd
from .types import SortConfig, SortResult, resolve_device


def _check_ported(cfg: SortConfig) -> None:
    cfg.validate()
    if cfg.algorithm != "det" or cfg.route != "sample":
        raise NotImplementedError(
            f"algorithm={cfg.algorithm!r}, route={cfg.route!r} is not ported yet "
            "(only det/sample; see ROADMAP.md, queue 1)"
        )


def _inputs(x, values, device) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    dev = resolve_device(device)
    return torch.as_tensor(x, device=dev), [torch.as_tensor(v, device=dev) for v in values]


def _config(x: torch.Tensor, cfg: Optional[SortConfig], overrides) -> SortConfig:
    p, n_p = x.shape
    if cfg is None:
        cfg = SortConfig(p=p, n_per_proc=n_p, **overrides)
    if (cfg.p, cfg.n_per_proc) != (p, n_p):
        raise ValueError(f"config (p={cfg.p}, n_per_proc={cfg.n_per_proc}) does not match layout {tuple(x.shape)}")
    _check_ported(cfg)
    return cfg


def _result(buf, vbufs, count, overflow) -> Tuple[SortResult, List[torch.Tensor]]:
    return SortResult(buf=buf, count=count, overflow=overflow.any()), list(vbufs)


def bsp_sort(
    x,
    cfg: Optional[SortConfig] = None,
    *,
    values: Sequence = (),
    device=None,
    **overrides,
) -> Tuple[SortResult, List[torch.Tensor]]:
    """Sort a (p, n_per_proc) array with simulated processors (one tier)."""
    x, values = _inputs(x, values, device)
    cfg = _config(x, cfg, overrides)
    return _result(*sort_det_spmd(x, cfg, values))


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
    launches the next rung. ``run_tier(tier_cfg) -> (SortResult, vbufs)``.
    ``wait`` is idempotent.
    """

    def __init__(self, ladder: tuple, stats: Optional[TierStats], run_tier: Callable) -> None:
        self.stats = stats if stats is not None else TierStats()
        self._ladder = ladder
        self._run_tier = run_tier
        self._out: Optional[Tuple[SortResult, List[torch.Tensor], TierStats]] = None
        self._i = 0
        self._pending = run_tier(ladder[0][1])

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
            self._pending = self._run_tier(self._ladder[self._i][1])


def bsp_sort_safe_launch(
    x,
    cfg: Optional[SortConfig] = None,
    *,
    values: Sequence = (),
    stats: Optional[TierStats] = None,
    device=None,
    **overrides,
) -> InFlightSort:
    """Launch an overflow-safe sort: prepare once, enqueue the first rung."""
    x, values = _inputs(x, values, device)
    cfg = _config(x, cfg, overrides)
    prep = prepare_det_spmd(x, cfg, values)

    def run_tier(tier_cfg: SortConfig):
        return _result(*route_det_spmd(prep, tier_cfg))

    return InFlightSort(cfg.tier_ladder(), stats, run_tier)


def bsp_sort_safe(
    x,
    cfg: Optional[SortConfig] = None,
    *,
    values: Sequence = (),
    stats: Optional[TierStats] = None,
    device=None,
    **overrides,
) -> Tuple[SortResult, List[torch.Tensor], TierStats]:
    """Overflow-safe :func:`bsp_sort`: escalate through the capacity ladder.

    Returns ``(result, value_bufs, stats)``; the blocking form of
    :func:`bsp_sort_safe_launch`.
    """
    return bsp_sort_safe_launch(
        x, cfg, values=values, stats=stats, device=device, **overrides
    ).wait()


def gathered_output(result: SortResult) -> torch.Tensor:
    """The valid prefixes of every processor, concatenated: the sorted input."""
    counts = result.count.tolist()
    return torch.cat([result.buf[k, :c] for k, c in enumerate(counts)])
