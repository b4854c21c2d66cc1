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

The stage callables live in a :class:`SortExecutor` keyed as the JAX
package's registry is: prepare on ``SortConfig.prepare_key()`` (every rung
of a ladder shares one prepared state), route and sort on the rung's
config and the payload count. The port compiles nothing, so an entry
holds the stage functions bound to their config, and ``trace_counts``
counts builds: one per key, as the reference counts one trace per key.
``SortConfig(obs=tracer)`` records a ``prepare`` span (synchronized with
the device, so it includes the device's time), a ``route`` span per rung
closed at the rung's overflow read, and the distribution and host-sync
points (``repro_torch.obs``); an untraced run adds no host sync.
``planner=`` (a :class:`repro_torch.planner.CapacityPlanner`) starts the
ladder at the rung its history learned for the sort's shape.
``SortConfig(chaos=plan)`` (``repro_torch.chaos``) injects capacity faults
at the overflow read of non-terminal rungs.
:func:`phase_fns` gives the paper's Ph2–Ph6 as separate callables. The
sharded runner (``bsp_sort_sharded``) is not ported yet.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..chaos import resolve_chaos
from ..obs import REGISTRY as _OBS
from ..obs import resolve_tracer
from . import merge as merge_mod
from . import primitives as prim
from . import routing, splitters
from .bitonic import sort_bitonic_spmd
from .local_sort import local_sort
from .sort_det import prepare_det_spmd, route_det_spmd
from .sort_iran import prepare_iran_spmd, route_iran_spmd
from .sort_radix import host_send_counts, prepare_radix_spmd, route_radix_spmd
from .sort_ran import prepare_ran_spmd, route_ran_spmd
from .splitters import sample_positions
from .types import PreparedSort, SortConfig, SortResult, resolve_device, to_device


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
    x = to_device(x, dev)
    key_dtype = x.dtype
    if key_dtype == torch.uint32:
        x = prim.bias_unsigned(x)
    return x, [to_device(v, dev) for v in values], key_dtype


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
        # every attempt is mirrored into the process-wide registry once;
        # merge_from does not mirror again
        self.attempts[tier] = self.attempts.get(tier, 0) + 1
        _OBS.counter("sort.tier_attempts", tier=tier).inc()
        if ok:
            self.successes[tier] = self.successes.get(tier, 0) + 1
            self.last_tier = tier
            _OBS.counter("sort.tier_ok", tier=tier).inc()
        else:
            self.retries += 1
            _OBS.counter("sort.retries").inc()

    def merge_from(self, other: "TierStats") -> None:
        """Fold another instance's counters in (one batch into an
        accumulator), without mirroring them into the registry again."""
        for t, n in other.attempts.items():
            self.attempts[t] = self.attempts.get(t, 0) + n
        for t, n in other.successes.items():
            self.successes[t] = self.successes.get(t, 0) + n
        self.retries += other.retries
        if other.last_tier is not None:
            self.last_tier = other.last_tier

    def as_row(self) -> Dict[str, int]:
        """Flat counter row: attempts, clean-run counts, total retries."""
        row = {f"tier_{t}": n for t, n in self.attempts.items()}
        row |= {f"ok_{t}": n for t, n in self.successes.items()}
        row["retries"] = self.retries
        return row


class SortExecutor:
    """Registry of the sort's stage callables, keyed as the JAX package's.

    * ``prepare`` entries key on ``cfg.prepare_key()``: every rung of a
      capacity ladder shares one prepare callable and one
      :class:`PreparedSort`;
    * ``route``/``sort`` entries key on the rung's full config (a frozen
      dataclass; ``obs`` is not part of its hash) and the payload count.

    The keys' second element names the simulated-processor runner
    (``"vmap"`` in the JAX package, kept so both packages' keys read
    alike). ``trace_counts[key]`` counts the builds of each entry, so
    "one per key" is the reuse invariant here as it is there. An entry is
    where a captured CUDA graph per rung would live. The sharded runner's
    entries (``prepare_sharded`` etc.) are not ported yet.
    """

    def __init__(self) -> None:
        self._fns: Dict[tuple, Callable] = {}
        self.trace_counts: Dict[tuple, int] = {}

    def _get(self, key: tuple, build: Callable[[], Callable]) -> Callable:
        fn = self._fns.get(key)
        if fn is None:
            self.trace_counts[key] = self.trace_counts.get(key, 0) + 1
            fn = self._fns[key] = build()
        return fn

    def prepare_vmap(self, cfg: SortConfig, n_values: int) -> Callable:
        """``run(x, *vals) -> PreparedSort`` of the config's prepare stage."""
        pcfg = cfg.prepare_key()

        def build():
            prepare = _pipeline(pcfg)[0]
            return lambda x, *vals: prepare(x, pcfg, list(vals))

        return self._get(("prepare", "vmap", pcfg, n_values), build)

    def route_vmap(self, tier_cfg: SortConfig, n_values: int) -> Callable:
        """``run(prep, positions) -> (buf, vbufs, count, overflow)`` of a rung."""

        def build():
            route = _pipeline(tier_cfg)[1]
            return lambda prep, positions: route(prep, tier_cfg, positions)

        return self._get(("route", "vmap", tier_cfg, n_values), build)

    def sort_vmap(self, cfg: SortConfig, n_values: int) -> Callable:
        """``run(x, positions, *vals)``: prepare and route in one call (the
        whole sort per rung, ``resume=False``)."""

        def build():
            prepare, route = _pipeline(cfg)
            return lambda x, positions, *vals: route(prepare(x, cfg, list(vals)), cfg, positions)

        return self._get(("sort", "vmap", cfg, n_values), build)


#: process-wide default registry; drivers take ``executor=`` for isolation.
_EXECUTOR = SortExecutor()


def default_executor() -> SortExecutor:
    return _EXECUTOR


class InFlightSort:
    """A launched overflow-safe sort whose completion has not been awaited.

    Construction enqueues the first rung's route stage on the device and
    returns (PyTorch's CUDA calls are asynchronous). :meth:`wait` is the
    only host sync: it reads the rung's overflow flag and, on a fault,
    launches the next rung. ``run_tier(tier_cfg, rung) -> (SortResult,
    vbufs)``; ``rung`` is the rung's index, from which a randomized sort
    draws a fresh sample. ``ladder`` is (a suffix of) the config's
    ``tier_ladder()``: a planner may slice the doomed cheap rungs off.
    ``scope`` is a context factory entered around every launch;
    ``on_complete(stats)`` runs once, after the winning rung (the planner's
    feedback rides it). ``wait`` is idempotent.

    ``tracer``/``trace_meta`` (``repro_torch.obs``) record one "route"
    span per rung, opened at its launch and closed at its overflow read,
    with the rung's h-relation size, superstep count and received-key
    balance; the counts are read after the flag, the sync already made.

    ``chaos`` (a :class:`repro_torch.chaos.FaultPlan`) draws the sort's
    sequence number at construction, as the JAX package does; :meth:`wait`
    then flips a clean, non-terminal rung's decision to a fault when the
    plan's ``fault_capacity(sort_seq, rung)`` says so. The escalation it
    forces is the real one, and the next rung's result is the clean run's.
    """

    def __init__(
        self,
        ladder: tuple,
        stats: Optional[TierStats],
        run_tier: Callable,
        *,
        scope: Optional[Callable] = None,
        on_complete: Optional[Callable] = None,
        tracer=None,
        trace_meta: Optional[Dict] = None,
        chaos=None,
    ) -> None:
        self.stats = stats if stats is not None else TierStats()
        self._ladder = ladder
        self._run_tier = run_tier
        self._scope = scope if scope is not None else contextlib.nullcontext
        self._on_complete = on_complete
        self._tracer = tracer
        self._chaos = chaos
        self._chaos_key = chaos.next_sort() if chaos is not None else 0
        self._meta = trace_meta if trace_meta is not None else {}
        #: timeline lane of this sort's spans (None when untraced); the
        #: segmented sort attaches its own points to it
        self.trace_tid = self._meta.get("tid") if tracer is not None else None
        self._out: Optional[Tuple[SortResult, List[torch.Tensor], TierStats]] = None
        self._i = 0
        self._t_launch = tracer.now() if tracer is not None else 0.0
        with self._scope():
            self._pending = run_tier(ladder[0][1], 0)

    def done(self) -> bool:
        """Whether :meth:`wait` has already resolved (never blocks)."""
        return self._out is not None

    def _record_route(self, res: SortResult, tier: str, tier_cfg: SortConfig, ok: bool, t_sync: float) -> None:
        """Close the launch-opened route span at the overflow read."""
        tr = self._tracer
        t_end = tr.now()
        cat = self._meta.get("cat", "sort")
        tid = self.trace_tid or "main"
        counts = res.count.cpu().numpy()
        recv_max = int(counts.max())
        recv_mean = float(counts.mean())
        row_bytes = int(self._meta.get("row_bytes", 4))
        # h in 32-bit words: the larger of what any processor sent (its
        # n_per_proc rows) and received, times the fused exchange's row width
        h_words = (max(recv_max, tier_cfg.n_per_proc) * row_bytes) // 4
        args = dict(
            tier=tier,
            rung=self._i,
            ok=ok,
            sync_s=round(t_end - t_sync, 6),
            h_words=h_words,
            supersteps=routing.route_supersteps(tier_cfg.routing, tier_cfg.p),
            recv_max=recv_max,
            recv_mean=recv_mean,
            imbalance=(recv_max / recv_mean) if recv_mean > 0 else 1.0,
        )
        if tier_cfg.p <= 64:
            args["recv"] = counts.tolist()  # per-processor key counts
        tr.add_span("route", self._t_launch, t_end=t_end, cat=cat, tid=tid, **args)
        tr.point("host_sync", cat=cat, tid=tid, what="overflow", rung=self._i, ok=ok)

    def wait(self) -> Tuple[SortResult, List[torch.Tensor], TierStats]:
        """Block until a rung's overflow flag is clean; escalate on faults."""
        if self._out is not None:
            return self._out
        while True:
            res, vbufs = self._pending
            tier, tier_cfg = self._ladder[self._i]
            t_sync = self._tracer.now() if self._tracer is not None else 0.0
            ok = not bool(res.overflow)  # host sync: the retry decision point
            if (
                ok
                and self._chaos is not None
                and self._i + 1 < len(self._ladder)  # the terminal rung is never faulted
                and self._chaos.fault_capacity(self._chaos_key, self._i)
            ):
                ok = False  # injected capacity fault: walk the next rung
                if self._tracer is not None:
                    self._tracer.point("chaos_capacity_fault", cat="chaos", tid=self.trace_tid or "main",
                                       rung=self._i, tier=tier)
            if self._tracer is not None:
                self._record_route(res, tier, tier_cfg, ok, t_sync)
            self.stats.record(tier, ok)
            if ok:
                self._out = (res, vbufs, self.stats)
                if self._on_complete is not None:
                    self._on_complete(self.stats)
                return self._out
            self._i += 1
            if self._i >= len(self._ladder):
                raise RuntimeError(
                    "capacity escalation exhausted — unreachable: the "
                    "allgather/full tier cannot overflow (ladder: "
                    f"{[t for t, _ in self._ladder]})"
                )
            if self._tracer is not None:
                self._t_launch = self._tracer.now()
            with self._scope():
                self._pending = self._run_tier(self._ladder[self._i][1], self._i)


def _escalate(
    ladder: tuple,
    stats: Optional[TierStats],
    run_tier: Callable,
    *,
    tracer=None,
    trace_meta: Optional[Dict] = None,
) -> Tuple[SortResult, List[torch.Tensor], TierStats]:
    """Blocking escalation: launch rung 0 and wait through the ladder."""
    return InFlightSort(ladder, stats, run_tier, tracer=tracer, trace_meta=trace_meta).wait()


def _trace_meta_for(tracer, x: torch.Tensor, values, cat: str = "sort") -> Optional[Dict]:
    """Per-launch trace metadata: a fresh timeline lane and the packed row
    width of the fused exchange."""
    if tracer is None:
        return None
    return {
        "tid": tracer.next_tid("sort"),
        "cat": cat,
        "row_bytes": routing.packed_row_bytes(x.dtype, [v.dtype for v in values]),
    }


def _host_keys(t: torch.Tensor) -> np.ndarray:
    """Keys on the host in an order-keeping numpy dtype (bfloat16 as float32)."""
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def _trace_prepared(tracer, meta: Dict, cfg: SortConfig, prep: PreparedSort) -> None:
    """Record the prepared distribution snapshot (traced runs only).

    ``route="radix"``: the counted boundaries give the exact per-(src, dst)
    send counts of the coming h-relation. ``det``: the splitters are in
    hand, and searching each run for them gives the splitter-implied
    boundary estimate (tag-blind) and the oversampling skew. iran/ran draw
    their sample in the route stage, so nothing is prepared to read.
    """
    tid, cat = meta["tid"], meta.get("cat", "sort")
    row_bytes = int(meta.get("row_bytes", 4))
    if cfg.route == "radix" and prep.splits is not None:
        sendc = host_send_counts(prep.splits[0])  # (p, p) exact counts
        recv = sendc.sum(axis=0)
        args = dict(
            kind="radix_counts",
            pair_max=int(sendc.max()),
            recv_max=int(recv.max()),
            imbalance=float(recv.max() / recv.mean()) if recv.mean() > 0 else 1.0,
            row_bytes=row_bytes,
        )
        if cfg.p <= 64:
            args["send_bytes"] = (sendc * row_bytes).tolist()  # per (src, dst)
        tracer.point("distribution", cat=cat, tid=tid, **args)
    elif cfg.algorithm == "det" and cfg.route == "sample" and prep.splits:
        keys = _host_keys(prep.splits[0][0])  # replicated (p-1,) splitter keys
        xs = _host_keys(prep.xs)  # (p, n_per_proc), locally sorted
        bounds = np.stack([np.searchsorted(row, keys) for row in xs])
        sendc = np.diff(
            np.concatenate(
                [np.zeros((cfg.p, 1), np.int64), bounds, np.full((cfg.p, 1), xs.shape[1], np.int64)], axis=1
            ),
            axis=1,
        )
        recv = sendc.sum(axis=0)
        args = dict(
            kind="splitter_estimate",
            pair_max=int(sendc.max()),
            recv_max=int(recv.max()),
            skew=float(recv.max() / recv.mean()) if recv.mean() > 0 else 1.0,
            omega=cfg.omega_eff,
            sample_size=cfg.s,
            row_bytes=row_bytes,
        )
        if cfg.p <= 64:
            args["send_bytes"] = (sendc * row_bytes).tolist()  # per (src, dst)
        tracer.point("distribution", cat=cat, tid=tid, **args)


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
    executor: Optional[SortExecutor] = None,
    resume: bool = True,
    planner=None,
    scope: Optional[Callable] = None,
    **overrides,
) -> InFlightSort:
    """Launch an overflow-safe sort: prepare once, enqueue the first rung.

    ``resume=False`` runs the whole sort (prepare and route) at every
    rung, the behaviour before the phase pipeline. ``planner`` starts the
    ladder at the rung learned for the bucket
    ``sort/{algorithm}/p{p}/npp{n_per_proc}/{pair_capacity}`` (the JAX
    package's name, letter for letter, so both packages' histories
    interoperate) and is told on completion whether the start faulted.
    ``scope`` is a context factory entered around every device launch.
    """
    x, values, key_dtype = _inputs(x, values, device)
    cfg = _config(x, cfg, overrides)
    tracer = resolve_tracer(cfg.obs)
    chaos = resolve_chaos(cfg.chaos)
    if cfg.obs is not None or cfg.chaos is not None:
        # the tracer and the fault plan stay locals: the ladder and the
        # executor see obs=None and chaos=None (neither is part of the
        # config's hash anyway), so no registry key ever holds one
        cfg = dataclasses.replace(cfg, obs=None, chaos=None)
    meta = _trace_meta_for(tracer, x, values)
    ex = executor if executor is not None else _EXECUTOR
    nv = len(values)
    p, n_p = x.shape

    ladder = cfg.tier_ladder()
    bucket = None
    if planner is not None and len(ladder) > 1:
        bucket = f"sort/{cfg.algorithm}/p{p}/npp{n_p}/{cfg.pair_capacity}"
        ladder = ladder[planner.rung_for(bucket, len(ladder)) :]
    stats = stats if stats is not None else TierStats()
    retries_before = stats.retries

    on_complete = None
    if bucket is not None:
        n_rungs = len(cfg.tier_ladder())

        def on_complete(st: TierStats, _bucket=bucket) -> None:
            planner.observe(_bucket, st.retries > retries_before, n_rungs)

    enter = scope if scope is not None else contextlib.nullcontext
    if not resume:

        def run_tier(tier_cfg: SortConfig, rung: int):
            positions = _positions(tier_cfg, rung, generator, x.device)
            return _result(*ex.sort_vmap(tier_cfg, nv)(x, positions, *values), key_dtype)

    else:
        if tracer is not None:
            # a traced run waits for the device at the stage boundary, so the
            # prepare span includes the device's time and the route spans
            # start clean; an untraced run stays asynchronous
            with tracer.span("prepare", tid=meta["tid"], algorithm=cfg.algorithm, route=cfg.route,
                             p=p, n_per_proc=n_p):
                with enter():
                    prep = ex.prepare_vmap(cfg, nv)(x, *values)
                if x.device.type == "cuda":
                    torch.cuda.synchronize(x.device)
            _trace_prepared(tracer, meta, cfg, prep)
        else:
            with enter():
                prep = ex.prepare_vmap(cfg, nv)(x, *values)
        if cfg.route == "radix":
            # the counts are in hand: one rung sized to the true maxima
            if tracer is not None:
                tracer.point("host_sync", tid=meta["tid"], what="radix_counts")
            ladder = _radix_exact_ladder(cfg, prep)

        def run_tier(tier_cfg: SortConfig, rung: int):
            positions = _positions(tier_cfg, rung, generator, x.device)
            return _result(*ex.route_vmap(tier_cfg, nv)(prep, positions), key_dtype)

    return InFlightSort(ladder, stats, run_tier, scope=scope, on_complete=on_complete, tracer=tracer,
                        trace_meta=meta, chaos=chaos)


def bsp_sort_safe(
    x,
    cfg: Optional[SortConfig] = None,
    *,
    values: Sequence = (),
    stats: Optional[TierStats] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
    executor: Optional[SortExecutor] = None,
    resume: bool = True,
    planner=None,
    scope: Optional[Callable] = None,
    **overrides,
) -> Tuple[SortResult, List[torch.Tensor], TierStats]:
    """Overflow-safe :func:`bsp_sort`: escalate through the capacity ladder.

    Returns ``(result, value_bufs, stats)``; the blocking form of
    :func:`bsp_sort_safe_launch`, byte-identical to it.
    """
    return bsp_sort_safe_launch(
        x, cfg, values=values, stats=stats, generator=generator, device=device, executor=executor,
        resume=resume, planner=planner, scope=scope, **overrides,
    ).wait()


def gathered_output(result: SortResult) -> torch.Tensor:
    """The valid prefixes of every processor, concatenated: the sorted input."""
    counts = result.count.tolist()
    return torch.cat([result.buf[k, :c] for k, c in enumerate(counts)])


# ------------------------------------------------- phase-decomposed (bench)
def phase_fns(
    cfg: SortConfig, generator: Optional[torch.Generator] = None
) -> Dict[str, Callable]:
    """The paper's phases (Tables 4–7) as separate callables over the
    (p, n_per_proc) layout, each taking the previous phase's output, so a
    benchmark can wait between them: SeqSort (Ph2), Sampling (Ph3), Prefix
    (Ph4), Routing (Ph5, which returns ``(buf, count, overflow)``) and
    Merging (Ph6). Each calls the stage function the sorts use. Sampling
    of a randomized sort draws rung 0's positions (from ``generator``, as
    the drivers do).
    """
    cfg.validate()

    def ph3(xs):
        return splitters.splitter_stage(xs, cfg, _positions(cfg, 0, generator, xs.device))

    def ph5(xs, bounds):
        buf, _, count, overflow = routing.route(xs, bounds, cfg)
        return buf, count, overflow

    return {
        "SeqSort": lambda x: local_sort(x, cfg.local_sort)[0],
        "Sampling": ph3,
        "Prefix": lambda xs, splits: splitters.searchsorted_tagged(xs, splits),
        "Routing": ph5,
        "Merging": lambda buf: merge_mod.merge_by_sort(buf)[0],
    }
