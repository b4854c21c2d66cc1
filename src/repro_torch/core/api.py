"""Public entry points of the port: the paper's sorts on p processors.

Two runners share one SPMD implementation, as in the JAX package:

* :func:`bsp_sort` — p simulated processors in one process: the
  (p, n_per_proc) layout, the processor as dimension 0
  (``primitives.LocalProcs``).
* :func:`bsp_sort_sharded` — one processor per rank of a mesh axis
  (``torch.distributed``; ``primitives.GroupProcs``): each rank passes its
  own (1, n_per_proc) row and gets its own row of the result, the same
  bytes as the matching row of :func:`bsp_sort`. Every collective of the
  stages (the Ph4 count exchange, the fused Ph5 h-relation, the sample
  gathers, the flags' ``pmax``, the XOR and ring permutations, the radix
  extremes) is then one call on the axis's process group.

The entry points:

* :func:`bsp_sort` — one sort of a (p, n_per_proc) array at the
  configuration's capacity; the result carries the ``overflow`` flag.
* :func:`bsp_sort_safe` / :func:`bsp_sort_safe_launch` — the overflow-safe
  sort: prepare once, then run the route stage at each rung of
  ``SortConfig.tier_ladder()`` until the flag is clean. The terminal rung's
  receive buffer holds the whole input, so no key is ever dropped.
  :class:`InFlightSort` splits it at the one host sync: reading a rung's
  overflow flag.
* :func:`bsp_sort_sharded_safe` — the same escalation over a mesh axis;
  the flag is the group's ``any``, so every rank climbs the ladder with
  the others.

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
A sharded sort's ranks each draw the whole (p, s) table (from equally
seeded generators) and keep their own row, so they take the same sample
as :func:`bsp_sort`.

Keys are int32, uint32, float32 or bfloat16 (the kernels' dtypes; the
plain path takes the other dtypes ``torch.sort`` takes). uint32 keys are
carried as order-keeping biased int32 from entry to exit, since torch
lacks uint32 gathers and compares.
Entry points run on the CUDA device unless the caller passes ``device``
(the tests pass ``"cpu"``); with no card and no device given they raise.

The stage callables live in a :class:`SortExecutor` keyed as the JAX
package's registry is: prepare on ``SortConfig.prepare_key()`` (every rung
of a ladder shares one prepared state), route and sort on the rung's
config and the payload count, and a sharded entry on the mesh and its
axis too. The port compiles nothing, so an entry
holds the stage functions bound to their config, and ``trace_counts``
counts builds: one per key, as the reference counts one trace per key.
``SortConfig(obs=tracer)`` records a ``prepare`` span (synchronized with
the device, so it includes the device's time), a ``route`` span per rung
closed at the rung's overflow read, each with the stream's time between
CUDA events at its edges (``stream_ms``), and the distribution and
host-sync points (``repro_torch.obs``). The driver enters an
``obs.trace.lane`` around the prepare stage and around each rung's
launch, so the stages inside (Ph2 ``local_sort`` with its ``tiles`` and
``rank_merge``, Ph3 ``splitters``, Ph4 ``partition``, Ph5 ``exchange``,
Ph6 ``merge_tree``/``merge_sort``) record ``stage`` spans on the sort's
lane; :func:`bsp_sort` enters the same lanes. Under ``torch.profiler``
the lanes and stages are ``bsp:`` ranges, traced or not. The tracer's
events are read at the syncs the driver makes anyway: beyond the prepare
span's synchronize, a traced run adds no host sync, and an untraced one
none at all.
``planner=`` (a :class:`repro_torch.planner.CapacityPlanner`) starts the
ladder at the rung its history learned for the sort's shape.
``SortConfig(chaos=plan)`` (``repro_torch.chaos``) injects capacity faults
at the overflow read of non-terminal rungs.
:func:`phase_fns` gives the paper's Ph2–Ph6 as separate callables.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..chaos import resolve_chaos
from ..obs import REGISTRY as _OBS
from ..obs import resolve_tracer
from ..obs.trace import lane as trace_lane
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


def _prepare_bitonic_spmd(x, cfg, values=(), procs=None) -> PreparedSort:
    """[BSI] is perfectly balanced (a single-rung ladder): nothing to carry."""
    return PreparedSort(xs=x, vals=tuple(values), splits=None)


def _route_bitonic_spmd(prep: PreparedSort, cfg: SortConfig, positions=None, procs=None):
    return sort_bitonic_spmd(prep.xs, cfg, values=list(prep.vals), procs=procs)


def _route_det(prep: PreparedSort, cfg: SortConfig, positions=None, procs=None):
    return route_det_spmd(prep, cfg, procs)


#: algorithm -> (prepare(x, cfg, values, procs=), route(prep, cfg,
#: positions, procs=)); the sort body is route(prepare(x)).
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


def spmd_prepare_fn(cfg: SortConfig) -> Callable:
    """The tier-invariant prepare stage of ``cfg``:
    ``prepare(x, values=(), procs=None) -> PreparedSort``."""
    cfg.validate()
    return functools.partial(_pipeline(cfg)[0], cfg=cfg)


def spmd_route_fn(cfg: SortConfig) -> Callable:
    """The tier-dependent route stage of ``cfg``:
    ``route(prep, positions=None, procs=None) -> (buf, vbufs, count, overflow)``."""
    cfg.validate()
    return functools.partial(_pipeline(cfg)[1], cfg=cfg)


def spmd_sort_fn(cfg: SortConfig) -> Callable:
    """The per-processor sort body of ``cfg``, route after prepare:
    ``sort(x, values=(), positions=None, procs=None)``."""
    prepare, route = spmd_prepare_fn(cfg), spmd_route_fn(cfg)

    def sort(x, values=(), positions=None, procs=None):
        return route(prepare(x, values=values, procs=procs), positions=positions, procs=procs)

    return sort


def _inputs(x, values, device) -> Tuple[torch.Tensor, List[torch.Tensor], torch.dtype]:
    """Tensors on the run's device, uint32 keys biased to int32; and the
    keys' own dtype, which :func:`_result` restores."""
    dev = resolve_device(device)
    x = to_device(x, dev)
    key_dtype = x.dtype
    if key_dtype == torch.uint32:
        x = prim.bias_unsigned(x)
    return x, [to_device(v, dev) for v in values], key_dtype


def _config(x: torch.Tensor, cfg: Optional[SortConfig], overrides, procs=None) -> SortConfig:
    """The sort's config, checked against ``x``: a (p, n_per_proc) layout
    of simulated processors, or this rank's (1, n_per_proc) row when
    ``procs`` is a mesh axis's group."""
    procs = prim.procs_or_local(procs, x.shape[0])
    rows, n_p = x.shape
    if cfg is None:
        cfg = SortConfig(p=procs.p, n_per_proc=n_p, **overrides)
    if rows != procs.rows or (cfg.p, cfg.n_per_proc) != (procs.p, n_p):
        raise ValueError(f"config (p={cfg.p}, n_per_proc={cfg.n_per_proc}) does not match layout {tuple(x.shape)} "
                         f"of {procs.p} processors")
    cfg.validate()
    return cfg


def _keyless(cfg: SortConfig) -> SortConfig:
    """``cfg`` without its tracer and fault plan: neither is part of the
    config's hash, and no executor key ever holds one."""
    if cfg.obs is None and cfg.chaos is None:
        return cfg
    return dataclasses.replace(cfg, obs=None, chaos=None)


def _rung_generator(cfg: SortConfig, rung: int, generator: Optional[torch.Generator]):
    """The generator rung ``rung`` draws its sample from (see module doc)."""
    if generator is not None:
        return generator
    return torch.Generator().manual_seed((cfg.seed * 1_000_003 + rung) % (2**63))


def _positions(cfg: SortConfig, rung: int, generator, device) -> Optional[torch.Tensor]:
    if cfg.algorithm not in _RANDOMIZED or cfg.route == "radix":
        return None
    return sample_positions(cfg, _rung_generator(cfg, rung, generator), device)


def _own_positions(procs, cfg: SortConfig, rung: int, generator, device) -> Optional[torch.Tensor]:
    """The rows of rung ``rung``'s (p, s) sample table that ``procs`` holds."""
    pos = _positions(cfg, rung, generator, device)
    return None if pos is None else procs.own_rows(pos)


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
    tracer = resolve_tracer(cfg.obs)
    tid = tracer.next_tid("sort") if tracer is not None else None
    prepare, route = _pipeline(cfg)
    with trace_lane(tracer, tid, "prepare", device=x.device):
        prep = prepare(x, cfg, values)
    with trace_lane(tracer, tid, "route", rung=0, tier=cfg.pair_capacity, device=x.device):
        out = route(prep, cfg, _positions(cfg, 0, generator, x.device))
    return _result(*out, key_dtype)


def _rank_device(x) -> torch.device:
    """The device of a sharded sort's row: this rank's."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"a sharded sort takes this rank's row as a tensor on its device, not {type(x).__name__}")
    return x.device


def bsp_sort_sharded(
    x,
    mesh,
    mesh_axis: str,
    cfg: Optional[SortConfig] = None,
    *,
    values: Sequence = (),
    generator: Optional[torch.Generator] = None,
    executor: Optional["SortExecutor"] = None,
    **overrides,
) -> Tuple[SortResult, List[torch.Tensor]]:
    """Sort with one processor per rank of ``mesh_axis`` (one tier).

    ``x`` is this rank's own (1, n_per_proc) row, on its device; the
    result is its own row of :func:`bsp_sort`'s. Every rank of the axis
    calls this together. The callable comes from the executor registry,
    so repeated calls on one mesh and config build it once.
    """
    procs = prim.GroupProcs.from_mesh(mesh, mesh_axis)
    x, values, key_dtype = _inputs(x, values, _rank_device(x))
    cfg = _keyless(_config(x, cfg, overrides, procs))
    ex = executor if executor is not None else _EXECUTOR
    run = ex.sort_sharded(cfg, mesh, mesh_axis, len(values))
    return _result(*run(x, _own_positions(procs, cfg, 0, generator, x.device), *values), key_dtype)


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

    The keys' second element names the runner: ``"vmap"`` for the
    simulated processors (the JAX package's name, kept so both packages'
    keys read alike), ``"sharded"`` for one processor per rank of a mesh
    axis, whose keys end in ``(mesh, mesh_axis)``: two meshes over the same
    ranks in other orders get entries of their own. ``trace_counts[key]``
    counts the builds of each entry, so "one per key" is the reuse
    invariant here as it is there. An entry is where a captured CUDA graph
    per rung would live.
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

    # ---------------------------------------------------- sharded runner
    def prepare_sharded(self, cfg: SortConfig, mesh, mesh_axis: str, n_values: int) -> Callable:
        """``run(x, *vals) -> PreparedSort`` of this rank's (1, n_per_proc) row."""
        pcfg = cfg.prepare_key()

        def build():
            prepare, procs = spmd_prepare_fn(pcfg), prim.GroupProcs.from_mesh(mesh, mesh_axis)
            return lambda x, *vals: prepare(x, values=list(vals), procs=procs)

        return self._get(("prepare", "sharded", pcfg, n_values, mesh, mesh_axis), build)

    def route_sharded(self, tier_cfg: SortConfig, mesh, mesh_axis: str, n_values: int) -> Callable:
        """``run(prep, positions)`` of a rung on this rank; ``positions`` is
        the rank's (1, s) row of the rung's sample, or None."""

        def build():
            route, procs = spmd_route_fn(tier_cfg), prim.GroupProcs.from_mesh(mesh, mesh_axis)
            return lambda prep, positions: route(prep, positions=positions, procs=procs)

        return self._get(("route", "sharded", tier_cfg, n_values, mesh, mesh_axis), build)

    def sort_sharded(self, cfg: SortConfig, mesh, mesh_axis: str, n_values: int) -> Callable:
        """``run(x, positions, *vals)``: the whole sort of this rank's row."""

        def build():
            sort, procs = spmd_sort_fn(cfg), prim.GroupProcs.from_mesh(mesh, mesh_axis)
            return lambda x, positions, *vals: sort(x, values=list(vals), positions=positions, procs=procs)

        return self._get(("sort", "sharded", cfg, n_values, mesh, mesh_axis), build)


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
    balance, and the stream's time from the launch to the rung's last
    enqueued work; the counts and the events are read after the flag, the
    sync already made. Each launch runs in the rung's ``obs.trace.lane``.

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
        self._launch()

    def _launch(self) -> None:
        """Enqueue rung ``self._i`` in its lane, timed when traced."""
        tier, tier_cfg = self._ladder[self._i]
        tr, dev = self._tracer, self._meta.get("device")
        if tr is not None:
            self._t_launch = tr.now()
            self._ev_launch = tr.mark(dev)
        with self._scope(), trace_lane(tr, self.trace_tid, "route", rung=self._i, tier=tier, device=dev):
            self._pending = self._run_tier(tier_cfg, self._i)
        if tr is not None:
            self._ev_done = tr.mark(dev)

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
        tr.add_span("route", self._t_launch, t_end=t_end, cat=cat, tid=tid,
                    stream=(self._ev_launch, self._ev_done), **args)
        tr.point("host_sync", cat=cat, tid=tid, what="overflow", rung=self._i, ok=ok)
        tr.resolve()

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
            self._launch()


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
        "device": x.device,
    }


def _gathered_bounds(procs, bounds: np.ndarray, device) -> np.ndarray:
    """Every processor's (p+1,) boundaries, (p, p+1), from the host rows
    ``bounds`` this group holds (the bookkeeping gather of a sharded sort)."""
    if procs is None or procs.local:
        return bounds
    return procs.gather_rows(torch.from_numpy(bounds).to(device)).cpu().numpy()


def _trace_prepared(tracer, meta: Dict, cfg: SortConfig, prep: PreparedSort, procs=None) -> None:
    """Record the prepared distribution snapshot (traced runs only).

    ``route="radix"``: the counted boundaries give the exact per-(src, dst)
    send counts of the coming h-relation. ``det``: the splitters are in
    hand, and searching each run for them gives the splitter-implied
    boundary estimate (tag-blind) and the oversampling skew: the search
    runs on the device, in the keys' sort order (``np.searchsorted``'s,
    left side), and only the (rows, p+1) boundaries come to the host,
    never the runs. iran/ran draw their sample in the route stage, so
    nothing is prepared to read. A sharded sort's ranks gather every
    processor's boundaries, so each records the whole h-relation.
    """
    tid, cat = meta["tid"], meta.get("cat", "sort")
    row_bytes = int(meta.get("row_bytes", 4))
    if cfg.route == "radix" and prep.splits is not None:
        sendc = host_send_counts(prim.procs_or_local(procs, cfg.p).gather_rows(prep.splits[0]))  # (p, p) exact
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
        rows, n_p = prep.xs.shape  # locally sorted runs
        keys = prep.splits[0][:1].expand(rows, -1)  # the replicated (p-1,) splitter keys, a row each
        inner = prim.searchsorted(prim.sort_key(prep.xs), prim.sort_key(keys)).cpu().numpy().astype(np.int64)
        bounds = np.concatenate(
            [np.zeros((rows, 1), np.int64), inner, np.full((rows, 1), n_p, np.int64)], axis=1)
        sendc = np.diff(_gathered_bounds(procs, bounds, prep.xs.device), axis=1)
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


def _radix_exact_ladder(cfg: SortConfig, prep: PreparedSort, procs=None) -> tuple:
    """The radix route's whole ladder: ONE rung at the host-counted capacity.

    ``prep.splits[0]`` holds the counted (p, p+1) boundaries, so the true
    per-(src, dst) maximum and the true receive total are known before any
    data moves (a (p, p+1) int32 host read). Both are rounded up on a
    relative 1/16 grid (``step`` = the top four bits of the count) and
    clamped to the exact-tier sizes; the capacity then covers every pair,
    so the rung cannot overflow. The JAX package's sizing, unchanged. A
    sharded sort gathers every rank's boundaries first, so all ranks size
    the same rung.
    """
    bounds = prim.procs_or_local(procs, cfg.p).gather_rows(prep.splits[0])
    sendc = host_send_counts(bounds)  # counts[src, dst]
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


def _safe_launch(
    x, cfg: Optional[SortConfig], overrides, *, values: Sequence, stats: Optional[TierStats], generator,
    device, executor: Optional[SortExecutor], resume: bool, planner, scope: Optional[Callable],
    mesh=None, mesh_axis: Optional[str] = None,
) -> InFlightSort:
    """The overflow-safe drivers' one launch: prepare once, enqueue the
    first rung. With ``mesh`` the processors are the ranks of ``mesh_axis``
    and ``x`` is this rank's row: the stages come from the executor's
    sharded entries and each rung takes this rank's row of the sample."""
    procs = None if mesh is None else prim.GroupProcs.from_mesh(mesh, mesh_axis)
    x, values, key_dtype = _inputs(x, values, device if procs is None else _rank_device(x))
    cfg = _config(x, cfg, overrides, procs)
    tracer = resolve_tracer(cfg.obs)
    # a fault plan drives the simulated processors only; the sharded
    # driver drops it, as the JAX package's does
    chaos = resolve_chaos(cfg.chaos) if procs is None else None
    # the tracer and the fault plan stay locals: the ladder and the
    # executor see neither
    cfg = _keyless(cfg)
    procs = prim.procs_or_local(procs, cfg.p)
    meta = _trace_meta_for(tracer, x, values)
    ex = executor if executor is not None else _EXECUTOR
    if mesh is None:
        prepare_stage, route_stage, sort_stage = ex.prepare_vmap, ex.route_vmap, ex.sort_vmap
        keys = (len(values),)
    else:
        prepare_stage, route_stage, sort_stage = ex.prepare_sharded, ex.route_sharded, ex.sort_sharded
        keys = (mesh, mesh_axis, len(values))

    ladder = cfg.tier_ladder()
    bucket = None
    if planner is not None and len(ladder) > 1:
        bucket = f"sort/{cfg.algorithm}/p{cfg.p}/npp{cfg.n_per_proc}/{cfg.pair_capacity}"
        ladder = ladder[planner.rung_for(bucket, len(ladder)) :]
    stats = stats if stats is not None else TierStats()
    retries_before = stats.retries

    on_complete = None
    if bucket is not None:
        n_rungs = len(cfg.tier_ladder())

        def on_complete(st: TierStats, _bucket=bucket) -> None:
            planner.observe(_bucket, st.retries > retries_before, n_rungs)

    enter = scope if scope is not None else contextlib.nullcontext
    dev = x.device
    if not resume:

        def run_tier(tier_cfg: SortConfig, rung: int):
            positions = _own_positions(procs, tier_cfg, rung, generator, x.device)
            return _result(*sort_stage(tier_cfg, *keys)(x, positions, *values), key_dtype)

    else:
        tid = meta["tid"] if tracer is not None else None
        if tracer is not None:
            t0, ev0 = tracer.now(), tracer.mark(dev)
        with enter(), trace_lane(tracer, tid, "prepare", device=dev):
            prep = prepare_stage(cfg, *keys)(x, *values)
        if tracer is not None:
            # a traced run waits for the device at the stage boundary, so the
            # prepare span includes the device's time and the route spans
            # start clean; an untraced run stays asynchronous
            ev1 = tracer.mark(dev)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            tracer.add_span("prepare", t0, tid=tid, stream=(ev0, ev1), algorithm=cfg.algorithm, route=cfg.route,
                            p=cfg.p, n_per_proc=cfg.n_per_proc)
            tracer.resolve()
            _trace_prepared(tracer, meta, cfg, prep, procs)
        if cfg.route == "radix":
            # the counts are in hand: one rung sized to the true maxima
            if tracer is not None:
                tracer.point("host_sync", tid=meta["tid"], what="radix_counts")
            ladder = _radix_exact_ladder(cfg, prep, procs)

        def run_tier(tier_cfg: SortConfig, rung: int):
            positions = _own_positions(procs, tier_cfg, rung, generator, x.device)
            return _result(*route_stage(tier_cfg, *keys)(prep, positions), key_dtype)

    return InFlightSort(ladder, stats, run_tier, scope=scope, on_complete=on_complete, tracer=tracer,
                        trace_meta=meta, chaos=chaos)


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
    return _safe_launch(x, cfg, overrides, values=values, stats=stats, generator=generator, device=device,
                        executor=executor, resume=resume, planner=planner, scope=scope)


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


def bsp_sort_sharded_safe(
    x,
    mesh,
    mesh_axis: str,
    cfg: Optional[SortConfig] = None,
    *,
    values: Sequence = (),
    stats: Optional[TierStats] = None,
    generator: Optional[torch.Generator] = None,
    executor: Optional[SortExecutor] = None,
    resume: bool = True,
    **overrides,
) -> Tuple[SortResult, List[torch.Tensor], TierStats]:
    """Overflow-safe :func:`bsp_sort_sharded`: the resumable escalation of
    :func:`bsp_sort_safe` with one processor per rank of ``mesh_axis``.

    Every rank calls it with its own (1, n_per_proc) row and gets its own
    row back. Each rung's overflow flag is the group's ``any``, so every
    rank reads the same decision and all climb the ladder together. The
    prepare and route callables come from the executor's sharded entries:
    one ``prepare`` for every rung, none built again on a second call.
    ``SortConfig(obs=tracer)`` records the prepare span and the route
    spans as :func:`bsp_sort_safe` does, the rung's counts being this
    rank's; a fault plan (``chaos``) is dropped, as in the JAX package.
    """
    return _safe_launch(x, cfg, overrides, values=values, stats=stats, generator=generator, device=None,
                        executor=executor, resume=resume, planner=None, scope=None, mesh=mesh,
                        mesh_axis=mesh_axis).wait()


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
