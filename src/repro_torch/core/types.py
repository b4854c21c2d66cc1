"""Core datatypes and layout conventions of the PyTorch port.

Layout
------
A distributed sequence of ``n = p * n_per_proc`` keys is one tensor of
shape ``(p, n_per_proc)``: row k is processor k's local run (the paper's
``X^<k>``). Where the JAX package runs a per-processor body under
``jax.vmap(axis_name=...)``, the port keeps the processor dimension as an
explicit leading ``p`` dimension and writes its collectives as tensor
operations over it (``core/primitives.py``).

Phase outputs that are variable-sized in the paper are capacity-padded:
``buf[:, :count]`` holds valid keys and the rest holds the dtype sentinel.

Stability/padding invariant: pads occupy a suffix of every buffer, every
sort is stable, and routing/merging keep (source processor, local index)
order for equal keys, so ``buf[k, :count[k]]`` is exact even when real keys
equal the sentinel value (§5.1.1's transparent duplicate handling).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


def sentinel_for(dtype: torch.dtype):
    """Largest value of ``dtype`` (a Python scalar) — used as tail padding."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def log2(x: float) -> float:
    return math.log2(max(x, 2.0))


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    With no device given and no CUDA device present this raises: the port
    never carries on on the CPU unless the caller asked for it.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the host"
            )
        return torch.device("cuda")
    return torch.device(device)


def to_device(a, device: torch.device) -> torch.Tensor:
    """``a`` (a tensor or an array) as a tensor on ``device``.

    A host tensor bound for the card is pinned and copied asynchronously:
    a blocking copy from pageable memory ends in a stream synchronize, so
    it would wait for every kernel queued before it and serialize the
    service's pipelined launches. The caching host allocator keeps the
    pinned block alive until the copy has run, so the temporary may go at
    once. Any other copy is the plain ``.to``; the bytes are the same.
    """
    t, device = torch.as_tensor(a), torch.device(device)
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """Static configuration of one BSP sort instance.

    The fields and the capacity arithmetic are those of the JAX package's
    ``SortConfig``, so a configuration carries across unchanged
    (``core/convert.py``):

    * ``omega`` — oversampling regulator ω_n (det default ⌈lg lg n⌉).
    * ``route`` — ``sample`` (Ph3 splitters) or ``radix`` (one counting
      pass gives exact boundaries; a single rung, no retry).
    * ``local_sort`` — Ph2 method: ``lax`` (stable comparison sort),
      ``radix`` (LSD counting sort, integer keys) or ``bitonic`` (the
      hand-written bitonic tile-sort kernel).
    * ``merge`` — Ph6: ``sort`` (stable re-sort) or ``tree`` (lg p rounds of
      stable pairwise rank merges).
    * ``merge_backend`` — Ph6 tree substrate: ``xla`` (plain ranks) or
      ``pallas`` (the rank kernel, and the merge-path kernel for key-only
      pairs). The names are the JAX package's.
    * ``routing`` — Ph5 schedule: ``a2a_dense``, ``allgather`` or ``ring``.
    * ``exchange`` — Ph5 payload packing: ``fused`` or ``per_array``.
    * ``sample_sort`` — Ph3 sample sort: ``gather`` (one replicated
      lexicographic sort) or ``bitonic`` (compare-split over processors).
    * ``seed`` — seeds the randomized sorts' sample when the caller gives
      no generator.
    * ``obs`` — a :class:`repro_torch.obs.Tracer` or None. Host-side only:
      the drivers read it at launch/wait boundaries. It is left out of
      ``__eq__``/``__hash__``, so a traced and an untraced config are equal
      and share every executor entry.
    * ``chaos`` — a :class:`repro_torch.chaos.FaultPlan` or None, left out
      of ``__eq__``/``__hash__`` for the same reason: a faulted and a clean
      config share every executor entry, and every injection is a host
      decision at a driver boundary (``InFlightSort.wait``).
    """

    p: int
    n_per_proc: int
    algorithm: str = "det"
    route: str = "sample"
    omega: Optional[float] = None
    local_sort: str = "lax"
    merge: str = "sort"
    merge_backend: str = "xla"
    routing: str = "a2a_dense"
    exchange: str = "fused"
    sample_sort: str = "gather"
    capacity_factor: float = 1.0
    pad_align: int = 8
    pair_capacity: str = "exact"
    pair_cap_override: Optional[int] = None
    n_max_mode: str = "bound"
    n_max_override: Optional[int] = None
    seed: int = 0
    obs: Optional[object] = dataclasses.field(default=None, compare=False, repr=False)
    chaos: Optional[object] = dataclasses.field(default=None, compare=False, repr=False)

    # ------------------------------------------------------------------ math
    @property
    def n(self) -> int:
        return self.p * self.n_per_proc

    @property
    def omega_eff(self) -> float:
        if self.omega is not None:
            return float(self.omega)
        if self.algorithm == "det":
            # paper §6.1: omega_n = lg lg n
            return max(1.0, math.ceil(log2(log2(self.n))))
        return max(1.0, math.sqrt(log2(self.n)))

    @property
    def r(self) -> int:
        """⌈ω_n⌉ — regular-oversampling ratio (deterministic algorithm)."""
        return max(1, math.ceil(self.omega_eff))

    @property
    def s(self) -> int:
        """Per-processor sample size (det: ⌈ω_n⌉·p; iran/ran: 2·ω_n²·lg n)."""
        if self.algorithm == "det":
            return self.r * self.p
        return max(2, int(2 * self.omega_eff**2 * log2(self.n)))

    @property
    def segment_len(self) -> int:
        """x = ⌈⌈n/p⌉ / s⌉ — regular sample segment length (Lemma 5.1 proof)."""
        return -(-self.n_per_proc // self.s)

    @property
    def n_max(self) -> int:
        """Receive-side bound per processor (Lemma 5.1 / Claim 5.1, or n)."""
        if self.n_max_mode == "full":
            return round_up(self.n, self.pad_align)
        if self.n_max_override is not None:
            return min(
                round_up(self.n_max_override, self.pad_align),
                max(self.n, self.pad_align),
            )
        if self.algorithm == "det":
            bound = (self.s + self.p - 1) * self.segment_len
        else:
            bound = int((1.0 + 1.0 / self.omega_eff) * self.n_per_proc) + int(
                self.omega_eff * self.p
            )
        bound = int(math.ceil(bound * self.capacity_factor))
        return min(round_up(bound, self.pad_align), max(self.n, self.pad_align))

    @property
    def pair_cap(self) -> int:
        """Per-(src,dst) capacity for the dense all_to_all schedule."""
        if self.pair_capacity == "exact":
            return round_up(self.n_per_proc, self.pad_align)
        if self.pair_capacity == "planned":
            cap = int(math.ceil(self.pair_cap_override * self.capacity_factor))
        else:
            # w.h.p. bound: n/p^2 bucket share, (1+1/ω) expansion, +ω·p slack.
            cap = int(
                (1.0 + 1.0 / self.omega_eff) * (self.n_per_proc / self.p)
                + self.omega_eff * self.p
            )
            cap = int(math.ceil(cap * self.capacity_factor))
        return min(
            round_up(max(cap, self.pad_align), self.pad_align),
            round_up(self.n_per_proc, self.pad_align),
        )

    # ------------------------------------------------------ capacity ladder
    def tier_ladder(self) -> tuple:
        """Capacity-escalation ladder ``((name, SortConfig), ...)``.

        whp → whp2 (×2) → exact (pair_cap = n/p) → allgather (receive
        buffer of n: no input can overflow it). Tiers below the configured
        start are omitted. The same rungs as the JAX package's ladder.
        """
        if self.algorithm == "bitonic":
            return (("exact", self),)
        if self.route == "radix":
            if self.pair_capacity == "planned" and self.pair_cap_override:
                return (("radix", self),)
            return (
                (
                    "radix",
                    dataclasses.replace(
                        self,
                        pair_capacity="exact",
                        pair_cap_override=None,
                        n_max_mode="full",
                        n_max_override=None,
                    ),
                ),
            )
        tiers = []
        if (
            self.routing == "a2a_dense"
            and self.pair_capacity in ("whp", "planned")
            and self.n_max_mode == "bound"
        ):
            tiers.append((self.pair_capacity, self))
            tiers.append(
                (
                    self.pair_capacity + "2",
                    dataclasses.replace(self, capacity_factor=2.0 * self.capacity_factor),
                )
            )
        if not (self.routing == "allgather" and self.n_max_mode == "full"):
            tiers.append(
                (
                    "exact",
                    dataclasses.replace(
                        self, pair_capacity="exact", pair_cap_override=None
                    ),
                )
            )
        tiers.append(
            (
                "allgather",
                dataclasses.replace(
                    self,
                    routing="allgather",
                    pair_capacity="exact",
                    pair_cap_override=None,
                    n_max_mode="full",
                ),
            )
        )
        return tuple(tiers)

    def prepare_key(self) -> "SortConfig":
        """The config with the fields that vary across the ladder normalised.

        The rungs differ only in capacity, routing, merge and exchange
        fields, none of which the prepare stage (Ph2, and det's Ph3
        splitters) reads, so two configs with equal ``prepare_key()`` share
        one prepared state. ``omega`` stays only for det on the sample
        route (the only prepare that draws a sample); ``obs`` and ``chaos``
        are dropped so an executor key never holds a tracer or a fault plan. The JAX package's
        normalisation, field for field.
        """
        return dataclasses.replace(
            self,
            capacity_factor=1.0,
            pair_capacity="exact",
            pair_cap_override=None,
            routing="a2a_dense",
            n_max_mode="bound",
            n_max_override=None,
            merge="sort",
            merge_backend="xla",
            exchange="fused",
            omega=self.omega if (self.algorithm == "det" and self.route == "sample") else None,
            obs=None,
            chaos=None,
        )

    def validate(self) -> None:
        if self.p & (self.p - 1):
            raise ValueError(f"p must be a power of two for bitonic stages, got {self.p}")
        if self.algorithm not in ("det", "iran", "ran", "bitonic"):
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if self.n_per_proc < 1:
            raise ValueError("n_per_proc must be >= 1")
        if self.n_max_mode not in ("bound", "full"):
            raise ValueError(f"unknown n_max_mode {self.n_max_mode!r}")
        if self.pair_capacity not in ("exact", "whp", "planned"):
            raise ValueError(f"unknown pair_capacity {self.pair_capacity!r}")
        if self.merge not in ("sort", "tree"):
            raise ValueError(f"unknown merge {self.merge!r}")
        if self.exchange not in ("fused", "per_array"):
            raise ValueError(f"unknown exchange {self.exchange!r}")
        if self.merge_backend not in ("xla", "pallas"):
            raise ValueError(f"unknown merge_backend {self.merge_backend!r}")
        if self.pair_capacity == "planned" and not self.pair_cap_override:
            raise ValueError("pair_capacity='planned' needs pair_cap_override")
        if self.route not in ("sample", "radix"):
            raise ValueError(f"unknown route {self.route!r}")
        if self.route == "radix":
            if self.algorithm == "bitonic":
                raise ValueError("route='radix' does not apply to bitonic")
            if self.routing != "a2a_dense":
                raise ValueError(
                    "route='radix' requires routing='a2a_dense' "
                    f"(got {self.routing!r})"
                )


@dataclasses.dataclass
class SortResult:
    """Per-processor capacity-padded result of a distributed sort."""

    buf: torch.Tensor  # (p, cap)
    count: torch.Tensor  # (p,) valid prefix length (int32; int64 for int64 keys off the tree tail)
    overflow: torch.Tensor  # bool scalar — any capacity violated (retriable)


@dataclasses.dataclass
class PreparedSort:
    """Tier-invariant state of a sort, reusable across capacity-tier retries.

    ``xs`` is the stable local sort of every run (Ph2), ``vals`` the
    payloads under the same permutation, and ``splits`` the det Ph3 tagged
    splitters ``(keys, procs, idxs)``, each ``(p, p-1)`` (every processor
    holds the same replicated copy, as in the JAX package's layout), or
    the radix route's counted ``(bounds,)``, ``(p, p+1)``.
    """

    xs: torch.Tensor  # (p, n_per_proc)
    vals: Tuple[torch.Tensor, ...]
    splits: Optional[tuple]
