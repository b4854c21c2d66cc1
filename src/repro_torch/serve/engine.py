"""Batched serving engine: continuous-batching decode loop over a KV cache.

The port of the JAX package's ``repro.serve.engine`` on one device. Two
decode modes:

* :meth:`ServeEngine.generate` — one fixed batch in lockstep (a retired row
  keeps decoding into a scratch token).
* :meth:`ServeEngine.serve` — continuous batching over a request queue: a
  fixed number of decode *slots*, each an independent (cache, position)
  lane. The reference stacks batch-1 lanes under ``jax.vmap``; the port
  runs them as one batch whose cache carries one position per lane, and
  each lane's MoE keeps the reference's per-lane capacity rule
  (``models.moe._grouped_gemm_moe``'s ``lanes``). When a sequence retires
  (EOS or its token budget), its slot is refilled from the admission queue
  between steps: the new request is prefilled alone and its cache written
  into the retired slot's lane while the other slots keep decoding. The
  lanes of any family's cache stack leaf by leaf (the transformer's K/V,
  the hybrid's Mamba state beside them, the xLSTM's recurrent state).

Admission ordering goes through the port's sort *service*
(:meth:`ServeEngine.admission_order` → :class:`repro_torch.service.SortService`):
queued requests are globally sorted by prompt length so each admitted batch
is length-homogeneous, and every batch runs the capacity-escalation ladder
with the engine's per-tier retry counters (``capacity_stats``, shared with
the service). The queue itself is a standing length-sorted
:class:`repro_torch.delta.SortedView` that mid-loop arrivals fold into.

Everything runs under ``torch.inference_mode()`` on the model's device.
Sampling draws from a ``torch.Generator`` in sequence (the reference folds
its key per step and per rid); the sampling-seed layout is not part of the
engine's contract, and greedy decoding does not draw.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import obs
from ..core.api import TierStats
from ..data import length_bucketed_order
from ..delta import SortedView
from ..models import Model
from ..service import ServiceConfig, SortService, SortServiceError
from .sampling import sample


def _mesh_sort_p(mesh) -> int:
    """Simulated-processor count for the engine's sort service.

    The largest power of two ≤ the mesh's device count (``SortConfig``
    requires pow2 ``p``); 8 lanes without a mesh.
    """
    if mesh is None:
        return 8
    nd = int(np.asarray(mesh.devices).size)
    return max(1, 1 << (nd.bit_length() - 1))


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and tuples of one structure."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 1.0
    top_k: int = 40
    top_p: float = 0.0
    eos_id: int = 2


class ServeEngine:
    """Serves ``model`` on the model's device. ``mesh`` only sets the
    admission sort's processor count (``_mesh_sort_p``); the model runs on
    one device."""

    def __init__(self, model: Model, serve_cfg: ServeConfig, mesh=None):
        self.model = model
        self.device = model.device
        self.scfg = serve_cfg
        self.mesh = mesh
        self.capacity_stats = TierStats()  # sort-driver retry counters
        self.sort_p = _mesh_sort_p(mesh)
        # admission sorts go through the service: fused segmented dispatch,
        # pow2-bucketed batches, escalation stats shared with the engine
        self.sort_service = SortService(
            ServiceConfig(p=self.sort_p), stats=self.capacity_stats, device=self.device
        )
        self.label = obs.next_instance("engine")
        reg = obs.metrics()
        self._refills = reg.counter("serve.refills", engine=self.label)
        self._admission_prefetches = reg.counter("serve.admission_prefetches", engine=self.label)
        self._admission_fallbacks = reg.counter("serve.admission_fallbacks", engine=self.label)

    @property
    def refills(self) -> int:
        """Queue admissions into retired decode slots."""
        return self._refills.value

    @property
    def admission_prefetches(self) -> int:
        """Prefills launched ahead of retirement."""
        return self._admission_prefetches.value

    @property
    def admission_fallbacks(self) -> int:
        """Admissions served by bucketed order after a sort-service failure."""
        return self._admission_fallbacks.value

    def admission_order(self, prompt_lengths, p: Optional[int] = None) -> np.ndarray:
        """Globally length-sorted admission order for a request queue.

        One balanced BSP sort through the engine's sort service; the
        overflow-safe per-batch escalation never drops a request id, even
        when every prompt has the same length. ``p`` defaults to
        ``self.sort_p``; an explicit override takes a one-off service.
        """
        lengths = np.asarray(prompt_lengths, np.int32)
        if p is not None and p != self.sort_p:
            return length_bucketed_order(lengths, p=p, stats=self.capacity_stats, device=self.device)
        try:
            return self.sort_service.sort_one(lengths).order
        except SortServiceError:
            # graceful degradation: a terminally failing sort service must
            # not take admission down with it — every request is still
            # admitted exactly once, in bucketed order
            self._admission_fallbacks.inc()
            return length_bucketed_order(lengths, p=self.sort_p, stats=self.capacity_stats, device=self.device)

    def _generator(self, generator: Optional[torch.Generator]) -> torch.Generator:
        return generator if generator is not None else torch.Generator(device=self.device).manual_seed(0)

    def _sample(self, logits, generator):
        return sample(logits, generator, temperature=self.scfg.temperature, top_k=self.scfg.top_k,
                      top_p=self.scfg.top_p)

    @torch.inference_mode()
    def generate(self, prompts, extras: Optional[Dict] = None, generator: Optional[torch.Generator] = None):
        """prompts: (B, S_prompt) int32 -> (B, max_new_tokens) int32."""
        gen = self._generator(generator)
        prompts = torch.as_tensor(prompts).to(self.device)
        b, s = prompts.shape
        cache_len = s + self.scfg.max_new_tokens
        cache, logits = self.model.prefill({"tokens": prompts, **(extras or {})}, cache_len=cache_len)
        outs: List[torch.Tensor] = []
        done = torch.zeros((b,), dtype=torch.bool, device=self.device)
        eos = torch.full((b,), self.scfg.eos_id, dtype=torch.int32, device=self.device)
        tok = self._sample(logits, gen)
        for _ in range(self.scfg.max_new_tokens):
            outs.append(torch.where(done, eos, tok))
            done = done | (tok == self.scfg.eos_id)
            logits, cache = self.model.decode_step(cache, tok)
            tok = self._sample(logits, gen)
        return torch.stack(outs, dim=1)

    # ------------------------------------------------ continuous batching
    def _lane_axes(self):
        """The lane (batch) axis of each cache leaf, found where the shapes
        of a 1-lane and a 2-lane cache differ: the transformer's K/V on
        axis 1, the hybrid's Mamba state on axis 2, the xLSTM state on
        axis 1; ``None`` for ``pos``, whose lanes stack on a new axis 0."""
        one, two = self.model.cache_shapes(1, 1), self.model.cache_shapes(2, 1)
        return _tree_map(lambda a, b: next((i for i, (m, n) in enumerate(zip(a.shape, b.shape)) if m != n), None),
                         one, two)

    def _prefill_one(self, tokens: np.ndarray, cache_len: int):
        """Prefill one request (batch 1)."""
        return self.model.prefill({"tokens": torch.as_tensor(tokens)[None]}, cache_len=cache_len)

    @torch.inference_mode()
    def serve(
        self,
        prompts: Sequence[np.ndarray],
        slots: int = 4,
        max_new: Optional[Sequence[int]] = None,
        generator: Optional[torch.Generator] = None,
        arrivals=None,
    ) -> List[np.ndarray]:
        """Serve a request queue with continuous batching.

        ``prompts``: per-request 1-D int32 token arrays (ragged lengths).
        ``max_new``: optional per-request new-token budgets (default: the
        engine's ``max_new_tokens``). Returns the generated tokens per
        request, in the original request order, truncated at EOS.

        Requests are admitted in globally length-sorted order: one sort
        through the service seeds a standing length-sorted ``SortedView``,
        and every admission is a ``pop_min`` off it. A slot that retires is
        refilled from the view between decode steps (``self.refills``).

        ``arrivals``: optional ``step -> iterable of prompt arrays`` hook,
        polled once per decode step while the loop runs. Arriving requests
        fold into the standing view (``delta.folds``), inherit the default
        token budget, and must fit the initial ``cache_len``; their outputs
        append after the initial requests' in arrival order. Arrivals after
        the loop drains are not served.

        Admission is double-buffered: the next queued request's prefill is
        launched ahead of any retirement (CUDA launches return while the
        card still runs the work), so it overlaps the running decode steps;
        when a slot retires, the launched prefill is consumed and the one
        after it launches at once (``self.admission_prefetches``).
        """
        gen = self._generator(generator)
        reqs = [np.asarray(p, np.int32) for p in prompts]
        if not reqs:
            return []
        budgets = [int(m) for m in max_new] if max_new is not None else [self.scfg.max_new_tokens] * len(reqs)
        if len(budgets) != len(reqs):
            raise ValueError(f"{len(budgets)} budgets for {len(reqs)} requests")
        outs: List[List[int]] = [[] for _ in reqs]
        # one cache length for every lane: the longest prompt plus the
        # largest budget, rounded up to a power of two (as the reference,
        # which compiles one program per cache length)
        cache_len = max(len(r) for r in reqs) + max(max(budgets), 1)
        cache_len = max(64, 1 << (cache_len - 1).bit_length())
        lengths = np.asarray([len(r) for r in reqs], np.int32)
        order = np.asarray(self.admission_order(lengths), np.int32)
        view = SortedView(p=self.sort_p, stats=self.capacity_stats, device=self.device)
        view.install(lengths[order], (order,))
        self._admission_view = view

        def next_rid() -> Optional[int]:
            # zero-budget requests retire instantly with an empty stream
            while view.n:
                _, (rid,) = view.pop_min()
                if budgets[int(rid)] > 0:
                    return int(rid)
            return None

        def admit_arrivals(new_prompts) -> None:
            rids: List[int] = []
            for pr in new_prompts:
                pr = np.asarray(pr, np.int32)
                if len(pr) + self.scfg.max_new_tokens > cache_len:
                    raise ValueError(
                        f"arriving prompt of {len(pr)} tokens (+ budget {self.scfg.max_new_tokens}) "
                        f"exceeds the serving cache_len {cache_len}"
                    )
                reqs.append(pr)
                budgets.append(self.scfg.max_new_tokens)
                outs.append([])
                rids.append(len(reqs) - 1)
            if rids:
                view.fold(np.asarray([len(reqs[r]) for r in rids], np.int32), (np.asarray(rids, np.int32),))

        def admit(rid: int):
            cache, logits = self._prefill_one(reqs[rid], cache_len)
            return cache, self._sample(logits, gen)[0]

        prefetched = None  # one (rid, cache, first token) launched ahead

        def prefetch_admission() -> None:
            nonlocal prefetched
            if prefetched is None:
                rid = next_rid()
                if rid is not None:
                    prefetched = (rid, *admit(rid))
                    self._admission_prefetches.inc()

        def take_admission():
            nonlocal prefetched
            if prefetched is None:
                prefetch_admission()  # cold path: nothing launched ahead
            out, prefetched = prefetched, None
            prefetch_admission()  # overlap the NEXT admission's prefill
            return out

        # initial fill: one prefill per slot, the lanes stacked on the batch dim
        caches, toks, slot_req = [], [], []
        while len(slot_req) < max(1, slots):
            rid = next_rid()
            if rid is None:
                break
            slot_req.append(rid)
            cache, tok_s = admit(rid)
            caches.append(cache)
            toks.append(tok_s)
        if not slot_req:  # every request had a zero budget
            return [np.asarray(t, np.int32) for t in outs]
        n_slots = len(slot_req)
        axes = self._lane_axes()
        lanes = _tree_map(lambda ax, *leaves: torch.stack(leaves) if ax is None else torch.cat(leaves, dim=ax),
                          axes, *caches)
        del caches
        tok = torch.stack(toks)  # (slots,)
        prefetch_admission()  # first refill's prefill rides the decode loop

        def install(s: int, adm) -> int:
            nxt, cache_s, tok_s = adm
            slot_req[s] = nxt
            self._refills.inc()
            _tree_map(lambda ax, full, one: (full[s] if ax is None else full.select(ax, s)).copy_(
                one if ax is None else one.select(ax, 0)), axes, lanes, cache_s)
            tok[s] = tok_s
            return int(tok_s)

        step = 0
        while any(r is not None for r in slot_req):
            if arrivals is not None:
                new = arrivals(step)
                if new:
                    admit_arrivals(new)
                    prefetch_admission()
            # record the sampled token per lane; retire finished requests and
            # refill their slot from the queue. A freshly admitted request's
            # first token comes from its own prefill logits and is recorded
            # at once (cascading, in case a 1-token budget or instant EOS
            # retires it before it ever takes a decode step).
            tok_host = tok.cpu().numpy()
            for s in range(n_slots):
                if slot_req[s] is None:
                    # a lane idled when the queue drained; arrivals may have
                    # refilled the view since — re-admit into the dead lane
                    adm = take_admission()
                    if adm is None:
                        continue
                    tval = install(s, adm)
                else:
                    tval = int(tok_host[s])
                while slot_req[s] is not None:
                    rid = slot_req[s]
                    outs[rid].append(tval)
                    if tval != self.scfg.eos_id and len(outs[rid]) < budgets[rid]:
                        break
                    slot_req[s] = None
                    adm = take_admission()  # already launched, overlapped
                    if adm is None:
                        break
                    tval = install(s, adm)
            if not any(r is not None for r in slot_req):
                break
            # one decode step for every lane (retired-and-unrefilled lanes
            # keep decoding into scratch — their output is ignored)
            logits, lanes = self.model.decode_step(lanes, tok)
            tok = self._sample(logits, gen)
            step += 1

        def trim(t: List[int]) -> np.ndarray:
            if self.scfg.eos_id in t:
                t = t[: t.index(self.scfg.eos_id) + 1]
            return np.asarray(t, np.int32)

        return [trim(t) for t in outs]
