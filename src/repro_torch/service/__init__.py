"""Sort service of the port — fuse many concurrent ragged sort requests into one
tagged, segmented BSP sort (the layer between the sort library and its
serving/data consumers).

    SortService    — async request queue + facade over the dispatcher:
                     submit() returns a SortFuture immediately; flush()
                     (caller-driven, or auto via max_pending /
                     flush_after_s triggers) packs the queue into
                     pow2-bucketed batches and drains the dispatch
                     pipeline; blocking sort_one/sort_many/take_result
                     wrap futures byte-identically to the synchronous
                     path. Starting tiers are resolved per batch by the
                     capacity planner (repro_torch.planner), with fault
                     outcomes fed back on completion callbacks.
    Dispatcher     — the async dispatch queue: up to max_in_flight
                     launched batches (host plan/pack of batch k+1
                     overlaps batch k's device collectives) plus failsink
                     per-request fault isolation (bisect a failed batch
                     until the poison request stands alone).
    SortFuture     — submit()'s handle: done()/result()/exception()/
                     cancel(), the failsink telemetry mark, and a cached
                     result that survives unclaimed-store eviction.
    SortServiceError — terminal per-request failure, naming its rids.
    SortTimeoutError — a submit(deadline_s=...) request expired before its
                     batch launched (subclass of SortServiceError).
    SortCancelledError — a request was cancel()ed before launch (subclass
                     of SortServiceError).
    BatchFormer    — the pow2 length-bucketed batch former (bounds the
                     executor to one set of entries per bucket shape).
    ServiceConfig  — p / algorithm / capacity-tier / bucketing / auto-flush
                     / pipeline-depth / store-bound / planner knobs (the
                     JAX package's fields and defaults); the device is
                     ``SortService(cfg, device=...)``, the card by default.
    RequestResult  — per-request output record (+ failsink mark).
"""
from .batch import Batch, BatchFormer
from .dispatch import (
    Dispatcher,
    SortCancelledError,
    SortFuture,
    SortServiceError,
    SortTimeoutError,
)
from .service import RequestResult, ServiceConfig, SortService

__all__ = [
    "Batch",
    "BatchFormer",
    "Dispatcher",
    "RequestResult",
    "ServiceConfig",
    "SortCancelledError",
    "SortFuture",
    "SortService",
    "SortServiceError",
    "SortTimeoutError",
]
