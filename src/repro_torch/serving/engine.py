"""Micro-batching query engine over ``AshIndex`` — the serving layer.

Counterpart of ``repro.serving.engine``.  A direct ``AshIndex.search``
pays its query prep, its scan kernels and its selection launches for
every request; this engine lets many requests share them.  Individual
(or small-batch) requests are queued, grouped by search parameters,
padded into a small closed set of batch shapes ("buckets") and served
by ONE fused scoring call per bucket — one set of kernel launches for
every request in it — and per-request results are scattered back out
bit-identical to what a direct ``AshIndex.search`` would have returned
(a row's prep and scores do not depend on the rows searched with it,
``repro_torch.device.row_blocked``).

    engine = QueryEngine({"items": index_a, "docs": index_b})
    t1 = engine.submit(q1, k=10, index="items")       # single query
    t2 = engine.submit(q_batch, k=100, index="docs")  # small batch
    engine.flush()                  # or: automatic on size / timeout
    scores, ids = t1.result()
    t1.stats                        # queue wait, bucket, scoring us

Mechanics:

* **Buckets** — pending rows of a group are padded to the smallest
  configured batch bucket (queries pad with zeros, results for pad rows
  are discarded); requested ``k`` is padded to a ``k`` bucket and each
  request takes its first ``k`` columns (top-k prefixes are exact).
  Mixed-``k`` requests therefore share one bucket and one fused call —
  except under ``rerank``, where the direct path's shortlist is
  ``max(rerank, k)``, and under ``coarse``, where the direct path
  refines ``max(shortlist, k)`` coarse candidates: requests group by
  that depth (and the padded ``k`` is clamped to it) so the fused call
  selects from the exact same candidate set as a per-request call
  would.
* **Queue** — bounded by ``max_pending`` rows; a group flushes when it
  can fill the largest bucket ("size"), when its oldest request exceeds
  ``max_wait_s`` ("timeout", checked on submit/poll), when a request's
  flush-by deadline arrives ("deadline"), under queue pressure
  ("pressure"), or explicitly ("manual"; frontend shutdown flushes are
  "drain").  Flushes triggered inside ``submit`` never raise — a
  failing fused call resolves every affected ticket with the error,
  re-raised by that ticket's ``result()``.
* **Prep cache** — per-query-row LRU over the QUERY-COMPUTE projections
  (``prepare_queries``), held on the host: repeated queries skip the
  projection matmuls entirely, and a bucket's cached rows are stacked
  on the host and copied to the card once per field.  Keyed by (index
  name, query-row hash); row preps are exact, so cache hits stay
  bit-identical.  Byte-bounded
  (``prep_cache_bytes``; ``prep_cache_entries`` as an optional extra
  row bound), with the live footprint on ``engine.prep_cache_bytes``
  and the hit rate in ``engine.stats.snapshot()``.
* **Registry** — one engine fronts several ``AshIndex`` backends (flat,
  IVF) for tenant/namespace routing via ``index=``.
* **k > n** — clamped to the index size and padded back out with score
  ``-inf`` / id ``-1`` (the repo-wide missing-candidate convention).
* **Mutations** — ``submit_add`` / ``submit_delete`` queue through the
  same bucket/flush loop as queries.  A mutation submission BARRIERS
  its index: every queued query group for that index flushes first
  (those queries were submitted earlier and must see the pre-mutation
  state), then the mutation stages (adds buffer host-side via
  ``AshIndex.stage_add`` — ids assigned immediately, in submission
  order; deletes queue as id lists).  Staged mutations apply in ONE
  batched step — one IVF re-sort per batch —
  before the next query flush of that index, on ``flush()``, on an
  aged ``poll()``, or when the backlog exceeds
  ``max_pending_mutations`` rows; ``auto_compact`` optionally evicts
  tombstones past a dead-fraction threshold right after a batch with
  deletes (synchronously, or off-thread when a
  ``serving.compactor.BackgroundCompactor`` is attached).  Because
  every query flush applies the mutations queued before it, any search
  observes exactly the mutations submitted before it — and results
  stay bit-identical to direct ``AshIndex.search`` on the
  equivalently-mutated index.  With a ``serving.wal.DurableIndex``
  attached (:meth:`QueryEngine.attach_durability`) the batch is
  appended to the write-ahead log before the backend applies it and
  before any of its tickets resolves.
* **Results** — each fused call's (scores, ids) come to the host in
  one copy per field; tickets resolve to CPU tensors sliced from them.

Threading model
---------------

The engine core is thread-safe.  The lock discipline has two tiers:

* ``self._lock`` — a global re-entrant lock over the cheap shared
  state: the request queue, mutation bookkeeping, the prep LRU and the
  stats counters.  ``submit``/``submit_add``/``submit_delete`` only
  ever hold this lock (submission is cheap and never blocks behind a
  fused call).
* per-index execution locks (``mutation_barrier(name)``) — ONE fused
  scoring call or mutation apply runs per index at a time.  A flush
  pops its group's requests and releases the global lock before
  scoring, so flushes of *different* indexes run concurrently; two
  threads resolving the same group can never double-run it (the
  second finds the group gone and blocks on the ticket event).  The
  background compactor snapshots and swaps index state under this
  same lock, which is what makes its swap atomic with respect to
  searches and mutation applies.

Lock order is always per-index lock -> global lock; nothing acquires a
per-index lock while holding the global one, so the pair cannot
deadlock.

``Ticket``/``MutationTicket`` are event-backed: ``result(timeout=...)``
blocks on a ``threading.Event`` set exactly once when the batch
resolves.  On an engine without a driver thread, the first ``result()``
caller flushes the group itself (single-threaded serving keeps
working); when a ``serving.frontend.ServingFrontend`` drives the
engine (``engine.driven``), ``result()`` only waits — the driver owns
the flush cadence, so an eager caller cannot defeat batching by
flushing a group early.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.core.types import QueryPrep
from repro_torch.index.api import AshIndex
from repro_torch.index.common import default_shortlist
from repro_torch.serving.cache import ByteLRU
from repro_torch.testing import faults

NEG_INF = float("-inf")

# backends that route coarsely through inverted lists: nprobe grouping,
# the candidate-row cost model and adaptive probing apply to all of
# them (the tiered backend additionally bills paging, see
# _billed_list_sizes)
_IVF_LIKE = ("ivf", "tiered_ivf")

# crash-recovery windows of the mutation apply path: before anything
# durable happened, after the WAL records exist but before the backend
# applied them, and after the apply but before any ticket fired
_FAULT_APPLY = faults.point("engine.apply")
_FAULT_APPLY_LOGGED = faults.point("engine.apply.logged")
_FAULT_APPLY_APPLIED = faults.point("engine.apply.applied")


def _host_rows(x) -> np.ndarray:
    """Rows as contiguous float32 host numpy (a tensor on any device is
    copied to the host)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x), dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Tuning knobs of a :class:`QueryEngine`.

    batch_buckets / k_buckets: ascending padded shapes; values above
    the largest bucket round up to a multiple of it (so the shapes a
    fused call sees stay a closed set).

    The prep cache is BYTE-bounded (``prep_cache_bytes``, summing the
    numpy footprint of every cached row's projection tuple) so capacity
    planning works in memory terms regardless of query width;
    ``prep_cache_entries`` is an optional additional row-count bound
    (None = rows limited by bytes only).  Setting either to 0 disables
    the cache.

    ``row_budget`` / ``nprobe_min`` are the IVF tail-latency knobs.
    ``row_budget`` caps the deduped candidate-row bill (union of live
    rows across the probed lists of every query in a fused call) of
    each IVF sub-batch: groups whose bill exceeds it flush early
    (reason "budget") and split into within-budget sub-batches, so one
    fused gather never serializes an unbounded scan behind every
    ticket in the group.  Both the early flush and the split respect a
    batch-bucket floor — a chunk below the smallest bucket pads back
    up to it, so cutting finer would add dispatches without shrinking
    any gather.  ``nprobe_min`` arms load-adaptive probing:
    under queue pressure (see :meth:`QueryEngine.queue_pressure`)
    flushes walk a halving ladder from the requested nprobe down to
    ``nprobe_min``, trading recall for latency; the trade is surfaced
    in ``snapshot()["ivf_cost"]``.  ``pressure_age_s`` is the
    oldest-ticket age treated as pressure 1.0 (None = 10x
    ``max_wait_s``).  Both knobs default off (None).
    """

    batch_buckets: Tuple[int, ...] = (8, 32, 128)
    k_buckets: Tuple[int, ...] = (10, 100)
    max_pending: int = 1024  # queue bound, in query rows
    max_wait_s: float = 0.002  # flush-on-timeout age
    prep_cache_bytes: int = 64 << 20  # LRU byte budget; 0 disables
    prep_cache_entries: Optional[int] = None  # extra row bound; 0 disables
    # IVF cost model: candidate-row bill cap per fused call (None = off)
    row_budget: Optional[int] = None
    # relative cost of one candidate row under the int8 coarse first
    # pass (groups submitted with coarse="int8"): where the symmetric
    # scan is cheaper per row than the asymmetric estimator, coarse
    # groups fit more rows under the same row_budget.  1.0 = bill
    # coarse rows at full price — the conservative default.
    coarse_row_cost: float = 1.0
    # relative cost of one candidate row in a NON-resident inverted
    # list of a tiered index (backend="tiered_ivf"): probing a cold
    # list pays a host->device transfer on top of the scan, so it
    # bills more than a hot row.  Residency is sampled when the bill
    # folds and is advisory — the hot set may shift before the flush.
    page_row_cost: float = 2.0
    # load-adaptive probing floor (None = never degrade nprobe)
    nprobe_min: Optional[int] = None
    # oldest-ticket age mapping to pressure 1.0 (None = 10x max_wait_s)
    pressure_age_s: Optional[float] = None
    # mutation backlog bound, in staged add rows + queued delete ids:
    # past it the batch applies immediately instead of waiting for the
    # next query flush / poll timeout
    max_pending_mutations: int = 4096
    # evict tombstones whenever a mutation batch leaves the index's
    # dead fraction above this (None = never compact automatically);
    # runs synchronously on the applying thread unless a
    # BackgroundCompactor is attached, in which case it only signals
    # the compaction worker
    auto_compact: Optional[float] = None

    def __post_init__(self):
        if not self.batch_buckets or not self.k_buckets:
            raise ValueError("batch_buckets and k_buckets must be non-empty")
        for name in ("batch_buckets", "k_buckets"):
            v = getattr(self, name)
            if tuple(sorted(v)) != tuple(v) or min(v) < 1:
                raise ValueError(f"{name} must be ascending positive: {v}")
        if self.prep_cache_bytes < 0:
            raise ValueError(
                f"prep_cache_bytes must be >= 0: {self.prep_cache_bytes}"
            )
        if self.prep_cache_entries is not None and self.prep_cache_entries < 0:
            raise ValueError(
                f"prep_cache_entries must be >= 0: {self.prep_cache_entries}"
            )
        if self.max_pending_mutations < 1:
            raise ValueError(
                f"max_pending_mutations must be >= 1: "
                f"{self.max_pending_mutations}"
            )
        if self.auto_compact is not None and not (
            0.0 <= self.auto_compact < 1.0
        ):
            raise ValueError(
                f"auto_compact must be in [0, 1): {self.auto_compact}"
            )
        if self.row_budget is not None and self.row_budget < 1:
            raise ValueError(
                f"row_budget must be >= 1: {self.row_budget}"
            )
        if not (0.0 < self.coarse_row_cost <= 1.0):
            raise ValueError(
                f"coarse_row_cost must be in (0, 1]: "
                f"{self.coarse_row_cost}"
            )
        if self.page_row_cost < 1.0:
            raise ValueError(
                f"page_row_cost must be >= 1: {self.page_row_cost}"
            )
        if self.nprobe_min is not None and self.nprobe_min < 1:
            raise ValueError(
                f"nprobe_min must be >= 1: {self.nprobe_min}"
            )
        if self.pressure_age_s is not None and self.pressure_age_s <= 0:
            raise ValueError(
                f"pressure_age_s must be > 0: {self.pressure_age_s}"
            )

    @property
    def prep_cache_enabled(self) -> bool:
        return self.prep_cache_bytes > 0 and self.prep_cache_entries != 0


def _bucketize(buckets: Tuple[int, ...], n: int) -> int:
    """Smallest bucket >= n, else n rounded up to a multiple of the
    largest bucket (keeps the shape set closed for any request size)."""
    for b in buckets:
        if n <= b:
            return b
    big = buckets[-1]
    return ((n + big - 1) // big) * big


def _pad_rows(rows: np.ndarray, bucket: int) -> np.ndarray:
    """Zero-pad (n, D) query rows up to the bucket's row count."""
    if bucket <= rows.shape[0]:
        return rows
    pad = np.zeros((bucket - rows.shape[0], rows.shape[1]), np.float32)
    return np.concatenate([rows, pad], axis=0)


@dataclasses.dataclass
class RequestStats:
    """Per-request serving stats, filled when the request completes."""

    queue_wait_s: float = 0.0  # submit -> scoring start
    latency_s: float = 0.0  # submit -> result scattered back
    batch_rows: int = 0  # real rows in the fused call
    bucket_rows: int = 0  # padded rows (the fused call's shape)
    prep_hits: int = 0  # this request's rows found in the prep cache
    prep_misses: int = 0
    # "size" | "budget" (the group's deduped candidate-row bill hit
    # EngineConfig.row_budget) | "timeout" | "deadline" | "manual" |
    # "pressure" | "barrier" (the group was flushed because a mutation
    # arrived for its index) | "drain" (frontend shutdown served the
    # backlog)
    flush_reason: str = ""
    deadline_missed: bool = False  # resolved after its flush-by deadline
    # IVF cost model (0 when off / non-IVF): the nprobe this request's
    # fused call actually probed, and the deduped candidate-row bill of
    # its sub-batch
    effective_nprobe: int = 0
    scanned_rows: int = 0


_FLUSH_REASONS = (
    "size", "budget", "timeout", "deadline", "manual", "pressure",
    "barrier", "drain",
)


@dataclasses.dataclass
class EngineStats:
    """Aggregate counters across the engine lifetime.

    ``snapshot()`` merges the lifetime counters with live gauges
    (current queue depth, oldest queued ticket age) supplied by the
    owning engine, plus the background-compaction counters filled in
    by an attached ``BackgroundCompactor``.
    """

    requests: int = 0
    batches: int = 0  # fused scoring calls
    queue_wait_s: float = 0.0  # sum of the served requests' queue waits
    batched_rows: int = 0  # real rows served
    padded_rows: int = 0  # zero rows added by bucketing
    prep_hits: int = 0
    prep_misses: int = 0
    mutations: int = 0  # submit_add/submit_delete calls
    added_rows: int = 0  # rows ingested via applied mutation batches
    deleted_rows: int = 0  # rows tombstoned via applied batches
    mutation_batches: int = 0  # batched apply steps (the amortized op)
    compactions: int = 0  # synchronous auto_compact evictions
    deadline_missed: int = 0  # requests resolved after their deadline
    queue_hwm: int = 0  # high-water mark of queued query rows
    # background compaction (filled by an attached compactor)
    compact_runs: int = 0  # off-thread survivor builds completed
    compact_retries: int = 0  # rebuilds because mutations landed mid-run
    compact_swap_ms: float = 0.0  # cumulative atomic-swap time
    compact_blocked_ms: float = 0.0  # cumulative wait to acquire the
    # mutation barrier at swap time — serving-path time compaction cost
    # IVF cost model: sub-batches created by the row budget beyond the
    # bucket chunking, fused calls run below the requested nprobe, the
    # cumulative deduped candidate-row bill and the query rows it
    # covered, and a fused-call histogram per effective nprobe (the
    # recall-trade surface: degraded probes show up as mass below the
    # requested nprobe)
    ivf_splits: int = 0
    ivf_degraded: int = 0
    ivf_scanned_rows: int = 0
    ivf_queries: int = 0
    # background-thread supervision (frontend driver / compactor
    # worker): lifetime + consecutive failure counts and the last
    # captured error, so a dying thread is visible in snapshot()
    # instead of silently hanging callers
    driver_failures: int = 0
    driver_consecutive_failures: int = 0
    driver_last_error: Optional[str] = None
    compact_failures: int = 0
    compact_consecutive_failures: int = 0
    compact_last_error: Optional[str] = None
    # durability: WAL append failures surfaced by the apply path (the
    # batch is requeued and retried, never silently dropped)
    wal_failures: int = 0
    wal_last_error: Optional[str] = None
    effective_nprobe: Dict[int, int] = dataclasses.field(
        default_factory=dict
    )
    flushes: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {r: 0 for r in _FLUSH_REASONS}
    )
    # distinct (index, bucket, k, params) combinations that ran — the
    # closed set of shapes the fused calls took
    compiled_buckets: set = dataclasses.field(default_factory=set)
    # zero-arg callable returning live gauges; set by the owning engine
    gauges: Optional[Callable[[], Dict[str, Any]]] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    def snapshot(self) -> Dict[str, Any]:
        fill = self.batched_rows / max(
            1, self.batched_rows + self.padded_rows
        )
        looked_up = self.prep_hits + self.prep_misses
        snap = {
            "requests": self.requests,
            "batches": self.batches,
            "rows": self.batched_rows,
            "queue_wait_s": self.queue_wait_s,
            "bucket_fill": round(fill, 3),
            "prep_hits": self.prep_hits,
            "prep_misses": self.prep_misses,
            "prep_hit_rate": round(self.prep_hits / max(1, looked_up), 3),
            "mutations": self.mutations,
            "added_rows": self.added_rows,
            "deleted_rows": self.deleted_rows,
            "mutation_batches": self.mutation_batches,
            "compactions": self.compactions,
            "deadline_missed": self.deadline_missed,
            "queue_hwm": self.queue_hwm,
            "compaction": {
                "runs": self.compact_runs,
                "retries": self.compact_retries,
                "swap_ms": round(self.compact_swap_ms, 3),
                "blocked_ms": round(self.compact_blocked_ms, 3),
            },
            "supervision": {
                "driver_failures": self.driver_failures,
                "driver_consecutive_failures":
                    self.driver_consecutive_failures,
                "driver_last_error": self.driver_last_error,
                "compact_failures": self.compact_failures,
                "compact_consecutive_failures":
                    self.compact_consecutive_failures,
                "compact_last_error": self.compact_last_error,
            },
            "ivf_cost": {
                "splits": self.ivf_splits,
                "degraded": self.ivf_degraded,
                "scanned_rows": self.ivf_scanned_rows,
                "rows_per_query": round(
                    self.ivf_scanned_rows / max(1, self.ivf_queries), 1
                ),
                "effective_nprobe": {
                    str(n): c
                    for n, c in sorted(self.effective_nprobe.items())
                },
            },
            "flushes": dict(self.flushes),
            "unique_buckets": len(self.compiled_buckets),
        }
        if self.gauges is not None:
            snap.update(self.gauges())
        return snap


class _EventTicket:
    """Shared resolution machinery: a one-shot event, the result/error
    slots, and done callbacks (the asyncio bridge).  Resolution happens
    exactly once; late ``add_done_callback`` registrations fire
    immediately on the caller's thread."""

    def __init__(self):
        self._event = threading.Event()
        self._cb_lock = threading.Lock()
        self._callbacks: list = []
        self._result: Optional[Any] = None
        self._error: Optional[BaseException] = None

    @property
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def error(self) -> Optional[BaseException]:
        """The resolution error, if the ticket failed (None while
        pending or on success)."""
        return self._error

    def add_done_callback(self, fn) -> None:
        """Run ``fn(self)`` when the ticket resolves (immediately if it
        already has).  Callbacks run on the resolving thread and must
        not block."""
        with self._cb_lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _fire(self) -> None:
        with self._cb_lock:
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            fn(self)

    def _settle(self, result) -> None:
        self._result = result
        self._fire()

    def _fail(self, error: BaseException) -> None:
        if self._event.is_set():  # never overwrite a resolution
            return
        self._error = error
        self._fire()

    def _wait(self, timeout: Optional[float]) -> None:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"ticket unresolved after {timeout}s (is a driver "
                f"thread or flush() serving this engine?)"
            )


class Ticket(_EventTicket):
    """Handle for a submitted request; resolves when its group flushes.

    Event-backed: any number of threads may block in ``result()``
    concurrently — exactly one fused call serves the group, everyone
    wakes on the same event."""

    def __init__(self, engine: "QueryEngine", group: tuple, k: int,
                 n_rows: int, deadline: Optional[float] = None):
        super().__init__()
        self._engine = engine
        self._group = group
        self.k = k
        self.n_rows = n_rows
        self.deadline = deadline  # absolute perf_counter flush-by time
        self.stats = RequestStats()

    def result(
        self, timeout: Optional[float] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scores, ids), CPU tensors (float32, int32), each (n_rows, k).

        On an undriven engine, flushes the request's group if it is
        still queued (exactly one caller runs the fused call; others
        block on the event).  On a driven engine, blocks until the
        driver's flush cadence resolves the ticket, up to ``timeout``
        seconds (None = forever; raises TimeoutError on expiry).  If
        the fused call for this request's batch failed (e.g. an option
        the backend rejects), re-raises that error here as well as at
        the flush site."""
        if not self.done and not self._engine.driven:
            try:
                self._engine._flush_group(self._group, "manual")
            except Exception:
                pass  # the ticket carries the error; re-raised below
        self._wait(timeout)
        if self._error is not None:
            raise RuntimeError(
                "request failed during its batch's fused scoring call"
            ) from self._error
        assert self._result is not None
        return self._result


class MutationTicket(_EventTicket):
    """Handle for a submitted mutation; resolves when its index's
    queued mutation batch is applied (next query flush of that index,
    ``flush()``, an aged ``poll()``, backlog overflow — or this
    ticket's ``result()`` on an undriven engine)."""

    def __init__(self, engine: "QueryEngine", index_name: str,
                 kind: str, n_rows: int):
        super().__init__()
        self._engine = engine
        self._index = index_name
        self.kind = kind  # "add" | "delete"
        self.n_rows = n_rows  # rows staged (add) / ids requested (delete)
        self.t_enqueue = time.perf_counter()
        self.apply_s = 0.0  # duration of the whole batched apply step
        self.ids: Optional[np.ndarray] = None  # adds: assigned user ids
        # durability: the WAL seqno this mutation was logged under
        # (None until the apply path logs it; stays None without an
        # attached DurableIndex).  _rows retains an add's host rows
        # until they are logged, so a WAL record can carry the payload.
        self.wal_seqno: Optional[int] = None
        self._rows: Optional[np.ndarray] = None

    def result(self, timeout: Optional[float] = None):
        """Adds: the (n,) int64 user ids the rows received (also on
        ``.ids`` immediately after submit).  Deletes: the number of
        rows newly tombstoned.  On an undriven engine, applies the
        index's pending mutation batch if it is still queued; on a
        driven engine waits for the driver (up to ``timeout``).
        Re-raises the batch's error if the apply failed."""
        if not self.done and not self._engine.driven:
            try:
                self._engine._apply_mutations(self._index)
            except Exception:
                pass  # the ticket carries the error; re-raised below
        self._wait(timeout)
        if self._error is not None:
            raise RuntimeError(
                "mutation failed during its batched apply step"
            ) from self._error
        return self._result


@dataclasses.dataclass
class _Request:
    queries: np.ndarray  # (m, D) float32, contiguous
    k: int
    ticket: Ticket
    t_enqueue: float
    deadline: Optional[float] = None  # absolute flush-by time
    # IVF cost model: (m, nprobe) host-side coarse assignment,
    # best-first, computed at submit.  Advisory — it drives row
    # accounting (budget trigger + split planning) only; execution
    # recomputes the exact assignment on the index's device, so a
    # last-ulp routing difference can never change results
    probe: Optional[np.ndarray] = None


class QueryEngine:
    """See the module docstring.  Thread-safe: any number of threads
    may ``submit``/``result`` concurrently; ``poll``/``flush`` may be
    driven by a serving loop, a ``ServingFrontend`` driver thread, or
    the callers themselves (undriven ``result()`` flushes)."""

    def __init__(
        self,
        indexes: Union[AshIndex, Dict[str, AshIndex], None] = None,
        config: Optional[EngineConfig] = None,
        **overrides,
    ):
        if config is None:
            config = EngineConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self._lock = threading.RLock()
        # signalled whenever queued rows drain (frontend backpressure)
        self._space = threading.Condition(self._lock)
        self._index_locks: Dict[str, threading.RLock] = {}
        self._indexes: Dict[str, AshIndex] = {}
        self._pending: "OrderedDict[tuple, list[_Request]]" = OrderedDict()
        self._pending_rows = 0
        self._prep_cache = ByteLRU(
            config.prep_cache_bytes,
            max_entries=config.prep_cache_entries,
            nbytes_of=self._entry_nbytes,
        )
        # queued mutations, per index: add tickets (rows already staged
        # on the AshIndex), delete id lists, and the oldest submission
        # time (drives the poll() age check)
        self._add_tickets: Dict[str, list] = {}
        self._pending_deletes: Dict[str, list] = {}
        self._mutation_t0: Dict[str, float] = {}
        # IVF cost-model caches: per-index host copies of the coarse
        # quantizer (landmarks^T, 0.5*||mu||^2) and per-mutation-epoch
        # live list sizes
        self._coarse_parts: Dict[str, tuple] = {}
        self._list_sizes: Dict[str, tuple] = {}
        # (name, row digest) -> full best-first list order.  Coarse
        # assignment depends only on the landmarks (fixed per binding;
        # mutations never move them), so repeated queries skip the
        # host matmul+argsort entirely; storing the FULL order makes
        # hits nprobe-independent (a degraded probe reads a prefix)
        self._probe_orders: "OrderedDict[tuple, np.ndarray]" = \
            OrderedDict()
        # per-group running bill: group -> (mutation epoch, probed-list
        # mask, billed live rows).  submit() folds each new probe in
        # incrementally so the budget check stays O(nprobe) per request
        # instead of re-deduping the whole group's probes every time
        self._group_bills: Dict[tuple, tuple] = {}
        # set by ServingFrontend: when True, submit() signals the
        # driver instead of flushing inline and result() only waits
        self.driven = False
        self._on_work: Optional[Callable[[], None]] = None
        # set by BackgroundCompactor.attach(): auto_compact requests
        # route to the worker instead of compacting on this thread
        self._compactor = None
        # per-index DurableIndex (attach_durability): the apply path
        # WAL-logs every mutation batch before its tickets resolve
        self._wals: Dict[str, Any] = {}
        self.stats = EngineStats()
        self.stats.gauges = self._live_gauges
        if isinstance(indexes, AshIndex):
            self.register("default", indexes)
        elif indexes:
            for name, idx in indexes.items():
                self.register(name, idx)

    # -- registry -----------------------------------------------------

    def register(self, name: str, index: AshIndex) -> "QueryEngine":
        """Route ``submit(..., index=name)`` to ``index``.  Re-binding a
        name drops its cached preps (a new index means a new model) and
        first applies any queued mutations against the OLD binding —
        their rows are already staged on that index, so erroring the
        tickets would strand rows that the old index still ingests on
        its next ``apply_pending``.  An apply failure lands on the
        mutation tickets (re-raised by their ``result()``), never here.
        """
        rebind = False
        with self._lock:
            rebind = name in self._indexes
            if name not in self._index_locks:
                self._index_locks[name] = threading.RLock()
        if rebind:
            self._try_flush(self._apply_mutations, name)
            self.invalidate_prep_cache(name)
        with self._lock:
            self._indexes[name] = index
            self._coarse_parts.pop(name, None)
            self._list_sizes.pop(name, None)
            for key in [k for k in self._probe_orders if k[0] == name]:
                del self._probe_orders[key]
            for g in [g for g in self._group_bills if g[0] == name]:
                del self._group_bills[g]
        return self

    def attach_durability(self, durable, *, index: str = "default"):
        """Bind a :class:`~repro_torch.serving.wal.DurableIndex` to
        ``index``: from now on :meth:`_apply_mutations` appends every
        mutation batch to its WAL *before* the batch's tickets resolve,
        so an acknowledged mutation always survives a crash (modulo the
        WAL's fsync policy).  ``durable`` must wrap the registered
        index object — rebinding the name afterwards without a
        matching re-attach is an error the next apply will surface."""
        idx = self._require_index(index)
        if durable.index is not idx:
            raise ValueError(
                f"durable.index is not the index registered as "
                f"{index!r}; attach after register()"
            )
        with self._lock:
            self._wals[index] = durable
        return self

    def durability(self, index: str = "default"):
        """The attached :class:`DurableIndex` of ``index`` (or None)."""
        with self._lock:
            return self._wals.get(index)

    def index(self, name: str = "default") -> AshIndex:
        return self._indexes[name]

    @property
    def index_names(self) -> Tuple[str, ...]:
        return tuple(self._indexes)

    def mutation_barrier(self, name: str = "default") -> threading.RLock:
        """The per-index execution lock: held by every fused scoring
        call and mutation apply of ``name``.  Holding it guarantees no
        search or mutation of that index is in flight — the
        background compactor snapshots and swaps under it, and
        external code may use it the same way (it is re-entrant)."""
        with self._lock:
            lock = self._index_locks.get(name)
            if lock is None:
                lock = self._index_locks[name] = threading.RLock()
            return lock

    def invalidate_prep_cache(self, name: Optional[str] = None) -> None:
        with self._lock:
            if name is None:
                self._prep_cache.clear()
                return
            for key in [k for k in self._prep_cache.keys()
                        if k[0] == name]:
                self._prep_cache.pop(key)

    @property
    def prep_cache_bytes(self) -> int:
        """Current byte footprint of the prep LRU (for capacity
        planning against ``EngineConfig.prep_cache_bytes``)."""
        return self._prep_cache.nbytes

    # -- IVF candidate-row cost model ---------------------------------

    def queue_pressure(self) -> float:
        """Load signal in [0, 1]: the max of queue fill (queued query
        rows vs ``max_pending``) and oldest-ticket age vs the pressure
        horizon (``pressure_age_s``, default 10x ``max_wait_s``) —
        the same gauges ``snapshot()`` reports as ``queue_depth`` /
        ``oldest_ticket_age_s``.  The frontend driver samples it once
        per tick and threads it through ``flush_ready``/``poll``; the
        load-adaptive ladder maps it to an effective nprobe."""
        cfg = self.config
        horizon = cfg.pressure_age_s
        if horizon is None:
            horizon = 10.0 * cfg.max_wait_s
        now = time.perf_counter()
        with self._lock:
            depth = self._pending_rows / max(1, cfg.max_pending)
            oldest = min(
                (reqs[0].t_enqueue for reqs in self._pending.values()
                 if reqs),
                default=None,
            )
        age = (
            0.0 if oldest is None
            else (now - oldest) / max(horizon, 1e-9)
        )
        return float(min(1.0, max(depth, age, 0.0)))

    def _effective_nprobe(self, nprobe: int, pressure: float) -> int:
        """Load-adaptive probing: walk a halving ladder from the
        requested ``nprobe`` down to ``nprobe_min`` as pressure rises.
        Pressure below 1/len(ladder) never degrades (an idle queue
        always serves full fidelity), pressure 1.0 lands on the floor;
        the ladder is a small closed set, so degraded flushes stay on
        a bounded family of call shapes."""
        lo = self.config.nprobe_min
        if lo is None or nprobe <= lo or pressure <= 0.0:
            return nprobe
        ladder = [nprobe]
        while ladder[-1] > lo:
            ladder.append(max(lo, ladder[-1] // 2))
        rung = min(int(min(pressure, 1.0) * len(ladder)),
                   len(ladder) - 1)
        return ladder[rung]

    def _cost_model_on(self, idx: AshIndex, nprobe) -> bool:
        """The cost model engages for partial-probe IVF groups when
        either knob is armed.  nprobe >= nlist runs the dense
        full-scan path — no gather to budget."""
        cfg = self.config
        return (
            idx.backend in _IVF_LIKE
            and nprobe is not None
            and nprobe < idx._state.invlists.shape[0]
            and (cfg.row_budget is not None
                 or cfg.nprobe_min is not None)
        )

    def _host_probe(
        self, name: str, idx: AshIndex, q: np.ndarray, nprobe: int
    ) -> np.ndarray:
        """Approximate coarse assignment, host numpy: (m, nprobe) list
        ids, best-first (so a degraded nprobe reads a column prefix).
        Matches the search's own routing up to matmul summation order —
        plenty for row accounting, and never touched by execution.
        Single-row probes (the dominant serving shape) are served from
        a per-query LRU of full list orders when the traffic repeats."""
        pkey = None
        if q.shape[0] == 1:
            pkey = (name, hashlib.blake2b(
                q.tobytes(), digest_size=16).digest())
            with self._lock:
                order = self._probe_orders.get(pkey)
                if order is not None:
                    self._probe_orders.move_to_end(pkey)
                    return order[None, :nprobe]
        with self._lock:
            parts = self._coarse_parts.get(name)
        if parts is None:
            st = idx._state
            lm_t = np.ascontiguousarray(
                st.model.landmarks.detach().to(torch.float32).cpu()
                .numpy().T
            )
            half = 0.5 * st.model.landmark_sq_norms.detach().to(
                torch.float32).cpu().numpy()
            parts = (lm_t, half)
            with self._lock:
                self._coarse_parts[name] = parts
        lm_t, half = parts
        coarse = q @ lm_t - half[None, :]
        if pkey is not None:
            # single-row fast path: a full argsort of one nlist-sized
            # row beats partition + gather, and caching the whole
            # order serves any later nprobe as a prefix
            order = np.argsort(-coarse[0], kind="stable").astype(
                np.int32)
            with self._lock:
                self._probe_orders[pkey] = order
                while len(self._probe_orders) > 8192:
                    self._probe_orders.popitem(last=False)
            return order[None, :nprobe]
        if nprobe >= coarse.shape[1]:
            order = np.argsort(-coarse, axis=1, kind="stable")
            return order[:, :nprobe].astype(np.int32)
        part = np.argpartition(-coarse, nprobe - 1, axis=1)[:, :nprobe]
        vals = np.take_along_axis(coarse, part, axis=1)
        order = np.argsort(-vals, axis=1, kind="stable")
        return np.take_along_axis(part, order, axis=1).astype(np.int32)

    def _live_list_sizes(self, name: str, idx: AshIndex) -> np.ndarray:
        """(nlist,) live rows per inverted list — the price of probing
        each list — cached per mutation epoch."""
        epoch = idx.mutation_epoch
        with self._lock:
            cached = self._list_sizes.get(name)
            if cached is not None and cached[0] == epoch:
                return cached[1]
        sizes = idx._backend.list_sizes(idx._state)
        with self._lock:
            self._list_sizes[name] = (epoch, sizes)
        return sizes

    def _billed_list_sizes(
        self, name: str, idx: AshIndex
    ) -> np.ndarray:
        """Per-list row bill: live sizes, with non-resident lists of a
        tiered index surcharged by ``page_row_cost`` (a cold probe
        pays its host->device transfer, so adaptive nprobe and budget
        splitting see paging cost).  Residency is sampled now and may
        shift before the flush — the surcharge is advisory, like the
        host probe itself.  Not epoch-cached: the hot set moves on
        every search, not only on mutations."""
        sizes = self._live_list_sizes(name, idx)
        if idx.backend != "tiered_ivf":
            return sizes
        cost = self.config.page_row_cost
        if cost == 1.0:
            return sizes
        resident = idx._backend.resident_mask(idx._state)
        return np.where(
            resident, sizes, np.ceil(sizes * cost).astype(np.int64)
        )

    def _union_bill(
        self, sizes: np.ndarray, probes: "list[np.ndarray]"
    ) -> int:
        """Deduped candidate-row bill: total live rows across the
        union of the probed lists (a list shared by several queries is
        billed once — correlated traffic batches further under the
        same budget than uncorrelated traffic)."""
        if not probes:
            return 0
        lists = np.unique(np.concatenate([p.ravel() for p in probes]))
        lists = lists[(lists >= 0) & (lists < sizes.size)]
        return int(sizes[lists].sum())

    @staticmethod
    def _fold_bill(
        sizes: np.ndarray, mask: np.ndarray, billed: int,
        probe: np.ndarray,
    ) -> int:
        """Fold one probe into a (mask, billed) accumulator in place:
        bill only the lists not yet marked, mark them.  Equivalent to
        re-running :meth:`_union_bill` over every folded probe."""
        if probe.ndim == 2 and probe.shape[0] == 1:
            # single-row probes (the dominant serving shape) hold
            # distinct lists by construction — skip the sort-dedup
            lists = probe.ravel()
        else:
            lists = np.unique(probe.ravel())
        lists = lists[(lists >= 0) & (lists < sizes.size)]
        fresh = lists[~mask[lists]]
        mask[fresh] = True
        return billed + int(sizes[fresh].sum())

    def _bill_probe(
        self, group: tuple, name: str, idx: AshIndex,
        probe: np.ndarray,
    ) -> None:
        """Account a newly queued probe against the group's cached
        running bill (caller holds the lock; the request is already
        queued).  Fresh cache: one O(nprobe) fold.  Missing or
        epoch-stale cache (first probe, or a mutation changed the
        list sizes): rebuild from everything queued."""
        epoch = idx.mutation_epoch
        sizes = self._billed_list_sizes(name, idx)
        cached = self._group_bills.get(group)
        if cached is not None and cached[0] == epoch:
            _, mask, billed = cached
            billed = self._fold_bill(sizes, mask, billed, probe)
        else:
            mask = np.zeros(sizes.size, dtype=bool)
            billed = 0
            for r in self._pending.get(group, ()):
                if r.probe is not None:
                    billed = self._fold_bill(
                        sizes, mask, billed, r.probe
                    )
        self._group_bills[group] = (epoch, mask, billed)

    def _billed_row_cost(self, group: tuple) -> float:
        """Relative cost of one scanned candidate row for this group:
        1.0 for asymmetric scans, ``coarse_row_cost`` when the group's
        opts opt into the int8 coarse first pass — the budget then
        admits proportionally more rows per fused call."""
        if any(k == "coarse" and v is not None for k, v in group[4]):
            return self.config.coarse_row_cost
        return 1.0

    def _group_over_budget(self, group: tuple) -> bool:
        """Whether the group's queued probes already bill past
        ``row_budget`` (caller holds the lock).  Served from the
        running bill when its mutation epoch is current; otherwise
        re-deduped from the queue.  A group that cannot yet fill the
        smallest batch bucket is never budget-flushed: its fused call
        pads up to that bucket regardless, so flushing early would
        only lower the fill without shrinking the gather."""
        budget = self.config.row_budget
        if budget is None:
            return False
        if self._group_rows(group) < self.config.batch_buckets[0]:
            return False
        name = group[0]
        idx = self._indexes.get(name)
        if idx is None:
            return False
        cost = self._billed_row_cost(group)
        cached = self._group_bills.get(group)
        if cached is not None and cached[0] == idx.mutation_epoch:
            return cached[2] * cost > budget
        reqs = self._pending.get(group, ())
        probes = [r.probe for r in reqs if r.probe is not None]
        if not probes:
            return False
        sizes = self._billed_list_sizes(name, idx)
        return self._union_bill(sizes, probes) * cost > budget

    # -- request intake -----------------------------------------------

    def submit(
        self,
        queries,
        k: int = 10,
        *,
        index: str = "default",
        nprobe: Optional[int] = None,
        rerank: int = 0,
        deadline_s: Optional[float] = None,
        **opts,
    ) -> Ticket:
        """Queue a request; returns a :class:`Ticket`.  Undriven, may
        flush (this group on size, any group on timeout or queue
        pressure); driven, signals the frontend driver instead.

        ``deadline_s`` is a flush-by bound relative to now: the group
        flushes no later than the deadline even if the ``max_wait_s``
        timeout has not aged out, and a request resolved past its
        deadline is counted in ``stats.deadline_missed``."""
        if index not in self._indexes:
            raise KeyError(
                f"unknown index {index!r}; registered: {self.index_names}"
            )
        idx = self._indexes[index]
        q = _host_rows(queries)
        if q.ndim == 1:
            q = q[None, :]
        if q.ndim != 2:
            raise ValueError(f"queries must be (m, D) or (D,): {q.shape}")
        dim = idx.model.landmarks.shape[1]
        if q.shape[1] != dim:
            # reject here: a mismatched row would join the group and
            # blow up mid-flush, taking unrelated requests with it
            raise ValueError(
                f"query dim {q.shape[1]} != index {index!r} dim {dim}"
            )
        if k < 1:
            raise ValueError(f"k must be >= 1: {k}")
        if deadline_s is not None and deadline_s < 0:
            raise ValueError(f"deadline_s must be >= 0: {deadline_s}")
        backend = idx.backend
        if backend not in _IVF_LIKE:
            nprobe = None  # only IVF routes coarsely; don't split groups
        else:
            # normalize to the effective value (default applied, clamped
            # to the invlist count) so nprobe=None, the explicit default
            # and any over-large value share one group/bucket
            nprobe = idx._backend.resolve_nprobe(idx._state, nprobe)
        # rerank requests must reproduce the direct path's shortlist of
        # max(rerank, k) candidates, so that size is part of the group
        # key and _run_batch clamps k_run to it.  Requests with
        # rerank >= k all share one group (shortlist == rerank); a
        # request with rerank < k gets its own (shortlist == its k) —
        # mixed-k groups there cannot share a fused call bit-identically.
        # Coarse requests without rerank refine max(L, k) coarse
        # candidates (L = their shortlist= or the default), which plays
        # the same part: the reference keys them by opts alone, so a
        # request with k below its k bucket refined a deeper shortlist
        # there than in a direct search
        if rerank:
            shortlist = max(rerank, k)
        elif opts.get("coarse") is not None:
            shortlist = max(opts.get("shortlist") or default_shortlist(), k)
        else:
            shortlist = None
        group = (index, nprobe, rerank, shortlist,
                 tuple(sorted(opts.items())))

        driven = self.driven
        if not driven:
            # bounded queue: free space by serving, never by dropping
            with self._lock:
                pressured = (
                    self._pending_rows + q.shape[0] > self.config.max_pending
                    and self._pending_rows > 0
                )
            if pressured:
                self._try_flush(self._flush_all, "pressure")

        probe = None
        if self._cost_model_on(idx, nprobe):
            probe = self._host_probe(index, idx, q, nprobe)

        now = time.perf_counter()
        deadline = None if deadline_s is None else now + deadline_s
        ticket = Ticket(self, group, k, q.shape[0], deadline)
        with self._lock:
            self._pending.setdefault(group, []).append(
                _Request(q, k, ticket, now, deadline, probe)
            )
            if probe is not None:
                self._bill_probe(group, index, idx, probe)
            self._pending_rows += q.shape[0]
            self.stats.requests += 1
            self.stats.queue_hwm = max(
                self.stats.queue_hwm, self._pending_rows
            )
            group_full = (
                self._group_rows(group) >= self.config.batch_buckets[-1]
            )
            over_bound = self._pending_rows > self.config.max_pending
            # cost model: a group whose deduped candidate-row bill
            # already exceeds the budget gains nothing by waiting for
            # the bucket to fill — every extra query only deepens the
            # serialized gather behind all its tickets
            budget_full = (
                not group_full
                and probe is not None
                and self._group_over_budget(group)
            )

        if driven:
            # wake the driver only when this submit made something
            # flushable — a fillable bucket, an over-budget bill, or
            # queue pressure.  Sub-bucket groups ride the driver's
            # poll tick instead (bounded by poll_interval_s), so a
            # burst of submits costs one driver scan, not one per row
            if group_full or budget_full or over_bound:
                self._notify_work()
        elif group_full or over_bound:
            # bucket fillable, or a single request alone exceeds the
            # queue bound: serve now rather than sit past max_pending
            self._try_flush(self._flush_group, group, "size")
        elif budget_full:
            self._try_flush(self._flush_group, group, "budget")
        else:
            self._try_flush(self.poll)
        return ticket

    def search(self, queries, k: int = 10, **kw):
        """Synchronous convenience: submit + resolve immediately.
        (scores, ids) CPU tensors, each (m, k)."""
        return self.submit(queries, k, **kw).result()

    # -- mutation intake ----------------------------------------------

    def submit_add(self, rows, *, index: str = "default") -> MutationTicket:
        """Queue rows for batched ingestion; returns a
        :class:`MutationTicket` whose ``.ids`` already holds the user
        ids the rows will carry (assigned now, in submission order).

        Barriers the index first: queued query groups for it flush
        (they were submitted before this mutation and must see the
        pre-mutation state).  The rows stage host-side and the
        expensive apply (one IVF re-sort for the WHOLE batch) is
        deferred to the next query flush of this index, ``flush()``, an
        aged ``poll()``, or backlog overflow.
        """
        idx = self._require_index(index)
        q = _host_rows(rows)
        if q.ndim == 1:
            q = q[None, :]
        dim = idx.model.landmarks.shape[1]
        if q.ndim != 2 or q.shape[1] != dim:
            raise ValueError(
                f"add rows must be (n, {dim}) for index {index!r}: "
                f"got {q.shape}"
            )
        self._barrier(index)
        ticket = MutationTicket(self, index, "add", q.shape[0])
        with self.mutation_barrier(index):
            # staging mutates index state: serialize against in-flight
            # applies so id assignment stays in submission order
            ticket.ids = idx.stage_add(q)
            ticket._rows = q  # retained until the apply path logs it
            with self._lock:
                self._add_tickets.setdefault(index, []).append(ticket)
                self._mutation_t0.setdefault(index, ticket.t_enqueue)
                self.stats.mutations += 1
        self._maybe_apply(index)
        if self.driven:
            self._notify_work()
        return ticket

    def submit_delete(self, ids, *, index: str = "default") -> MutationTicket:
        """Queue a tombstone delete by user id; the ticket resolves to
        the number of rows newly removed (unknown / already-deleted
        ids are ignored).  Same barrier/batching semantics as
        :meth:`submit_add`; deletes never pay a re-sort at all — only
        an eventual ``compact()`` does."""
        self._require_index(index)
        if isinstance(ids, torch.Tensor):
            ids = ids.detach().cpu().numpy()
        del_ids = np.asarray(ids).reshape(-1).astype(np.int64)
        self._barrier(index)
        ticket = MutationTicket(self, index, "delete", int(del_ids.size))
        with self._lock:
            self._pending_deletes.setdefault(index, []).append(
                (del_ids, ticket)
            )
            self._mutation_t0.setdefault(index, ticket.t_enqueue)
            self.stats.mutations += 1
        self._maybe_apply(index)
        if self.driven:
            self._notify_work()
        return ticket

    def _require_index(self, index: str) -> AshIndex:
        if index not in self._indexes:
            raise KeyError(
                f"unknown index {index!r}; registered: {self.index_names}"
            )
        return self._indexes[index]

    def _barrier(self, name: str) -> None:
        """Flush every queued query group of ``name`` (reason
        "barrier") so queries submitted before a mutation never see
        post-mutation state.  Errors stay on the affected query
        tickets, exactly like submit-triggered flushes."""
        with self._lock:
            groups = [g for g in self._pending if g[0] == name]
        for group in groups:
            self._try_flush(self._flush_group, group, "barrier")

    def _mutation_backlog(self, name: str) -> int:
        return self._indexes[name].pending_rows + sum(
            int(d.size) for d, _ in self._pending_deletes.get(name, ())
        )

    def _maybe_apply(self, name: str) -> None:
        with self._lock:
            over = (
                self._mutation_backlog(name)
                >= self.config.max_pending_mutations
            )
        if over:
            self._try_flush(self._apply_mutations, name)

    def _apply_mutations(self, name: str) -> int:
        """Apply the index's queued mutation batch: WAL-log every
        queued mutation (when durability is attached — the batch is
        requeued intact if logging fails, so no acknowledged-but-
        unlogged state can exist), then ONE backend add for every
        staged row, then the queued deletes (order-equivalent to FIFO
        — delete targets are ids, which adds never disturb), then an
        optional auto-compaction.  Tickets fire only after their
        records are in the log.  If the backend apply fails after the
        records were logged, the tickets fail with that error although
        their records stay in the log: a later recovery replays them,
        so a failed ticket's mutation may still take effect (as in the
        reference).  Returns rows added + removed."""
        with self.mutation_barrier(name):
            with self._lock:
                idx = self._indexes.get(name)
                if idx is None:
                    return 0
                has_work = bool(
                    self._add_tickets.get(name)
                    or self._pending_deletes.get(name)
                    or idx.pending_rows
                )
            if not has_work:
                return 0
            # fired before the batch leaves the queues: a failure here
            # (crash or transient error) leaves everything queued for a
            # clean retry
            faults.fire(_FAULT_APPLY)
            with self._lock:
                adds = self._add_tickets.pop(name, [])
                dels = self._pending_deletes.pop(name, [])
                self._mutation_t0.pop(name, None)
                wal = self._wals.get(name)
            if not adds and not dels and idx.pending_rows == 0:
                return 0
            if wal is not None and (adds or dels):
                try:
                    # submission order: adds before deletes, matching
                    # the apply below — replay is order-faithful.  A
                    # ticket logged by an earlier, failed apply keeps
                    # its seqno (idempotent retry, no double record).
                    for ticket in adds:
                        if ticket.wal_seqno is None:
                            ticket.wal_seqno = wal.log_add(
                                ticket._rows, ticket.ids
                            )
                        ticket._rows = None
                    for del_ids, ticket in dels:
                        if ticket.wal_seqno is None:
                            ticket.wal_seqno = wal.log_delete(del_ids)
                except Exception as e:
                    # logging failed (disk full, ...): requeue the
                    # whole batch for a later retry — tickets stay
                    # unresolved rather than acknowledging work the
                    # log does not hold
                    with self._lock:
                        self._add_tickets[name] = (
                            adds + self._add_tickets.get(name, [])
                        )
                        self._pending_deletes[name] = (
                            dels + self._pending_deletes.get(name, [])
                        )
                        pending = adds + [t for _, t in dels]
                        self._mutation_t0[name] = min(
                            t.t_enqueue for t in pending
                        )
                        self.stats.wal_failures += 1
                        self.stats.wal_last_error = repr(e)
                    raise
            faults.fire(_FAULT_APPLY_LOGGED)
            t0 = time.perf_counter()
            try:
                # the batch has left the queues: a failure from here on
                # lands on its tickets
                applied = idx.apply_pending()
                removed = 0
                for del_ids, ticket in dels:
                    removed_now = idx.delete(del_ids)
                    ticket._result = removed_now
                    removed += removed_now
            except Exception as e:
                for ticket in adds + [t for _, t in dels]:
                    ticket._fail(e)
                raise
            faults.fire(_FAULT_APPLY_APPLIED)
            if (
                dels
                and self.config.auto_compact is not None
                and idx.dead_fraction > self.config.auto_compact
            ):
                if self._compactor is not None:
                    # compaction cost leaves the serving path: the
                    # worker builds survivor arrays off-thread and
                    # swaps them in between flushes
                    self._compactor.request(name)
                else:
                    n_before = idx.n
                    idx.compact(self.config.auto_compact)
                    if idx.n != n_before:
                        with self._lock:
                            self.stats.compactions += 1
                        if wal is not None:
                            wal.log_marker("compact")
            dt = time.perf_counter() - t0
            for ticket in adds:
                ticket._result = ticket.ids
            for ticket in adds + [t for _, t in dels]:
                ticket.apply_s = dt
                ticket._fire()
            with self._lock:
                self.stats.mutation_batches += 1
                self.stats.added_rows += applied
                self.stats.deleted_rows += removed
            return applied + removed

    # -- flushing -----------------------------------------------------

    def poll(self, pressure: Optional[float] = None) -> int:
        """Flush groups whose oldest request exceeded ``max_wait_s``
        ("timeout") or whose earliest flush-by deadline arrived
        ("deadline"), and apply mutation batches older than
        ``max_wait_s``.  Call this from the serving loop's idle path
        (the ``ServingFrontend`` driver calls it on every tick,
        passing its per-tick ``queue_pressure()`` sample so
        load-adaptive probing sees the pre-flush backlog).  Returns
        the number of requests completed (mutations resolve their own
        tickets)."""
        now = time.perf_counter()
        due = []
        with self._lock:
            for group, reqs in self._pending.items():
                if not reqs:
                    continue
                if now - reqs[0].t_enqueue >= self.config.max_wait_s:
                    due.append((group, "timeout"))
                    continue
                deadlines = [
                    r.deadline for r in reqs if r.deadline is not None
                ]
                if deadlines and now >= min(deadlines):
                    due.append((group, "deadline"))
            aged = [
                nm for nm, t0 in self._mutation_t0.items()
                if now - t0 >= self.config.max_wait_s
            ]
        done = 0
        for group, reason in due:
            done += self._flush_group(group, reason, pressure)
        for name in aged:
            self._apply_mutations(name)
        return done

    def flush_ready(self, pressure: Optional[float] = None) -> int:
        """Driver-facing size/budget/pressure cadence: flush every
        group that can fill the largest bucket ("size") or whose
        deduped candidate-row bill exceeds ``row_budget`` ("budget"),
        and — as a safety net if the queue bound is exceeded —
        everything ("pressure").  Returns requests completed."""
        with self._lock:
            big = self.config.batch_buckets[-1]
            ready = [
                (g, "size") for g in self._pending
                if self._group_rows(g) >= big
            ]
            if self.config.row_budget is not None:
                seen = {g for g, _ in ready}
                ready += [
                    (g, "budget") for g in self._pending
                    if g not in seen and self._group_over_budget(g)
                ]
            pressured = self._pending_rows > self.config.max_pending
        done = 0
        for group, reason in ready:
            done += self._flush_group(group, reason, pressure)
        if pressured:
            done += self._flush_all("pressure", pressure)
        return done

    def flush(self) -> int:
        """Serve everything queued, now — query groups AND mutation
        batches.  Returns requests completed; an empty flush is a
        no-op returning 0."""
        return self._drain("manual")

    def drain(self) -> int:
        """Like :meth:`flush` but tagged "drain" in the flush-reason
        telemetry — the frontend's shutdown path."""
        return self._drain("drain")

    def _drain(self, reason: str) -> int:
        done = self._flush_all(reason)
        with self._lock:
            names = list(self._mutation_t0)
        for name in names:
            self._apply_mutations(name)
        return done

    def _flush_all(
        self, reason: str, pressure: Optional[float] = None
    ) -> int:
        done = 0
        with self._lock:
            groups = list(self._pending)
        for group in groups:
            done += self._flush_group(group, reason, pressure)
        return done

    @staticmethod
    def _try_flush(fn, *args) -> None:
        """Run a flush triggered from inside ``submit`` without letting
        its errors escape: the caller must always receive its Ticket,
        and a failing fused call (possibly an unrelated group's) already
        resolved every affected ticket with the error — delivered when
        that ticket's ``result()`` is called."""
        try:
            fn(*args)
        except Exception:
            pass

    @property
    def pending_requests(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._pending.values())

    @property
    def pending_rows(self) -> int:
        """Queued query rows (the ``max_pending`` bound applies to
        this; the frontend's backpressure gate watches it)."""
        return self._pending_rows

    def _group_rows(self, group: tuple) -> int:
        return sum(
            r.queries.shape[0] for r in self._pending.get(group, ())
        )

    def _live_gauges(self) -> Dict[str, Any]:
        """Live queue gauges merged into ``stats.snapshot()``."""
        now = time.perf_counter()
        cfg = self.config
        horizon = cfg.pressure_age_s
        if horizon is None:
            horizon = 10.0 * cfg.max_wait_s
        with self._lock:
            oldest = min(
                (r.t_enqueue for reqs in self._pending.values()
                 for r in reqs),
                default=None,
            )
            age = 0.0 if oldest is None else now - oldest
            pressure = min(1.0, max(
                self._pending_rows / max(1, cfg.max_pending),
                age / max(horizon, 1e-9),
            ))
            gauges = {
                "queue_depth": self._pending_rows,
                "oldest_ticket_age_s": (
                    0.0 if oldest is None else round(age, 6)
                ),
                "queue_pressure": round(pressure, 4),
                "durability": {
                    "wal_failures": self.stats.wal_failures,
                    "wal_last_error": self.stats.wal_last_error,
                    "indexes": {
                        nm: d.stats() for nm, d in self._wals.items()
                    },
                },
            }
            tier = {
                nm: ix._backend.tier_stats(ix._state)
                for nm, ix in self._indexes.items()
                if ix.backend == "tiered_ivf"
            }
            if tier:
                gauges["tier"] = tier
            return gauges

    def _notify_work(self) -> None:
        cb = self._on_work
        if cb is not None:
            cb()

    def _abort_pending(self, exc: BaseException) -> int:
        """Fail every queued query ticket with ``exc`` (frontend
        ``stop(drain=False)``).  Mutation batches are APPLIED, not
        failed — their rows are already staged on the index, so
        failing the tickets would strand state the index ingests on
        its next apply anyway."""
        with self._lock:
            names = list(self._mutation_t0)
        for name in names:
            self._try_flush(self._apply_mutations, name)
        with self._lock:
            popped = list(self._pending.items())
            self._pending.clear()
            self._group_bills.clear()
            self._pending_rows = 0
            self._space.notify_all()
        n = 0
        for _, reqs in popped:
            for r in reqs:
                r.ticket._fail(exc)
                n += 1
        return n

    def _flush_group(
        self, group: tuple, reason: str,
        pressure: Optional[float] = None,
    ) -> int:
        with tracing.span("engine.flush"):
            name = group[0]
            if pressure is None and self.config.nprobe_min is not None:
                # undriven flush with adaptive probing armed: sample the
                # backlog before popping this group out of it
                pressure = self.queue_pressure()
            with self.mutation_barrier(name):
                with self._lock:
                    queued = group in self._pending
                if queued:
                    # every queued query of this index was submitted AFTER
                    # the mutations still pending for it (each mutation
                    # submission barrier-flushed the older queries before
                    # staging), so applying the backlog here makes the
                    # batch observe exactly the mutations submitted before
                    # it — including during a barrier flush, where the
                    # NEWEST mutation is not queued yet and therefore
                    # (correctly) not applied.
                    self._apply_mutations(name)
                with self._lock:
                    reqs = self._pending.pop(group, None)
                    self._group_bills.pop(group, None)
                    if not reqs:
                        return 0
                    self._pending_rows -= sum(
                        r.queries.shape[0] for r in reqs
                    )
                    self.stats.flushes[reason] += 1
                    self._space.notify_all()  # queue rows freed
                with tracing.span("engine.plan"):
                    eff_nprobe, chunks, bills = self._plan_chunks(
                        group, reqs, pressure
                    )
                for i, chunk in enumerate(chunks):
                    try:
                        self._run_batch(
                            group, chunk, reason,
                            eff_nprobe=eff_nprobe, billed=bills[i],
                        )
                    except Exception as e:
                        # the failed chunk's tickets carry the error
                        # already (_run_batch); later chunks were popped
                        # off the queue too, so resolve them with it as
                        # well — no request may end up neither served nor
                        # errored
                        for later in chunks[i + 1:]:
                            for r in later:
                                r.ticket._fail(e)
                        raise
                return len(reqs)

    def _plan_chunks(
        self,
        group: tuple,
        reqs: "list[_Request]",
        pressure: Optional[float],
    ) -> Tuple[Optional[int], "list[list[_Request]]", "list[int]"]:
        """Sub-batch a popped group for execution.

        Always: FIFO chunks bounded by the largest bucket (a single
        oversized request still rides alone, padded to a multiple).
        IVF cost model: each chunk's deduped candidate-row bill (union
        of live rows across its queries' probed lists) additionally
        stays within ``row_budget`` — queries sharing lists batch
        together cheaply, disjoint ones split — and under queue
        pressure the whole flush degrades to the ladder's effective
        nprobe (billed on the probe column prefix).  A budget split
        never cuts a chunk below the smallest bucket: such a chunk
        pads back up to that bucket anyway, so the split would add a
        dispatch without shrinking any gather.  The budget's bite is
        keeping a backlogged group off the big bucket — one
        serialized monster gather becomes several small-bucket calls.
        Returns (effective nprobe or None, chunks, per-chunk bills).
        """
        name, nprobe, _, _, _ = group
        big = self.config.batch_buckets[-1]
        small = self.config.batch_buckets[0]
        probes = [r.probe for r in reqs]
        costed = nprobe is not None and all(
            p is not None for p in probes
        )
        eff = nprobe
        budget = None
        sizes = None
        if costed:
            if self.config.nprobe_min is not None:
                eff = self._effective_nprobe(
                    nprobe, pressure if pressure is not None else 0.0
                )
            budget = self.config.row_budget
            idx = self._indexes.get(name)
            costed = idx is not None
            if costed:
                sizes = self._billed_list_sizes(name, idx)
        row_cost = self._billed_row_cost(group)

        chunks: "list[list[_Request]]" = [[]]
        bills: "list[int]" = [0]
        rows = 0
        # running union of the current chunk's probed lists, folded
        # incrementally (one O(nprobe) mask probe per request, not a
        # re-dedup of the whole chunk per request)
        mask = np.zeros(sizes.size, dtype=bool) if costed else None
        splits = 0
        for r in reqs:
            m = r.queries.shape[0]
            lists = None
            if costed and r.probe is not None:
                p = r.probe[:, :eff] if eff < r.probe.shape[1] \
                    else r.probe
                lists = np.unique(p.ravel())
                lists = lists[(lists >= 0) & (lists < sizes.size)]
            over_rows = bool(chunks[-1]) and rows + m > big
            over_budget = False
            if not over_rows and lists is not None \
                    and budget is not None and chunks[-1] \
                    and rows >= small:
                fresh = lists[~mask[lists]]
                over_budget = (
                    (bills[-1] + int(sizes[fresh].sum())) * row_cost
                    > budget
                )
            if over_rows or over_budget:
                if over_budget:
                    splits += 1
                chunks.append([])
                bills.append(0)
                rows = 0
                if mask is not None:
                    mask[:] = False
            chunks[-1].append(r)
            rows += m
            if lists is not None:
                fresh = lists[~mask[lists]]
                mask[fresh] = True
                bills[-1] += int(sizes[fresh].sum())

        if costed:
            with self._lock:
                self.stats.ivf_splits += splits
                self.stats.ivf_scanned_rows += sum(bills)
                self.stats.ivf_queries += sum(
                    r.queries.shape[0] for r in reqs
                )
                self.stats.effective_nprobe[eff] = (
                    self.stats.effective_nprobe.get(eff, 0)
                    + len(chunks)
                )
                if eff < nprobe:
                    self.stats.ivf_degraded += len(chunks)
        return (eff if costed else nprobe), chunks, bills

    # -- the fused scoring call ---------------------------------------

    def _run_batch(
        self, group: tuple, reqs: "list[_Request]", reason: str,
        *, eff_nprobe: Optional[int] = None, billed: int = 0,
    ) -> None:
        name, nprobe, rerank, shortlist, opts = group
        if eff_nprobe is not None:
            # cost model / load-adaptive probing: the flush planner may
            # have degraded nprobe below the group's requested value
            nprobe = eff_nprobe
        idx = self._indexes[name]
        try:
            rows = np.concatenate([r.queries for r in reqs], axis=0)
            n_real = rows.shape[0]
            bucket = _bucketize(self.config.batch_buckets, n_real)
            rows = _pad_rows(rows, bucket)
            k_max = max(r.k for r in reqs)
            k_run = min(
                _bucketize(self.config.k_buckets, k_max), idx.n
            )
            if shortlist is not None:
                # rerank: the backend's shortlist is max(rerank, k_run);
                # the direct path's is max(rerank, k).  Every request in
                # this group shares shortlist == max(rerank, its k)
                # >= k_max (the group key guarantees it), so clamping
                # k_run keeps the fused call's shortlist — hence its
                # rerank candidates and results — bit-identical to
                # per-request search.
                k_run = min(k_run, shortlist)

            with tracing.span("engine.prep"):
                prep, hit_rows = self._prep_for(name, idx, rows, n_real)
            t_score = time.perf_counter()  # after prep/hash: queue wait
            with tracing.span("engine.call"):
                scores, ids = idx.search_prepped(
                    prep, k=k_run, nprobe=nprobe, rerank=rerank,
                    **dict(opts),
                )
            # one copy to the host per field; the first waits for the
            # fused call, so a kernel fault surfaces here, on its tickets
            with tracing.span("engine.copy"):
                scores, ids = scores.cpu(), ids.cpu()
        except Exception as e:
            # resolve every ticket with the error (a later result()
            # re-raises it) before surfacing at the flush site — an
            # explicit flush()/poll(); submit-triggered flushes swallow
            # it (_try_flush) so the caller still gets its Ticket
            for r in reqs:
                r.ticket._fail(e)
            raise

        with tracing.span("engine.resolve"):
            with self._lock:
                self.stats.batches += 1
                self.stats.batched_rows += n_real
                self.stats.padded_rows += bucket - n_real
                self.stats.queue_wait_s += sum(t_score - r.t_enqueue
                                               for r in reqs)
                self.stats.compiled_buckets.add(
                    (name, idx.backend, bucket, k_run, nprobe, rerank, opts)
                )

            offset = 0
            missed = 0
            for r in reqs:
                m = r.queries.shape[0]
                s = scores[offset:offset + m]
                i = ids[offset:offset + m]
                if r.k <= k_run:  # top-k prefix of the bucket's top-k_run
                    s, i = s[:, : r.k], i[:, : r.k]
                else:  # k > n: pad out with the missing-candidate sentinel
                    pad = r.k - k_run
                    s = torch.cat(
                        [s, torch.full((m, pad), NEG_INF, dtype=s.dtype)],
                        dim=1,
                    )
                    i = torch.cat(
                        [i, torch.full((m, pad), -1, dtype=i.dtype)], dim=1
                    )
                now = time.perf_counter()
                st = r.ticket.stats
                st.queue_wait_s = t_score - r.t_enqueue
                st.latency_s = now - r.t_enqueue
                st.batch_rows = n_real
                st.bucket_rows = bucket
                st.prep_hits = int(hit_rows[offset:offset + m].sum())
                st.prep_misses = m - st.prep_hits
                st.flush_reason = reason
                if r.probe is not None and nprobe is not None:
                    st.effective_nprobe = nprobe
                    st.scanned_rows = billed
                if r.deadline is not None and now > r.deadline:
                    st.deadline_missed = True
                    missed += 1
                r.ticket._settle((s, i))
                offset += m
            if missed:
                with self._lock:
                    self.stats.deadline_missed += missed

    # -- prep cache ---------------------------------------------------

    def _prep_for(
        self, name: str, idx: AshIndex, rows: np.ndarray, n_real: int
    ) -> Tuple[QueryPrep, np.ndarray]:
        """QueryPrep for the padded bucket ``rows``, reusing cached
        per-row projections.  Returns (prep, per-row hit flags for the
        real rows)."""
        bucket = rows.shape[0]
        hit_rows = np.zeros(n_real, dtype=bool)
        if not self.config.prep_cache_enabled:
            with self._lock:
                self.stats.prep_misses += n_real
            return idx.prepare(torch.from_numpy(rows)), hit_rows

        keys = [
            (name, hashlib.blake2b(rows[i].tobytes(),
                                   digest_size=16).digest())
            for i in range(bucket)
        ]
        row_preps: list = [None] * bucket
        miss = []
        with self._lock:
            for i, key in enumerate(keys):
                cached = self._prep_cache.get(key)
                if cached is not None:
                    row_preps[i] = cached
                    if i < n_real:
                        hit_rows[i] = True
                else:
                    miss.append(i)
            self.stats.prep_hits += int(hit_rows.sum())
            self.stats.prep_misses += n_real - int(hit_rows.sum())

        dev = idx.model.device
        if not miss:
            return self._stack_prep(row_preps, dev), hit_rows
        if len(miss) == bucket:
            # cold bucket: one prepare over the padded rows, no restack
            # (only real rows are cached — pad rows recur only while
            # buckets run underfilled and would waste LRU capacity)
            prep = idx.prepare(torch.from_numpy(rows))
            self._cache_prep_rows(keys, prep, range(n_real))
            return prep, hit_rows
        # warm bucket: prepare only the misses (padded to a bucket shape
        # so prepare sees a closed set of shapes), then merge with cached
        # rows; a row's prep does not depend on the rows prepared with it
        mb = _bucketize(self.config.batch_buckets, len(miss))
        miss_rows = _pad_rows(rows[miss], mb)
        mp_np = self._host_fields(idx.prepare(torch.from_numpy(miss_rows)))
        for j, i in enumerate(miss):
            row_preps[i] = tuple(a[j] for a in mp_np)
        with self._lock:
            for i in miss:
                if i < n_real:
                    self._prep_cache.put(keys[i], row_preps[i])
        return self._stack_prep(row_preps, dev), hit_rows

    @staticmethod
    def _host_fields(prep: QueryPrep) -> tuple:
        """The prep's four fields as host numpy arrays (one copy each;
        the cache holds preps on the host)."""
        return tuple(a.cpu().numpy() for a in
                     (prep.q, prep.q_proj, prep.ip_q_landmarks,
                      prep.q_sq_norm))

    def _cache_prep_rows(self, keys, prep: QueryPrep, idxs) -> None:
        arrs = self._host_fields(prep)
        with self._lock:
            for i in idxs:
                self._prep_cache.put(keys[i], tuple(a[i] for a in arrs))

    @staticmethod
    def _entry_nbytes(entry: tuple) -> int:
        return sum(int(a.nbytes) for a in entry)

    @staticmethod
    def _stack_prep(row_preps, device) -> QueryPrep:
        # stack on the host, then one copy to the device per field
        q, q_proj, ipl, qsq = (
            torch.from_numpy(np.stack([r[f] for r in row_preps])).to(device)
            for f in range(4)
        )
        return QueryPrep(
            q=q, q_proj=q_proj, ip_q_landmarks=ipl, q_sq_norm=qsq
        )
