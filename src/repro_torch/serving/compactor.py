"""BackgroundCompactor — tombstone eviction off the serving path.

Counterpart of ``repro.serving.compactor``.
``AshIndex.compact`` rewrites codes/stats/raw over the surviving rows;
run synchronously (as engine ``auto_compact`` did before this module)
it stalls every in-flight query of that index for the whole rewrite.
The compactor moves the rewrite to a worker thread and keeps only the
POINTER SWAP on the serving path:

1. **snapshot** — under the engine's per-index mutation barrier (so no
   search or mutation apply is mid-flight), record the index's
   ``mutation_epoch`` and take a shallow copy of its backend state.
   No mutation writes a backend state's tensors in place: flat and
   IVF return a new frozen state, sharded and tiered rebind attributes
   of the live state object to new tensors, which a shallow copy does
   not see — so a shallow copy is a consistent snapshot.
2. **build** — OFF the lock, run the backend's ``compact`` on the
   snapshot: flat/IVF compaction is pure (returns a new state).
   Searches and mutations proceed concurrently against the live state
   the whole time; the rebuild's kernels share the default stream with
   theirs.
3. **swap** — re-acquire the barrier and compare epochs.  Unchanged ⇒
   no mutation landed since the snapshot: install the survivor state
   atomically (a single attribute assignment under the same lock every
   fused call holds).  Changed ⇒ the built state is stale: drop it and
   retry from a fresh snapshot (the rebuild includes the delta), up to
   ``max_retries`` — a hot index just keeps its tombstones until the
   next request, which is always safe (tombstones are masked at scan
   time; compaction is an optimization, never a correctness event).

Because the swap happens under the same lock as every search and
mutation apply, and only when the epoch proves the searchable state
is unchanged, results are bit-identical to a fresh build over the
survivors regardless of when the swap lands — the compaction
contract, preserved under concurrency.

The engine routes ``auto_compact`` here when a compactor is attached
(``BackgroundCompactor(engine)`` attaches itself); telemetry lands in
``engine.stats`` (``compact_runs`` / ``compact_retries`` /
``compact_swap_ms`` / ``compact_blocked_ms`` — the last being the only
serving-path time compaction still costs).

    with BackgroundCompactor(engine) as compactor:
        ...  # engine auto_compact now signals the worker
        compactor.request("default")   # or: explicit kick
        compactor.wait_idle()          # test/drain helper
"""
from __future__ import annotations

import copy
import threading
import time
from typing import Optional

from repro_torch.serving.engine import QueryEngine
from repro_torch.testing import faults

# the instant before the survivor state is installed: a crash here
# loses the compaction (never a correctness event — recovery replays
# the WAL over the last checkpoint) but must never corrupt anything
_FAULT_SWAP = faults.point("compactor.swap")


class BackgroundCompactor:
    """See the module docstring."""

    def __init__(
        self,
        engine: QueryEngine,
        max_dead_fraction: Optional[float] = None,
        max_retries: int = 3,
        max_failures: int = 3,
    ):
        self.engine = engine
        # threshold precedence: explicit arg, else the engine's
        # auto_compact, else 0.0 (any tombstone triggers)
        if max_dead_fraction is None:
            max_dead_fraction = engine.config.auto_compact or 0.0
        self.max_dead_fraction = max_dead_fraction
        self.max_retries = max_retries
        # consecutive run_once failures before healthy() turns False
        self.max_failures = max_failures
        self._work = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._lock = threading.Lock()
        self._requested: set[str] = set()
        self._closed = False
        self._started = False
        self._worker = threading.Thread(
            target=self._run, name="ash-compactor", daemon=True
        )
        engine._compactor = self

    # -- lifecycle ----------------------------------------------------

    def start(self) -> "BackgroundCompactor":
        if not self._started:
            self._started = True
            self._worker.start()
        return self

    def __enter__(self) -> "BackgroundCompactor":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop()

    def stop(self) -> None:
        """Stop the worker (a build in flight finishes its swap
        attempt first) and detach from the engine — ``auto_compact``
        falls back to synchronous.  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._work.set()
        if self._started:
            self._worker.join(timeout=60.0)
        if self.engine._compactor is self:
            self.engine._compactor = None

    # -- requests -----------------------------------------------------

    def request(self, name: str = "default") -> None:
        """Queue ``name`` for compaction and wake the worker.
        Non-blocking — safe to call from ``_apply_mutations`` while it
        holds the mutation barrier."""
        with self._lock:
            self._requested.add(name)
            self._idle.clear()
        self._work.set()

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until every queued request has been processed (the
        drain/test helper).  True if idle was reached."""
        return self._idle.wait(timeout)

    # -- the worker ---------------------------------------------------

    def _run(self) -> None:
        while True:
            self._work.wait()
            self._work.clear()
            while True:
                with self._lock:
                    if self._closed:
                        self._requested.clear()
                        self._idle.set()
                        return
                    if not self._requested:
                        self._idle.set()
                        break
                    name = self._requested.pop()
                try:
                    self.run_once(name)
                    with self.engine._lock:
                        self.engine.stats \
                            .compact_consecutive_failures = 0
                except Exception as e:
                    # a failed build must not kill the worker (the
                    # index keeps serving with tombstones masked) —
                    # but it must not vanish either: record it where
                    # snapshot()["supervision"] and healthy() look
                    with self.engine._lock:
                        self.engine.stats.compact_failures += 1
                        self.engine.stats \
                            .compact_consecutive_failures += 1
                        self.engine.stats.compact_last_error = repr(e)

    # -- supervision --------------------------------------------------

    def healthy(self) -> bool:
        """False once the worker thread is gone (while started and not
        stopped) or stuck in a failure streak of ``max_failures`` or
        more."""
        if self._closed or (self._started and not self._worker.is_alive()):
            return False
        with self.engine._lock:
            streak = self.engine.stats.compact_consecutive_failures
        return streak < self.max_failures

    @property
    def last_error(self) -> Optional[str]:
        with self.engine._lock:
            return self.engine.stats.compact_last_error

    def run_once(self, name: str = "default") -> bool:
        """One snapshot → build → epoch-checked swap cycle (with
        bounded retries).  Synchronous — tests and drain paths call it
        directly.  True iff a survivor state was swapped in.  After a
        successful swap, an attached :class:`DurableIndex` is
        checkpointed (then its covered WAL segments dropped) so the
        log stays bounded — the natural truncation point, since the
        compacted state is exactly what replay would rebuild."""
        eng = self.engine
        barrier = eng.mutation_barrier(name)
        for attempt in range(self.max_retries + 1):
            # 1. snapshot under the barrier: nothing is mid-search or
            #    mid-apply, so state + epoch are mutually consistent
            with barrier:
                idx = eng._indexes.get(name)
                if idx is None:
                    return False
                if (
                    idx.dead_fraction <= self.max_dead_fraction
                    or idx.n_live == 0
                ):
                    return False
                epoch = idx.mutation_epoch
                snapshot = copy.copy(idx._state)
            # 2. build survivors OFF the lock — searches keep flowing
            new_state = idx._backend.compact(snapshot)
            # 3. swap iff no mutation landed since the snapshot
            t_wait = time.perf_counter()
            swapped = False
            with barrier:
                t_swap = time.perf_counter()
                blocked_ms = (t_swap - t_wait) * 1e3
                if eng._indexes.get(name) is not idx:
                    return False  # name was rebound mid-build
                if idx.mutation_epoch == epoch:
                    faults.fire(_FAULT_SWAP)
                    idx._state = new_state
                    idx._mutation_epoch += 1
                    swap_ms = (time.perf_counter() - t_swap) * 1e3
                    with eng._lock:
                        eng.stats.compact_runs += 1
                        eng.stats.compact_swap_ms += swap_ms
                        eng.stats.compact_blocked_ms += blocked_ms
                    swapped = True
            if swapped:
                # checkpoint-then-truncate OFF the barrier (the
                # checkpoint re-acquires it only for its brief
                # snapshot+rotate step) so serving never waits on the
                # checkpoint write
                self._checkpoint_after_swap(name, barrier)
                return True
            # stale build: a mutation landed mid-rebuild — retry from
            # a fresh snapshot (which includes the delta)
            with eng._lock:
                eng.stats.compact_retries += 1
        return False

    def _checkpoint_after_swap(self, name: str, barrier) -> None:
        durable = self.engine.durability(name)
        if durable is None:
            return
        with barrier:  # WAL appends are serialized by the barrier
            durable.log_marker("compact")
        durable.checkpoint(barrier=barrier)
