"""ServingFrontend — a driver thread that owns the flush cadence.

Counterpart of ``repro.serving.frontend``.  The bare
:class:`~repro_torch.serving.engine.QueryEngine` is caller-driven:
``submit`` flushes inline on size/pressure, ``result()`` flushes the
caller's own group, and timeout flushes only happen if a serving loop
remembers to ``poll()``.  That is fine single-threaded and useless
under concurrency — an eager ``result()`` caller defeats batching by
flushing a half-full bucket, and nobody owns the timeout cadence.

``ServingFrontend`` puts the engine in **driven** mode and runs ONE
dedicated driver thread that owns every flush decision:

* **size-triggered** — the driver wakes the instant a submission makes
  a group flushable (bucket fillable, over-budget bill, or queue
  pressure — an event, not a poll race) and flushes any group that can
  fill the largest batch bucket; sub-bucket submissions don't wake it
  (they ride the poll tick), so a burst costs one driver scan;
* **deadline/timeout-triggered** — each driver tick runs
  ``engine.poll()``, which flushes groups past ``max_wait_s`` and
  groups whose earliest per-request ``deadline_s`` arrived;
* **mutation cadence** — aged or overflowing mutation backlogs apply
  on the driver too (via ``poll``/``flush_ready``).

Caller-facing API:

* ``frontend.submit(...)`` / ``frontend.search(...)`` — thread-safe
  blocking submission from any number of client threads, with
  **bounded-queue backpressure**: when the engine's queued rows exceed
  ``max_queue_rows``, submitters block (on a condition, not a spin)
  until the driver drains space, up to ``submit_timeout_s``.
* ``await frontend.asearch(...)`` — asyncio facade: the ticket's done
  callback bridges to a ``Future`` on the caller's event loop, so an
  async HTTP handler never blocks a worker thread on ``result()``.
* ``frontend.stop(drain=True)`` — graceful shutdown: refuse new
  submissions, serve everything queued (flush reason "drain"), apply
  pending mutations, then join the driver.  ``drain=False`` fails
  queued query tickets with :class:`FrontendClosed` instead (mutations
  still apply — their rows are already staged on the index).

Use it as a context manager::

    with ServingFrontend(engine) as fe:
        t = fe.submit(q, k=10)
        scores, ids = t.result(timeout=1.0)

Every submission path is safe from any thread, and from coroutines via
``asearch``/``asubmit_add``/``asubmit_delete``.  ``engine.stats``
gauges (queue depth, oldest ticket age, flush reasons, queue HWM) stay
live through ``engine.stats.snapshot()``.
"""
from __future__ import annotations

import asyncio
import dataclasses
import threading
import time
from typing import Optional

import numpy as np

from repro_torch import tracing
from repro_torch.serving.engine import MutationTicket, QueryEngine, Ticket


class FrontendClosed(RuntimeError):
    """Raised on submission to a stopped frontend, and used to fail
    queued tickets on a non-draining ``stop()``."""


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Driver cadence + backpressure knobs.

    ``poll_interval_s`` bounds how late a timeout/deadline flush can
    fire when no submissions arrive (the driver also wakes instantly
    on every submit, so size flushes never wait on it).

    ``max_queue_rows`` is the backpressure gate for *blocking
    submitters* (None = the engine's own ``max_pending``); the engine
    never drops work — submitters wait for space instead, up to
    ``submit_timeout_s`` (None = forever).

    ``default_deadline_s`` is attached to submissions that don't carry
    their own ``deadline_s`` (None = no deadline: the ``max_wait_s``
    timeout cadence alone bounds queueing).
    """

    poll_interval_s: float = 0.0005
    max_queue_rows: Optional[int] = None
    submit_timeout_s: Optional[float] = None
    default_deadline_s: Optional[float] = None
    drain_timeout_s: float = 30.0
    # supervision: after this many CONSECUTIVE driver-tick failures the
    # driver fails every queued query ticket with the captured cause
    # (and keeps doing so while the fault persists) instead of letting
    # callers hang until their timeout
    max_driver_failures: int = 5

    def __post_init__(self):
        if self.poll_interval_s <= 0:
            raise ValueError(
                f"poll_interval_s must be > 0: {self.poll_interval_s}"
            )
        if self.max_queue_rows is not None and self.max_queue_rows < 1:
            raise ValueError(
                f"max_queue_rows must be >= 1: {self.max_queue_rows}"
            )
        if self.max_driver_failures < 1:
            raise ValueError(
                f"max_driver_failures must be >= 1: "
                f"{self.max_driver_failures}"
            )


class ServingFrontend:
    """See the module docstring."""

    def __init__(
        self,
        engine: QueryEngine,
        config: Optional[FrontendConfig] = None,
        **overrides,
    ):
        if config is None:
            config = FrontendConfig(**overrides)
        elif overrides:
            config = dataclasses.replace(config, **overrides)
        self.engine = engine
        self.config = config
        self._max_rows = (
            config.max_queue_rows
            if config.max_queue_rows is not None
            else engine.config.max_pending
        )
        self._work = threading.Event()
        self._closed = False
        self._started = False
        engine.driven = True
        engine._on_work = self._work.set
        self._driver = threading.Thread(
            target=self._drive, name="ash-serving-driver", daemon=True
        )

    # -- lifecycle ----------------------------------------------------

    def start(self) -> "ServingFrontend":
        if not self._started:
            self._started = True
            self._driver.start()
        return self

    def __enter__(self) -> "ServingFrontend":
        return self.start()

    def __exit__(self, exc_type, exc, tb) -> None:
        self.stop(drain=exc_type is None)

    @property
    def running(self) -> bool:
        return self._started and not self._closed

    def stop(self, drain: bool = True) -> None:
        """Shut the frontend down.  ``drain=True`` serves everything
        queued first (bounded by ``drain_timeout_s``); ``drain=False``
        fails queued query tickets with :class:`FrontendClosed`.
        Pending mutations apply either way (their rows are already
        staged on the index).  Idempotent; the engine is returned to
        undriven (caller-flushed) mode."""
        eng = self.engine
        with eng._lock:
            if self._closed:
                return
            self._closed = True
            eng._space.notify_all()  # wake blocked submitters to fail
        self._work.set()  # wake the driver so it can exit
        if self._started:
            self._driver.join(timeout=self.config.drain_timeout_s)
        if drain:
            eng.drain()
        else:
            eng._abort_pending(FrontendClosed("frontend stopped"))
        eng.driven = False
        eng._on_work = None

    # -- the driver thread --------------------------------------------

    def _drive(self) -> None:
        eng = self.engine
        while True:
            with tracing.span("engine.wait"):
                self._work.wait(self.config.poll_interval_s)
            self._work.clear()
            if self._closed:
                return  # stop() drains after the join
            with tracing.span("engine.tick"):
                try:
                    # one pressure sample per tick, taken before any flush
                    # drains the backlog, so every group flushed this tick
                    # sees the same load-adaptive nprobe decision
                    p = eng.queue_pressure()
                    eng.flush_ready(p)  # size + budget + pressure
                    eng.poll(p)  # timeout + deadline + aged mutations
                    with eng._lock:
                        eng.stats.driver_consecutive_failures = 0
                except Exception as e:
                    # fused-call errors already resolved their tickets and
                    # the driver must outlive them — but record every
                    # failure, and once the fault proves persistent stop
                    # hanging callers: fail the queued tickets with the
                    # captured cause
                    with eng._lock:
                        eng.stats.driver_failures += 1
                        eng.stats.driver_consecutive_failures += 1
                        eng.stats.driver_last_error = repr(e)
                        streak = eng.stats.driver_consecutive_failures
                    if streak >= self.config.max_driver_failures:
                        try:
                            eng._abort_pending(e)
                        except Exception:
                            pass

    # -- supervision --------------------------------------------------

    def healthy(self) -> bool:
        """False once the driver thread is gone or stuck in a failure
        streak of ``max_driver_failures`` or more (details in
        ``engine.stats.snapshot()["supervision"]``)."""
        if not self.running or not self._driver.is_alive():
            return False
        with self.engine._lock:
            streak = self.engine.stats.driver_consecutive_failures
        return streak < self.config.max_driver_failures

    @property
    def last_error(self) -> Optional[str]:
        with self.engine._lock:
            return self.engine.stats.driver_last_error

    # -- blocking submission ------------------------------------------

    def submit(self, queries, k: int = 10, **kw) -> Ticket:
        """Thread-safe blocking submission with backpressure; returns
        the engine's :class:`Ticket`.  Blocks while the queue is at
        ``max_queue_rows`` until the driver drains space (up to
        ``submit_timeout_s``; raises TimeoutError after).  Raises
        :class:`FrontendClosed` once stopped."""
        if (
            "deadline_s" not in kw
            and self.config.default_deadline_s is not None
        ):
            kw["deadline_s"] = self.config.default_deadline_s
        eng = self.engine
        # cheap rejection before touching the queue; full validation
        # happens in engine.submit under the lock
        if self._closed:
            raise FrontendClosed("frontend stopped")
        shape = getattr(queries, "shape", None)  # a tensor stays put
        if shape is None:
            shape = np.shape(queries)
        n_rows = 1 if len(shape) <= 1 else int(shape[0])
        deadline = (
            None if self.config.submit_timeout_s is None
            else time.perf_counter() + self.config.submit_timeout_s
        )
        with eng._space:
            while (
                not self._closed
                and eng._pending_rows + n_rows > self._max_rows
                and eng._pending_rows > 0
            ):
                remaining = (
                    None if deadline is None
                    else deadline - time.perf_counter()
                )
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"queue full ({eng._pending_rows} rows) for "
                        f"{self.config.submit_timeout_s}s"
                    )
                self._work.set()  # make sure the driver is draining
                eng._space.wait(
                    remaining if remaining is not None
                    else self.config.poll_interval_s
                )
            if self._closed:
                raise FrontendClosed("frontend stopped")
            # still under the (re-entrant) lock: the space check and
            # the enqueue are atomic, so the bound is hard
            return eng.submit(queries, k, **kw)

    def search(self, queries, k: int = 10, timeout: Optional[float] = None,
               **kw):
        """Blocking submit + resolve.  (scores, ids), each (m, k)."""
        return self.submit(queries, k, **kw).result(timeout)

    def submit_add(self, rows, **kw) -> MutationTicket:
        if self._closed:
            raise FrontendClosed("frontend stopped")
        return self.engine.submit_add(rows, **kw)

    def submit_delete(self, ids, **kw) -> MutationTicket:
        if self._closed:
            raise FrontendClosed("frontend stopped")
        return self.engine.submit_delete(ids, **kw)

    # -- asyncio facade -----------------------------------------------

    async def _bridge(self, submit_fn):
        """Run a blocking submit in the loop's executor, then bridge
        the ticket's done callback to an asyncio Future."""
        loop = asyncio.get_running_loop()
        ticket = await loop.run_in_executor(None, submit_fn)
        fut: asyncio.Future = loop.create_future()

        def _done(t):
            def _resolve():
                if fut.cancelled():
                    return
                if t.error is not None:
                    fut.set_exception(
                        RuntimeError("request failed in its fused batch")
                    )
                    fut.exception()  # consumed: cancellation is benign
                else:
                    fut.set_result(t._result)

            loop.call_soon_threadsafe(_resolve)

        ticket.add_done_callback(_done)
        return await fut

    async def asearch(self, queries, k: int = 10, **kw):
        """``await``-able search: (scores, ids) CPU tensors.  The
        submission (which may block on backpressure) runs in the
        loop's executor; resolution is callback-driven — no thread
        parks in ``result()``."""
        return await self._bridge(lambda: self.submit(queries, k, **kw))

    async def asubmit_add(self, rows, **kw):
        """``await``-able add; resolves to the assigned user ids."""
        return await self._bridge(lambda: self.submit_add(rows, **kw))

    async def asubmit_delete(self, ids, **kw):
        """``await``-able delete; resolves to rows newly removed."""
        return await self._bridge(lambda: self.submit_delete(ids, **kw))
