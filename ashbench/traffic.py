"""The one traffic generator: a mix file's parameters, a cell's rate and
a seed in, a plan of calls or requests out, and the loops that drive
it.

``kind: batch`` (offline batch search, as big-ann-benchmarks runs it):
one caller issues back-to-back searches of ``rows_per_call`` device
rows, cycling through a pool of ``pool_rows`` rows made at set-up.

``kind: open_loop`` (independent users): requests arrive on a schedule
whatever the system does, each of a size drawn from ``sizes``.  The
number of requests is fixed by the cell's ``rate_per_s`` and the run's
length, their sizes are that many drawn evenly from ``sizes``, and
their arrivals are ``arrivals: poisson``: exponential gaps scaled to
fill the run (a Poisson process conditioned on that count).  Sizes and
gaps are one realization drawn from the mix's ``arrivals_seed``; a
run's seed rotates that sequence, so every seed offers the same
requests at another phase, and draws the rows.  Each request reads
rows of its own, none repeated.  A request's latency runs from when it
was due to when its answer was on the host; how late the sender ran is
kept apart.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Plan:
    kind: str  # "batch" or "open_loop"
    pool_rows: int  # query rows the run needs
    k: int
    rerank: int
    rows_per_call: int = 0  # batch
    due: Optional[np.ndarray] = None  # open loop: (N,) seconds
    sizes: Optional[np.ndarray] = None  # (N,) rows a request
    first: Optional[np.ndarray] = None  # (N,) first pool row a request


def plan(mix: dict, cell: dict, seconds: float, seed: int) -> Plan:
    """The run's calls or requests, a pure function of its inputs."""
    k, rerank = int(mix["k"]), int(mix.get("rerank", 0))
    if mix["kind"] == "batch":
        per, pool = int(mix["rows_per_call"]), int(mix["pool_rows"])
        if pool % per:
            raise ValueError("pool_rows must be a multiple of rows_per_call")
        return Plan("batch", pool, k, rerank, rows_per_call=per)
    if mix["kind"] != "open_loop":
        raise ValueError(f"traffic kind {mix['kind']!r}")
    if mix.get("arrivals", "poisson") != "poisson":
        raise ValueError(f"arrivals {mix['arrivals']!r}: poisson only")
    # one realization of the mix at this rate and length, from the mix's
    # own seed; the run's seed rotates it and picks the rows
    master = np.random.default_rng(int(mix["arrivals_seed"]))
    n = max(1, int(round(float(cell["rate_per_s"]) * seconds)))
    sizes = master.permutation(
        np.resize(np.asarray(mix["sizes"], dtype=np.int64), n))
    gaps = master.exponential(1.0, n)
    gaps *= seconds / gaps.sum()
    shift = int(np.random.default_rng(seed).integers(n))
    sizes, gaps = np.roll(sizes, -shift), np.roll(gaps, -shift)
    due = np.cumsum(gaps) - gaps[0]
    first = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    return Plan("open_loop", int(sizes.sum()), k, rerank, due=due,
                sizes=sizes, first=first)


@dataclasses.dataclass
class BatchOutcome:
    calls: list  # (block, scores (m, k) numpy, ids (m, k) numpy) a call
    window_s: float  # from the first call to the end of the last
    rows: int  # query rows answered in the window


def run_batch(search: Callable, pool, plan: Plan, seconds: float,
              on_call: Callable[[int, float], None] = lambda i, t: None,
              clock=time.perf_counter) -> BatchOutcome:
    """Back-to-back ``search(rows) -> (scores, ids)`` over pool blocks,
    each answer copied to the host before the next call, until
    ``seconds`` have passed; the call in flight then finishes and counts
    (the window ends with it).  ``on_call(i, elapsed)`` runs before call
    ``i`` (the tracer's hook)."""
    per = plan.rows_per_call
    blocks = plan.pool_rows // per
    calls = []
    t0 = clock()
    i = 0
    while True:
        elapsed = clock() - t0
        if elapsed >= seconds:
            break
        on_call(i, elapsed)
        b = i % blocks
        s, ids = search(pool[b * per:(b + 1) * per])
        calls.append((b, s.cpu().numpy(), ids.cpu().numpy()))
        i += 1
    return BatchOutcome(calls, clock() - t0, len(calls) * per)


@dataclasses.dataclass
class OpenLoopOutcome:
    due: np.ndarray  # (N,) s after the window opened
    sent: np.ndarray  # (N,) s, when the sender submitted it
    done: np.ndarray  # (N,) s, answer on the host; nan = never
    kept: dict  # request -> its answer, for the requests asked to keep
    errors: list  # (request, repr) of submissions that raised
    pending: list = dataclasses.field(default_factory=lambda: [0])
    cv: threading.Condition = dataclasses.field(
        default_factory=threading.Condition)

    def latency_s(self) -> np.ndarray:
        """Due time to answer, +inf for a request never answered."""
        lat = self.done - self.due
        return np.where(np.isnan(lat), np.inf, lat)

    def lag_s(self) -> np.ndarray:
        return self.sent - self.due


def run_open_loop(submit: Callable, pool_host: np.ndarray, plan: Plan,
                  keep=(), clock=time.perf_counter, sleep=time.sleep,
                  start: Optional[float] = None) -> OpenLoopOutcome:
    """Send each request when it is due (at once if the sender is late)
    through ``submit(rows) -> ticket``; the ticket's done callback
    stamps its answer (a ticket that failed stays unanswered) and keeps
    the answers of the requests in ``keep``.  No other ticket is held
    once answered, as a server would not hold it.  Returns when the last
    request is sent; wait for the answers with :func:`wait_answers`."""
    n = plan.due.shape[0]
    out = OpenLoopOutcome(plan.due.copy(), np.full(n, np.nan),
                          np.full(n, np.nan), {}, [])
    keep = frozenset(int(i) for i in keep)
    t0 = clock() if start is None else start
    for i in range(n):
        now = clock() - t0
        if plan.due[i] > now:
            sleep(plan.due[i] - now)
            now = clock() - t0
        out.sent[i] = now
        rows = pool_host[plan.first[i]:plan.first[i] + plan.sizes[i]]
        try:
            t = submit(rows)
        except Exception as e:  # a refused request counts as failed
            out.errors.append((i, repr(e)))
            continue
        with out.cv:
            out.pending[0] += 1

        def stamp(t, i=i):
            at = clock() - t0
            if t.error is None:
                out.done[i] = at
                if i in keep:
                    out.kept[i] = t.result(timeout=0)
            with out.cv:
                out.pending[0] -= 1
                out.cv.notify_all()
        t.add_done_callback(stamp)
    return out


def wait_answers(out: OpenLoopOutcome, timeout_s: float) -> None:
    """Wait up to ``timeout_s`` for every submitted request's answer."""
    with out.cv:
        out.cv.wait_for(lambda: out.pending[0] == 0, timeout=timeout_s)
