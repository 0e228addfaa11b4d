"""The port's concurrent serving: event-backed tickets, the
ServingFrontend driver thread, backpressure, deadlines, shutdown, the
asyncio facade, supervision and background compaction.

The load-bearing properties, as in ``tests/test_concurrent.py``:

* **exactly-once resolution** — threads racing one ticket's
  ``result()`` trigger exactly one fused call, and no ticket is lost or
  resolved twice;
* **linearizable mutation order** — under concurrent mixed
  search/add/delete traffic every search observes exactly the
  mutations submitted before it, so the run equals, bit for bit, a
  serial replay of the submission log on a twin index (flat and IVF:
  the port scores each query's candidates on its own, so coalescing
  requests changes no score);
* **compaction invisibility** — background compaction may swap
  survivor state at any point between flushes; results stay equal to
  a fresh build over the survivors.

Inputs come from fixed numpy seeds; no hypothesis draw decides a pass.
"""
import asyncio
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.types import ASHConfig  # noqa: E402
from repro_torch.index import AshIndex  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    BackgroundCompactor, FrontendClosed, FrontendConfig, QueryEngine,
    ServingFrontend,
)
from repro_torch.testing import faults  # noqa: E402

N0 = 400  # initial index rows
D = 32
CHUNK = 16


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    A = rng.standard_normal((D, D)) * np.arange(1, D + 1) ** -0.6
    X = (rng.standard_normal((900, D)) @ A.T + 0.4).astype(np.float32)
    Qm = (rng.standard_normal((16, D)) @ A.T + 0.4).astype(np.float32)
    model = AshIndex.build(
        torch.Generator().manual_seed(3), torch.from_numpy(X[:N0]),
        ASHConfig(b=2, d=D // 2, n_landmarks=8), device="cpu",
        learned=False,
    ).model
    return X, Qm, model


def _build(setup, backend="flat", n=N0, metric="dot", rows=None):
    X, _, model = setup
    rows = X[:n] if rows is None else rows
    return AshIndex.build(torch.Generator(), torch.from_numpy(rows),
                          model.config, model=model, backend=backend,
                          metric=metric, device="cpu")


def _mk(setup, backend="flat", n=N0, **eng_kw):
    idx = _build(setup, backend, n)
    eng_kw.setdefault("batch_buckets", (8,))
    eng_kw.setdefault("k_buckets", (10,))
    return idx, QueryEngine(idx, **eng_kw)


def _join(threads, timeout=60.0):
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads)


def _wait_until(cond, timeout=10.0):
    end = time.perf_counter() + timeout
    while time.perf_counter() < end:
        if cond():
            return True
        time.sleep(0.002)
    return cond()


def _equal(got, want):
    return torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# Ticket re-entrancy / exactly-once resolution
# ---------------------------------------------------------------------------


def test_ticket_result_hammered_runs_one_fused_call(setup):
    """8 threads racing one ticket's result(): exactly one fused call
    serves the group, every caller gets the same tensors, and the done
    callback fires once."""
    _, Qm, _ = setup
    idx, eng = _mk(setup, max_wait_s=60.0)
    calls = []
    search_prepped = idx.search_prepped

    def counted(*a, **kw):
        calls.append(1)
        time.sleep(0.01)  # widen the race window
        return search_prepped(*a, **kw)

    idx.search_prepped = counted
    ticket = eng.submit(Qm[:2], k=5)
    resolved, results, errors = [], [], []
    ticket.add_done_callback(resolved.append)
    barrier = threading.Barrier(8)

    def hammer():
        try:
            barrier.wait()
            results.append(ticket.result(timeout=30.0))
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for t in threads:
        t.start()
    _join(threads)
    assert not errors and len(results) == 8
    assert len(calls) == 1 and eng.stats.batches == 1
    assert len(resolved) == 1
    s0, i0 = results[0]
    assert all(s is s0 and i is i0 for s, i in results[1:])


def test_mutation_ticket_result_hammered_applies_once(setup):
    idx, eng = _mk(setup, n=100, max_wait_s=60.0)
    ticket = eng.submit_delete(np.arange(10))
    barrier = threading.Barrier(8)
    results = []

    def hammer():
        barrier.wait()
        results.append(ticket.result(timeout=30.0))

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for t in threads:
        t.start()
    _join(threads)
    assert results == [10] * 8
    assert eng.stats.mutation_batches == 1 and idx.n_dead == 10


def test_ticket_result_timeout(setup):
    """On a driven engine result() waits instead of flushing."""
    _, Qm, _ = setup
    idx, eng = _mk(setup, max_wait_s=60.0)
    eng.driven = True  # driven, but nobody is driving
    t = eng.submit(Qm[:1], k=5)
    with pytest.raises(TimeoutError, match="driver"):
        t.result(timeout=0.05)
    eng.driven = False
    s, _ = t.result(timeout=5.0)  # undriven again: the caller flushes
    assert s.shape == (1, 5)


# ---------------------------------------------------------------------------
# ServingFrontend: driver cadence, backpressure, deadlines, lifecycle
# ---------------------------------------------------------------------------


def test_frontend_driver_owns_flushes(setup):
    _, Qm, _ = setup
    idx, eng = _mk(setup, max_wait_s=0.002)
    with ServingFrontend(eng) as fe:
        tickets = [fe.submit(Qm[i:i + 1], k=5) for i in range(4)]
        out = [t.result(timeout=10.0) for t in tickets]
    assert all(s.shape == (1, 5) for s, _ in out)
    assert {t.stats.flush_reason for t in tickets} <= {
        "timeout", "size", "drain"}
    assert not eng.driven  # stop() returned the engine to undriven
    for i, t in enumerate(tickets):
        assert _equal(t.result(), idx.search(torch.from_numpy(Qm[i:i + 1]),
                                             k=5))


def test_frontend_matches_direct_search(setup):
    _, Qm, _ = setup
    idx, eng = _mk(setup, max_wait_s=0.001)
    with ServingFrontend(eng) as fe:
        got = fe.search(torch.from_numpy(Qm), k=5, timeout=10.0)
    assert _equal(got, idx.search(torch.from_numpy(Qm), k=5))


def test_frontend_deadline_flush_and_stats(setup):
    """A deadline shorter than max_wait_s forces the flush at the
    deadline; the snapshot carries the queue gauges."""
    _, Qm, _ = setup
    idx, eng = _mk(setup, max_wait_s=60.0)  # the timeout alone would hang
    with ServingFrontend(eng, default_deadline_s=0.01) as fe:
        t = fe.submit(Qm[:1], k=5)
        t.result(timeout=10.0)
    assert t.stats.flush_reason in ("deadline", "drain")
    snap = eng.stats.snapshot()
    assert snap["flushes"]["deadline"] >= (
        1 if t.stats.flush_reason == "deadline" else 0)
    assert {"queue_depth", "oldest_ticket_age_s", "queue_hwm"} <= set(snap)


def test_frontend_backpressure_bounds_queue(setup):
    _, Qm, _ = setup
    idx, eng = _mk(setup, max_wait_s=0.001)
    bound = 6
    errors = []
    with ServingFrontend(eng, max_queue_rows=bound) as fe:
        def client(cid):
            try:
                for j in range(6):
                    fe.search(Qm[(cid + j) % 6][None, :], k=5, timeout=10.0)
            except Exception as e:
                errors.append(e)

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(8)]
        for t in threads:
            t.start()
        _join(threads)
    assert not errors
    assert eng.stats.queue_hwm <= bound and eng.stats.requests == 48


def test_frontend_submit_timeout_when_clogged(setup):
    _, Qm, _ = setup
    idx, eng = _mk(setup, max_wait_s=60.0)
    fe = ServingFrontend(eng, max_queue_rows=2, submit_timeout_s=0.05).start()
    try:
        fe.submit(Qm[:2], k=5)  # fills the bound
        with pytest.raises(TimeoutError, match="queue full"):
            fe.submit(Qm[:2], k=5)
    finally:
        fe.stop()  # the drain serves the queued request


def test_frontend_stop_drains_and_closes(setup):
    X, Qm, _ = setup
    idx, eng = _mk(setup, max_wait_s=60.0)
    fe = ServingFrontend(eng).start()
    ta = fe.submit_add(X[N0:N0 + 4])
    t = fe.submit(Qm[:1], k=5)
    fe.stop(drain=True)
    assert t.done and t.stats.flush_reason == "drain"
    assert list(ta.result(timeout=1.0)) == list(range(N0, N0 + 4))
    with pytest.raises(FrontendClosed):
        fe.submit(Qm[:1], k=5)
    with pytest.raises(FrontendClosed):
        fe.submit_add(X[:1])
    fe.stop()  # idempotent


def test_frontend_abort_fails_tickets_but_applies_mutations(setup):
    _, Qm, _ = setup
    idx, eng = _mk(setup, max_wait_s=60.0)
    fe = ServingFrontend(eng).start()
    td = fe.submit_delete([0, 1, 2])
    t = fe.submit(Qm[:1], k=5)
    fe.stop(drain=False)
    with pytest.raises(RuntimeError):
        t.result(timeout=1.0)
    assert isinstance(t.error, FrontendClosed)
    assert td.result(timeout=1.0) == 3 and idx.n_dead == 3


def test_frontend_config_validation():
    with pytest.raises(ValueError, match="poll_interval_s"):
        FrontendConfig(poll_interval_s=0.0)
    with pytest.raises(ValueError, match="max_queue_rows"):
        FrontendConfig(max_queue_rows=0)
    with pytest.raises(ValueError, match="max_driver_failures"):
        FrontendConfig(max_driver_failures=0)


def test_frontend_asyncio_facade(setup):
    X, Qm, _ = setup
    idx, eng = _mk(setup, max_wait_s=0.001)
    want = idx.search(torch.from_numpy(Qm[:2]), k=5)  # before the add
    with ServingFrontend(eng) as fe:
        async def run():
            got = await fe.asearch(Qm[:2], k=5)
            ids = await fe.asubmit_add(X[N0:N0 + 4])
            removed = await fe.asubmit_delete(ids[:2])
            return got, list(ids), removed

        got, ids, removed = asyncio.run(run())
    assert _equal(got, want)
    assert ids == list(range(N0, N0 + 4)) and removed == 2


# ---------------------------------------------------------------------------
# Supervision under injected errors
# ---------------------------------------------------------------------------


def test_driver_failure_streak_fails_queued_tickets(setup):
    """A persistently failing driver tick fails queued query tickets
    with the cause after max_driver_failures, healthy() turns False,
    mutations stay queued, and all recovers once the fault clears."""
    X, Qm, _ = setup
    idx, eng = _mk(setup, max_wait_s=0.005)
    fe = ServingFrontend(eng, poll_interval_s=0.002,
                         max_driver_failures=3).start()
    try:
        with faults.active({"engine.apply": faults.Error(at=1,
                                                         repeat=True)}):
            tm = fe.submit_add(X[N0:N0 + CHUNK])
            assert _wait_until(
                lambda: eng.stats.driver_consecutive_failures >= 3)
            assert not fe.healthy()
            assert "InjectedError" in fe.last_error
            tq = fe.submit(Qm[:1], k=5)
            assert _wait_until(lambda: tq.done, timeout=5.0)
            assert isinstance(tq.error, faults.InjectedError)
            with pytest.raises(RuntimeError):
                tq.result(timeout=1.0)
            assert not tm.done  # mutations stay queued, never lost
        np.testing.assert_array_equal(tm.result(timeout=10.0),
                                      np.arange(N0, N0 + CHUNK))
        assert _wait_until(lambda: eng.stats.driver_consecutive_failures
                           == 0)
        assert fe.healthy()
        assert eng.stats.snapshot()["supervision"]["driver_failures"] >= 3
    finally:
        fe.stop()


def test_compactor_records_failures_and_health(setup):
    idx, eng = _mk(setup)
    comp = BackgroundCompactor(eng, max_dead_fraction=0.0,
                               max_failures=2).start()
    idx.delete(list(range(8)))
    try:
        with faults.active({"compactor.swap": faults.Error(at=1,
                                                           repeat=True)}):
            for _ in range(2):
                comp.request("default")
                assert comp.wait_idle(10.0)
            assert _wait_until(
                lambda: eng.stats.compact_consecutive_failures >= 2)
            assert not comp.healthy()
            assert "InjectedError" in comp.last_error
            assert idx.n_dead == 8  # the failed swap changed nothing
        comp.request("default")
        assert comp.wait_idle(10.0)
        assert _wait_until(
            lambda: eng.stats.compact_consecutive_failures == 0)
        assert comp.healthy() and idx.n_dead == 0
    finally:
        comp.stop()


def test_fault_points_registered():
    names = {p.name for p in faults.points()}
    assert {"engine.apply", "engine.apply.logged", "engine.apply.applied",
            "compactor.swap", "wal.append", "save.replace"} <= names
    with pytest.raises(ValueError, match="unknown fault points"):
        faults.install({"wal.nowhere": faults.Error()})


# ---------------------------------------------------------------------------
# Background compaction
# ---------------------------------------------------------------------------


def test_compactor_swap_is_epoch_guarded(setup):
    """A mutation landing between snapshot and swap forces a retry that
    includes it, and the counters record it."""
    idx, eng = _mk(setup, n=200, max_wait_s=60.0)
    comp = BackgroundCompactor(eng, max_dead_fraction=0.0)
    try:
        eng.submit_delete(np.arange(40)).result()
        real_backend = idx._backend
        raced = []

        def racing_compact(state):
            out = real_backend.compact(state)
            if not raced:
                raced.append(True)
                idx.delete([50])  # lands after the snapshot
            return out

        class RacedBackend(real_backend):
            compact = staticmethod(racing_compact)

        idx._backend = RacedBackend
        assert comp.run_once("default")
        assert eng.stats.compact_retries == 1
        assert eng.stats.compact_runs == 1
        assert idx.n == 159 and idx.n_dead == 0  # the delta included
    finally:
        comp.stop()


def test_compactor_skips_below_threshold_and_empty(setup):
    idx, eng = _mk(setup, n=100, max_wait_s=60.0)
    comp = BackgroundCompactor(eng, max_dead_fraction=0.5)
    try:
        eng.submit_delete(np.arange(10)).result()
        assert not comp.run_once("default")  # 10 % < 50 %
        assert idx.n == 100 and idx.n_dead == 10
        assert not comp.run_once("missing")  # unknown name: no-op
        idx.delete(np.arange(100))  # all dead: never compact to empty
        assert not comp.run_once("default")
        assert idx.n == 100
    finally:
        comp.stop()


def test_engine_auto_compact_routes_to_attached_compactor(setup):
    idx, eng = _mk(setup, n=200, max_wait_s=60.0, auto_compact=0.1)
    with BackgroundCompactor(eng) as comp:
        eng.submit_delete(np.arange(80)).result()
        comp.wait_idle(30.0)
    snap = eng.stats.snapshot()
    assert snap["compactions"] == 0  # no synchronous eviction
    assert snap["compaction"]["runs"] == 1
    assert idx.n == 120 and idx.n_dead == 0


@pytest.mark.parametrize("backend", ("flat", "ivf"))
@pytest.mark.parametrize("metric,seed", (("dot", 0), ("l2", 1)))
def test_background_compaction_invisible(setup, backend, metric, seed):
    """Adds, deletes and searches with the compactor swapping whenever
    the dead fraction crosses the threshold: the result equals a fresh
    build over the survivors, and no deleted id ever surfaces."""
    X, Qm, _ = setup
    rng = np.random.RandomState(seed)
    idx = _build(setup, backend, metric=metric)
    src = list(range(N0))  # pool row of every id
    alive = set(range(N0))
    eng = QueryEngine(idx, batch_buckets=(8,), k_buckets=(10,),
                      max_wait_s=0.002, auto_compact=0.02)
    kw = {"nprobe": 4} if backend == "ivf" else {}
    with BackgroundCompactor(eng) as comp:
        for step in range(8):
            op = step % 3
            if op == 0:
                rows = rng.randint(0, X.shape[0], CHUNK)
                got = eng.submit_add(X[rows]).result()
                np.testing.assert_array_equal(
                    got, np.arange(len(src), len(src) + CHUNK))
                alive |= set(got.tolist())
                src += rows.tolist()
            elif op == 1:
                victims = rng.choice(sorted(alive), CHUNK, replace=False)
                assert eng.submit_delete(victims).result() == CHUNK
                alive -= set(victims.tolist())
            else:
                _, ids = eng.submit(Qm, k=10, **kw).result()
                dead = set(range(len(src))) - alive
                assert not set(ids.flatten().tolist()) & dead
        comp.wait_idle(30.0)
    assert eng.stats.compact_runs >= 1
    assert idx.n_live == len(alive)
    # a fresh build over the survivors, in id order, with the same model
    keep = sorted(alive)
    fresh = _build(setup, backend, metric=metric, rows=X[[src[i]
                                                          for i in keep]])
    Qt = torch.from_numpy(Qm)
    s, ids = idx.search(Qt, k=10, **kw)
    fs, fi = fresh.search(Qt, k=10, **kw)
    keep_t = torch.tensor(keep, dtype=torch.int32)
    assert torch.equal(s, fs)
    assert torch.equal(ids, torch.where(fi < 0, -1, keep_t[fi.clamp(min=0)
                                                           .long()]))


# ---------------------------------------------------------------------------
# The stress test: 8 threads, mixed traffic, compactor swaps, serial replay
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ("flat", "ivf"))
def test_stress_mixed_traffic_matches_serial_replay(setup, backend):
    """8 threads of mixed search/add/delete through the frontend, with
    background compaction swapping mid-stream, finish with no lost or
    doubly resolved ticket, and every search equals (bit for bit) the
    same submission sequence replayed serially on a twin index.
    Submissions are ordered by a test-side log lock; execution and
    resolution stay concurrent."""
    X, Qm, _ = setup
    kw = {"nprobe": 4} if backend == "ivf" else {}
    idx = _build(setup, backend)
    twin = _build(setup, backend)
    eng = QueryEngine(idx, batch_buckets=(8,), k_buckets=(10,),
                      max_wait_s=0.002, auto_compact=0.05)
    compactor = BackgroundCompactor(eng).start()
    log = []  # ("add", rows) | ("del", ids) | ("search", q, ticket)
    log_lock = threading.Lock()
    resolutions, errors = [], []
    n_threads = 8
    start = threading.Barrier(n_threads)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # more interleavings
    try:
        with ServingFrontend(eng) as fe:
            def worker(wid):
                rng = np.random.RandomState(1000 + wid)
                try:
                    start.wait()
                    for _ in range(12):
                        op = rng.rand()
                        if op < 0.2:
                            rows = rng.randint(0, X.shape[0], 4)
                            with log_lock:
                                t = fe.submit_add(X[rows])
                                log.append(("add", rows))
                        elif op < 0.4:
                            with log_lock:
                                victims = rng.randint(0, idx.next_id, 8)
                                t = fe.submit_delete(victims)
                                log.append(("del", victims))
                        else:
                            q = Qm[rng.randint(0, Qm.shape[0], 2)]
                            with log_lock:
                                t = fe.submit(q, k=10, **kw)
                                log.append(("search", q, t))
                        t.add_done_callback(resolutions.append)
                        t.result(timeout=60.0)
                except Exception as e:
                    errors.append((wid, e))

            threads = [threading.Thread(target=worker, args=(w,))
                       for w in range(n_threads)]
            for t in threads:
                t.start()
            _join(threads, timeout=120.0)
        assert compactor.wait_idle(30.0)
    finally:
        sys.setswitchinterval(switch)
        compactor.stop()
    assert not errors, errors[:3]
    # nothing lost, nothing resolved twice
    assert all(e[2].done for e in log if e[0] == "search")
    assert len(resolutions) == len(log)
    assert len(set(map(id, resolutions))) == len(log)
    assert eng.stats.compact_runs >= 1  # swaps happened mid-stream
    for entry in log:
        if entry[0] == "add":
            twin.add(torch.from_numpy(X[entry[1]]))
        elif entry[0] == "del":
            twin.delete(entry[1])
        else:
            _, q, t = entry
            assert _equal(t.result(), twin.search(torch.from_numpy(q),
                                                  k=10, **kw))
