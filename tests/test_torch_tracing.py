"""The port's spans (``repro_torch.tracing``): off, a shared no-op; on,
profiler ranges nested as the code nests, and host totals with self
time per thread.  Searches, engine flushes and the frontend's driver
emit exactly the spans their layers name, with results bit-equal to
the same calls with tracing off; ``EngineStats.queue_wait_s`` sums the
served tickets' queue waits.

CPU only: the profiler records the host's ranges here, and no device
time is read.
"""
import json
import math
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.core.types import ASHConfig  # noqa: E402
from repro_torch.index import AshIndex  # noqa: E402
from repro_torch.serving import QueryEngine, ServingFrontend  # noqa: E402
from repro_torch.train import optim as TO  # noqa: E402
from repro_torch.train import trainer as TTR  # noqa: E402
from repro_torch.train.compression import CompressionConfig  # noqa: E402

D = 32
CFG = ASHConfig(b=2, d=D // 2, n_landmarks=8)
NPROBE = 3


@pytest.fixture(autouse=True)
def _tracing_off():
    """Every test starts and ends with tracing off and no totals."""
    tracing.enable(False)
    tracing.reset()
    yield
    tracing.enable(False)
    tracing.reset()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    A = rng.standard_normal((D, D)) * np.arange(1, D + 1) ** -0.6
    X = (rng.standard_normal((600, D)) @ A.T + 0.3).astype(np.float32)
    Q = (rng.standard_normal((24, D)) @ A.T + 0.3).astype(np.float32)
    return X, Q


@pytest.fixture(scope="module")
def indexes(data):
    X, _ = data
    out = {}
    for backend in ("flat", "ivf"):
        out[backend] = AshIndex.build(
            torch.Generator().manual_seed(3), torch.from_numpy(X), CFG,
            backend=backend, device="cpu", keep_raw=True)
    return out


def _all_threads():
    """A profiler that records every thread's ranges, not only the
    thread that starts it (the frontend's driver runs on its own)."""
    return profile(
        activities=[ProfilerActivity.CPU],
        experimental_config=torch._C._profiler._ExperimentalConfig(
            profile_all_threads=True))


def _spans(prof):
    """[(name, start_ns, end_ns, thread)] of the port's spans in a
    finished profile, by start."""
    out = [(e.name(), e.start_ns(), e.end_ns(), e.start_thread_id())
           for e in prof.profiler.kineto_results.events()
           if e.name() in tracing.SPANS]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _names(spans):
    counts = {}
    for name, *_ in spans:
        counts[name] = counts.get(name, 0) + 1
    return counts


def _parent(spans, child):
    """The innermost span of the same thread that covers ``child``."""
    _, a, b, th = child
    inside = [s for s in spans if s is not child and s[3] == th
              and s[1] <= a and b <= s[2]]
    return min(inside, key=lambda s: s[2] - s[1], default=None)


def _parents(spans):
    """{child name: set of innermost parent names (None at the top)}."""
    out = {}
    for s in spans:
        p = _parent(spans, s)
        out.setdefault(s[0], set()).add(None if p is None else p[0])
    return out


class _FakeClock:
    """A per-thread clock the test moves by hand, in ns."""

    def __init__(self):
        self.now = {}

    def __call__(self):
        return self.now.get(threading.get_ident(), 0)

    def advance(self, ns):
        me = threading.get_ident()
        self.now[me] = self.now.get(me, 0) + ns


# ---------------------------------------------------------------------------
# The helper
# ---------------------------------------------------------------------------


def test_off_returns_one_shared_noop(indexes, data):
    _, Q = data
    assert not tracing.enabled()
    first = tracing.span("index.prep")
    assert all(tracing.span(n) is first for n in tracing.SPANS)
    assert tracing.span("no.such.span") is first  # no check while off
    with first, first:  # reusable and reentrant
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        indexes["ivf"].search(torch.from_numpy(Q[:4]), k=5, nprobe=NPROBE,
                              rerank=20)
    assert _spans(prof) == []
    assert tracing.totals() == {}


def test_enable_reset_and_unknown_names():
    tracing.enable()
    assert tracing.enabled()
    with pytest.raises(ValueError, match="unknown span"):
        tracing.span("index.nothing")
    with tracing.span("engine.wait"):
        pass
    assert set(tracing.totals()) == {"engine.wait"}
    tracing.reset()
    assert tracing.totals() == {}
    tracing.enable(False)
    assert not tracing.enabled()
    with tracing.span("engine.wait"):
        pass
    assert tracing.totals() == {}


def test_names_are_closed_and_distinct():
    assert len(set(tracing.SPANS)) == len(tracing.SPANS)
    assert all(n.count(".") == 1 for n in tracing.SPANS)
    layers = {n.split(".")[0] for n in tracing.SPANS}
    assert layers == {"index", "ivf", "engine", "build", "train"}


def test_self_time_and_nesting_on_a_fake_clock(monkeypatch):
    clock = _FakeClock()
    monkeypatch.setattr(tracing, "_clock", clock)
    tracing.enable()
    with tracing.span("engine.flush"):
        clock.advance(100)
        with tracing.span("engine.prep"):
            clock.advance(30)
            with tracing.span("index.prep"):
                clock.advance(50)
            clock.advance(5)
        with tracing.span("engine.call"):
            clock.advance(200)
            with tracing.span("index.scan"):
                clock.advance(400)
                with tracing.span("index.rerank"):
                    clock.advance(70)
        clock.advance(1)
    with tracing.span("engine.prep"):
        clock.advance(9)
    t = tracing.totals()
    ns = {n: (v["count"], round(v["s"] * 1e9), round(v["self_s"] * 1e9))
          for n, v in t.items()}
    assert ns == {
        "engine.flush": (1, 856, 101),
        "engine.prep": (2, 85 + 9, 35 + 9),
        "index.prep": (1, 50, 50),
        "engine.call": (1, 670, 200),
        "index.scan": (1, 470, 400),
        "index.rerank": (1, 70, 70),
    }


def test_self_time_is_kept_per_thread(monkeypatch):
    """A span another thread opens while this one's is open is no child
    of it: each thread nests its own spans."""
    clock = _FakeClock()
    monkeypatch.setattr(tracing, "_clock", clock)
    tracing.enable()
    opened, done = threading.Event(), threading.Event()

    def driver():
        opened.wait(10)
        with tracing.span("engine.wait"):
            clock.advance(1000)
        with tracing.span("engine.tick"):
            clock.advance(10)
            with tracing.span("engine.flush"):
                clock.advance(40)
        done.set()

    th = threading.Thread(target=driver)
    th.start()
    with tracing.span("engine.call"):
        clock.advance(7)
        opened.set()
        assert done.wait(10)
        with tracing.span("index.scan"):
            clock.advance(3)
    th.join(10)
    assert not th.is_alive()
    t = tracing.totals()
    assert t["engine.call"]["count"] == 1
    assert round(t["engine.call"]["s"] * 1e9) == 10
    assert round(t["engine.call"]["self_s"] * 1e9) == 7
    assert round(t["engine.wait"]["self_s"] * 1e9) == 1000
    assert round(t["engine.tick"]["s"] * 1e9) == 50
    assert round(t["engine.tick"]["self_s"] * 1e9) == 10
    assert round(t["engine.flush"]["self_s"] * 1e9) == 40


def test_a_span_left_by_an_exception_is_counted_and_closed(monkeypatch):
    clock = _FakeClock()
    monkeypatch.setattr(tracing, "_clock", clock)
    tracing.enable()
    with pytest.raises(RuntimeError):
        with tracing.span("engine.flush"):
            with tracing.span("engine.call"):
                clock.advance(20)
                raise RuntimeError("fused call failed")
    with tracing.span("engine.resolve"):  # the stack is empty again
        clock.advance(5)
    t = tracing.totals()
    assert (t["engine.flush"]["count"], t["engine.call"]["count"]) == (1, 1)
    assert round(t["engine.flush"]["self_s"] * 1e9) == 0
    assert round(t["engine.resolve"]["s"] * 1e9) == 5
    assert round(t["engine.resolve"]["self_s"] * 1e9) == 5


def test_totals_count_every_span_under_many_threads():
    tracing.enable()
    n_threads, per = 8, 200

    def work():
        for _ in range(per):
            with tracing.span("engine.tick"):
                with tracing.span("engine.flush"):
                    pass

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads inside the spans
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(30)
    finally:
        sys.setswitchinterval(switch)
    assert not any(th.is_alive() for th in threads)
    t = tracing.totals()
    assert t["engine.tick"]["count"] == n_threads * per
    assert t["engine.flush"]["count"] == n_threads * per
    tick = t["engine.tick"]
    assert tick["self_s"] == pytest.approx(
        tick["s"] - t["engine.flush"]["s"], abs=1e-9)


# ---------------------------------------------------------------------------
# Searches: the spans each route emits, and its results unchanged
# ---------------------------------------------------------------------------

_SEARCHES = {
    "flat": (dict(k=5), {"index.prep": 1, "index.scan": 1}),
    "flat-rerank": (dict(k=5, rerank=20),
                    {"index.prep": 1, "index.scan": 1, "index.rerank": 1}),
    "ivf": (dict(k=5, nprobe=NPROBE),
            {"index.prep": 1, "ivf.probe": 1, "ivf.table": 1,
             "index.scan": 1}),
    "ivf-rerank": (dict(k=5, nprobe=NPROBE, rerank=20),
                   {"index.prep": 1, "ivf.probe": 1, "ivf.table": 1,
                    "index.scan": 1, "index.rerank": 1}),
}


@pytest.mark.parametrize("route", sorted(_SEARCHES))
def test_search_emits_its_layers_spans(indexes, data, route):
    _, Q = data
    kw, want = _SEARCHES[route]
    idx = indexes[route.split("-")[0]]
    q = torch.from_numpy(Q[:6])
    off = idx.search(q, **kw)
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = idx.search(q, **kw)
    spans = _spans(prof)
    assert _names(spans) == want
    parents = _parents(spans)
    assert parents["index.prep"] == {None}
    assert parents["index.scan"] == {None}
    if "index.rerank" in want:
        assert parents["index.rerank"] == {"index.scan"}
    for name in ("ivf.probe", "ivf.table"):
        if name in want:
            assert parents[name] == {None}
    order = [s[0] for s in spans if _parent(spans, s) is None]
    assert order[0] == "index.prep" and order[-1] == "index.scan"
    assert {n: v["count"] for n, v in tracing.totals().items()} == want
    for a, b in zip(off, on):
        assert torch.equal(a, b)


@pytest.mark.parametrize("backend", ("flat", "ivf"))
def test_build_emits_kmeans_and_encode(data, backend):
    X, _ = data
    x = torch.from_numpy(X[:300])
    off = AshIndex.build(torch.Generator().manual_seed(5), x, CFG,
                         backend=backend, device="cpu")
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = AshIndex.build(torch.Generator().manual_seed(5), x, CFG,
                            backend=backend, device="cpu")
    spans = _spans(prof)
    assert _names(spans) == {"build.kmeans": 1, "build.encode": 1}
    assert _parents(spans) == {"build.kmeans": {None},
                               "build.encode": {None}}
    kmeans, encode = (next(s for s in spans if s[0] == n)
                      for n in ("build.kmeans", "build.encode"))
    assert kmeans[2] <= encode[1]  # landmarks before the encoding
    t = tracing.totals()
    assert t["build.encode"]["s"] > 0 and t["build.kmeans"]["s"] > 0
    assert torch.equal(off.payload.codes, on.payload.codes)
    assert torch.equal(off.model.landmarks, on.model.landmarks)


# ---------------------------------------------------------------------------
# The engine and the frontend
# ---------------------------------------------------------------------------

_ENGINE_PARENTS = {
    "engine.flush": {None},
    "engine.plan": {"engine.flush"},
    "engine.prep": {"engine.flush"},
    "engine.call": {"engine.flush"},
    "engine.copy": {"engine.flush"},
    "engine.resolve": {"engine.flush"},
    "index.prep": {"engine.prep"},
    "index.scan": {"engine.call"},
    "index.rerank": {"index.scan"},
}


def _serve(engine, Q, sizes, kw):
    tickets, at = [], 0
    for m in sizes:
        tickets.append(engine.submit(Q[at:at + m], **kw))
        at += m
    return tickets


@pytest.mark.parametrize("backend", ("flat", "ivf"))
def test_engine_flush_emits_its_spans(indexes, data, backend):
    _, Q = data
    kw = dict(k=5, rerank=20)
    if backend == "ivf":
        kw["nprobe"] = NPROBE
    sizes = (1, 2, 1, 4)  # 8 rows: one fused call at bucket 8

    def run():
        eng = QueryEngine(indexes[backend], batch_buckets=(8,),
                          k_buckets=(10,))
        tickets = _serve(eng, Q, sizes, kw)
        eng.flush()
        return [t.result() for t in tickets]

    off = run()
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = run()
    spans = _spans(prof)
    want = {"engine.flush": 1, "engine.plan": 1, "engine.prep": 1,
            "engine.call": 1, "engine.copy": 1, "engine.resolve": 1,
            "index.prep": 1, "index.scan": 1, "index.rerank": 1}
    if backend == "ivf":
        want.update({"ivf.probe": 1, "ivf.table": 1})
    assert _names(spans) == want
    parents = _parents(spans)
    for name, want_parents in _ENGINE_PARENTS.items():
        assert parents[name] == want_parents, name
    if backend == "ivf":
        assert parents["ivf.probe"] == {"engine.call"}
        assert parents["ivf.table"] == {"engine.call"}
    flush = next(s for s in spans if s[0] == "engine.flush")
    steps = [s[0] for s in spans if _parent(spans, s) is flush]
    assert steps == ["engine.plan", "engine.prep", "engine.call",
                     "engine.copy", "engine.resolve"]
    for (s0, i0), (s1, i1) in zip(off, on):
        assert torch.equal(s0, s1) and torch.equal(i0, i1)


def test_engine_queue_wait_sums_the_served_tickets(indexes, data):
    _, Q = data
    eng = QueryEngine(indexes["flat"], batch_buckets=(4, 8),
                      k_buckets=(10,))
    tickets = _serve(eng, Q, (1, 2, 1, 4, 3, 1, 2), dict(k=5))
    eng.flush()
    for t in tickets:
        t.result()
    waits = [t.stats.queue_wait_s for t in tickets]
    assert all(w >= 0.0 for w in waits)
    assert eng.stats.queue_wait_s == pytest.approx(math.fsum(waits),
                                                   rel=1e-12, abs=0.0)
    snap = eng.stats.snapshot()
    assert snap["queue_wait_s"] == eng.stats.queue_wait_s
    assert snap["requests"] == len(tickets)
    json.dumps(snap)  # /stats serves it as JSON
    assert not hasattr(tickets[0].stats, "scoring_us")


def test_frontend_emits_wait_and_tick_on_its_driver(indexes, data):
    _, Q = data
    kw = dict(k=5, rerank=20)
    sizes = (1, 2, 1, 4, 2, 2)

    def run():
        eng = QueryEngine(indexes["flat"], batch_buckets=(8,),
                          k_buckets=(10,))
        with ServingFrontend(eng) as fe:
            tickets = [fe.submit(Q[a:a + m], **kw) for a, m in
                       zip(np.cumsum((0,) + sizes[:-1]), sizes)]
            got = [t.result(timeout=60) for t in tickets]
        return got, eng.stats.snapshot()

    off, _ = run()
    tracing.enable()
    with _all_threads() as prof:
        on, snap = run()
    spans = _spans(prof)
    names = _names(spans)
    assert names["engine.wait"] >= 1 and names["engine.tick"] >= 1
    assert names["engine.flush"] >= names["engine.plan"] >= 1
    for name in ("engine.prep", "engine.call", "engine.copy",
                 "engine.resolve", "index.scan", "index.rerank"):
        assert names[name] == snap["batches"], name  # one a fused call
    assert set(names) <= {"engine.wait", "engine.tick", *_ENGINE_PARENTS}
    parents = _parents(spans)
    assert parents["engine.wait"] == {None}
    assert parents["engine.tick"] == {None}
    # the driver flushes inside its ticks; stop() drains on the caller
    assert parents["engine.flush"] <= {"engine.tick", None}
    assert "engine.tick" in parents["engine.flush"]
    for name in ("engine.plan", "engine.call", "engine.resolve"):
        assert parents[name] == {"engine.flush"}
    driver = {s[3] for s in spans if s[0] == "engine.wait"}
    assert len(driver) == 1
    assert {s[3] for s in spans if s[0] == "engine.tick"} == driver
    for (s0, i0), (s1, i1) in zip(off, on):
        assert torch.equal(s0, s1) and torch.equal(i0, i1)


# ---------------------------------------------------------------------------
# The trainer's spans, and every name emitted
# ---------------------------------------------------------------------------


def _tiny_step():
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(6, 3, generator=gen),
              "b": torch.zeros(3)}
    x = torch.randn(8, 6, generator=gen)

    def loss_fn(p, batch):
        return ((batch["x"] @ p["w"] + p["b"]) ** 2).mean()

    tcfg = TTR.TrainConfig(opt=TO.OptConfig(lr=1e-2, warmup_steps=1),
                           compression=CompressionConfig(enabled=True))
    state = TTR.init_state(3, params, tcfg)
    return TTR.make_train_step(loss_fn, tcfg), state, {"x": x}


def test_train_step_emits_its_three_ranges():
    step, state, batch = _tiny_step()
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, metrics = step(state, batch)
    spans = _spans(prof)
    assert [s[0] for s in spans] == ["train.forward_backward",
                                     "train.compression", "train.optimizer"]
    assert math.isfinite(float(metrics["loss"]))


def test_every_span_name_is_emitted(indexes, data):
    """One pass over every instrumented path emits each name of SPANS."""
    X, Q = data
    tracing.enable()
    AshIndex.build(torch.Generator().manual_seed(2),
                   torch.from_numpy(X[:200]), CFG, device="cpu")
    indexes["ivf"].search(torch.from_numpy(Q[:3]), k=5, nprobe=NPROBE,
                          rerank=20)
    eng = QueryEngine(indexes["flat"], batch_buckets=(8,), k_buckets=(10,))
    with ServingFrontend(eng) as fe:
        fe.submit(Q[:2], k=5).result(timeout=60)
    step, state, batch = _tiny_step()
    step(state, batch)
    t = tracing.totals()
    assert set(t) == set(tracing.SPANS)
    for name, v in t.items():
        assert v["count"] >= 1 and 0.0 <= v["self_s"] <= v["s"] + 1e-9, name
