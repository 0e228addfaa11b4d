"""The one traffic generator: plans, the open loop on a fake clock and
due-time latency."""
import numpy as np
import pytest

from ashbench import traffic

MIX = {"kind": "open_loop", "arrivals": "poisson", "arrivals_seed": 5,
       "sizes": [1, 1, 2, 4], "k": 10, "rerank": 100}


def test_open_loop_offers_the_same_work_on_every_seed():
    a = traffic.plan(MIX, {"rate_per_s": 400}, 10.0, 1)
    b = traffic.plan(MIX, {"rate_per_s": 400}, 10.0, 2)
    assert a.due.size == b.due.size == 4000
    assert sorted(a.sizes) == sorted(b.sizes)
    assert np.bincount(a.sizes).tolist() == [0, 2000, 1000, 0, 1000]
    assert not np.array_equal(a.due, b.due)
    assert np.all(np.diff(a.due) >= 0) and 0 == a.due[0] and a.due[-1] < 10
    # the same gaps and sizes, rotated to another phase
    ga, gb = np.diff(a.due), np.diff(b.due)
    at = int(np.argmin(np.abs(ga - gb[0])))
    assert np.allclose(np.roll(ga, -at)[:100], gb[:100], rtol=0, atol=1e-9)
    assert np.array_equal(np.roll(a.sizes, -at)[:100], b.sizes[:100])
    # no row read twice, the pool exactly covered
    rows = np.concatenate([f + np.arange(s) for f, s in
                           zip(a.first, a.sizes)])
    assert np.array_equal(np.sort(rows), np.arange(a.pool_rows))
    c = traffic.plan(MIX, {"rate_per_s": 400}, 10.0, 1)
    assert np.array_equal(a.due, c.due) and np.array_equal(a.first, c.first)


def test_poisson_gaps_are_exponential():
    p = traffic.plan(MIX, {"rate_per_s": 1000}, 50.0, 7)
    gaps = np.diff(p.due)
    assert abs(gaps.mean() - 1e-3) < 5e-5
    assert abs(gaps.std() / gaps.mean() - 1) < 0.05  # CV of an exponential


def test_batch_plan():
    p = traffic.plan({"kind": "batch", "rows_per_call": 4, "pool_rows": 12,
                      "k": 10, "rerank": 100}, {}, 5.0, 1)
    assert (p.kind, p.pool_rows, p.rows_per_call) == ("batch", 12, 4)
    with pytest.raises(ValueError):
        traffic.plan({"kind": "batch", "rows_per_call": 5, "pool_rows": 12,
                      "k": 10}, {}, 5.0, 1)


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


class FakeTicket:
    error = None

    def __init__(self):
        self.cbs = []

    def add_done_callback(self, fn):
        self.cbs.append(fn)

    def result(self, timeout=None):
        return "answer"


def test_latency_runs_from_the_due_time_on_a_fake_clock():
    """A stall delays the sender; the requests it delays still count
    their latency from when they were due."""
    clock = FakeClock()
    plan = traffic.Plan("open_loop", 3, 10, 0, due=np.array([0.0, 1.0, 1.5]),
                        sizes=np.array([1, 1, 1]), first=np.array([0, 1, 2]))
    tickets = []

    def submit(rows):
        t = FakeTicket()
        tickets.append(t)
        if len(tickets) == 1:
            clock.t += 2.0  # the first submission stalls 2 s
        return t

    out = traffic.run_open_loop(submit, np.zeros((3, 2)), plan, keep=[1],
                                clock=clock, sleep=clock.sleep)
    assert out.sent.tolist() == [0.0, 2.0, 2.0]
    assert out.lag_s().tolist() == [0.0, 1.0, 0.5]
    assert out.pending == [3]
    clock.t = 100.0 + 2.5
    tickets[2].error = RuntimeError("its batch failed")
    for t in tickets:
        t.cbs[0](t)
    lat = out.latency_s()
    assert lat[:2].tolist() == [2.5, 1.5] and np.isinf(lat[2])
    assert out.kept == {1: "answer"} and out.pending == [0]
    traffic.wait_answers(out, 0.0)
