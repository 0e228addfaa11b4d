"""The counts a roofline reads, on shapes checked by hand, and the
arithmetic on a trace's intervals."""
import importlib.util
import json
import pathlib

import numpy as np
import pytest

from ashbench import trace
from ashbench import yardstick as Y

ROOT = pathlib.Path(__file__).resolve().parents[2]


def test_bound_is_the_larger_of_operations_and_bytes():
    assert Y.Work(flops=67e12).bound_s() == pytest.approx(1.0)
    assert Y.Work(bytes=3.35e12).bound_s() == pytest.approx(1.0)
    assert Y.Work(flops=67e12, bytes=6.7e12).bound_s() == pytest.approx(2.0)
    assert Y.Work(flops=67e12, int8_ops=1979e12).bound_s() == \
        pytest.approx(2.0)


def test_dense_scan_of_the_t2i_call():
    """1,024 queries over 10^7 rows at b = 2, d = 128: 8 words a row;
    2 * 128 + 3 operations a pair; 40 bytes a stored row."""
    s = Y.shapes(json.loads((ROOT / "ashbench/configs/t2i-10m-flat.json")
                            .read_text()))
    assert (s["words"], s["d_pad"], s["C"], s["D"]) == (8, 128, 64, 200)
    w = Y.dense_scan(1024, 10**7, 128, 8, 64, 100, "dot")
    assert w.flops == 1024 * 10**7 * 259
    assert w.bytes == 10**7 * 40 + 4 * 1024 * 192 + 8 * 1024 * 100
    assert w.bound_s() == pytest.approx(2.65216e12 / 67e12)
    # the fp32 bound of the scan's products alone: 39.1 ms of 39.6
    assert 2 * 1024 * 10**7 * 128 / 67e12 == pytest.approx(0.0391, abs=1e-4)


def test_gather_scan_counts_live_pairs_and_distinct_rows():
    w = Y.gather_scan(2, 300.0, 250.0, 64, 8, 4096, 100, "l2")
    assert w.flops == 300 * (2 * 64 + 5)
    assert w.bytes == 250 * 40 + 4 * 2 * (64 + 4096) + 8 * 2 * 100


def test_coarse_scan_counts_int8_products_apart():
    w = Y.coarse_scan(8, 10**6, 128, 8, 64, 32)
    assert w.int8_ops == 2 * 8 * 10**6 * 128 and w.flops == 5 * 8 * 10**6
    assert w.bytes == 10**6 * 40 + 8 * (128 + 8 + 4 * 64) + 8 * 8 * 32
    assert w.bound_s() == pytest.approx(max(
        (2 * 8e6 * 128) / 1979e12 + 4e7 / 67e12, w.bytes / 3.35e12))


def test_prep_and_rerank():
    assert Y.prep(2, 96, 64, 4096).flops == 2 * 2 * 96 * (64 + 4096 + 1)
    r = Y.rerank(3, 100, 96, 10, "l2")
    assert r.flops == 2 * 2 * 3 * 100 * 96
    assert r.bytes == 2 * 3 * 100 * 96 + 8 * 3 * 110


def _work(name):
    p = ROOT / "ashbench" / "work" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("w_" + name.replace(
        "-", "_"), p)
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    return m


class _Rec:
    def __init__(self, cfg, **kw):
        self.config = cfg
        self.__dict__.update(kw)


class _Plan:
    k, rerank, rows_per_call = 10, 100, 2


def test_ivf_work_of_two_calls():
    cfg = json.loads((ROOT / "ashbench/configs/deep-10m-ivf.json")
                     .read_text())
    sizes = np.zeros(4096, np.int64)
    sizes[:4] = [10, 20, 30, 40]
    probes = np.array([[0, 1], [1, 2], [3, 0], [3, 0]])  # two blocks of 2
    rec = _Rec(cfg, list_sizes=sizes, probes=probes)
    w = _work("deep-10m-ivf").traced(rec, _Plan, [0, 1])
    pairs = (10 + 20) + (20 + 30) + (40 + 10) * 2
    distinct = (10 + 20 + 30) + (40 + 10)
    want = (Y.gather_scan(2, 80.0, 60.0, 64, 8, 4096, 100, "l2")
            + Y.gather_scan(2, 100.0, 50.0, 64, 8, 4096, 100, "l2")
            + Y.prep(4, 96, 64, 4096) + Y.rerank(4, 100, 96, 10, "l2"))
    assert w == want and pairs == 180 and distinct == 110


def test_flat_online_work_reads_the_payload_once_a_call():
    cfg = json.loads((ROOT / "ashbench/configs/t2i-10m-flat.json")
                     .read_text())
    rec = _Rec(cfg, traced_counters={"batches": 3, "rows": 100})
    w = _work("t2i-10m-flat").traced(rec, _Plan, None)
    scan = Y.dense_scan(100, 10**7, 128, 8, 64, 100, "dot")
    scan.bytes += 2 * 10**7 * 40
    assert w == scan + Y.prep(100, 200, 128, 64) + Y.rerank(
        100, 100, 200, 10, "dot")


def test_idle_share_takes_the_union_of_overlapping_intervals():
    dev = [(0, 40, "a"), (20, 60, "b"), (80, 90, "a"), (95, 130, "c")]
    cpu = [(0, 200, "outer"), (60, 80, "aten::copy_"), (61, 79, "inner")]
    s = trace.summarize(dev, cpu, (10, 110))
    assert s.window_s == pytest.approx(100e-9)
    assert s.busy_s == pytest.approx((60 - 10 + 10 + 15) * 1e-9)
    assert s.idle_share == pytest.approx(0.25)
    assert dict((k, v) for k, v in s.device_ops) == {
        "a": pytest.approx(40e-9), "b": pytest.approx(40e-9),
        "c": pytest.approx(15e-9)}
    # gaps 60-80 (inner), 90-95 (outer, the shortest event covering it)
    assert dict((k, v) for k, v in s.idle_gaps) == {
        "inner": pytest.approx(20e-9), "outer": pytest.approx(5e-9)}


def test_gaps_with_no_host_event_are_host_code():
    for cpu in ([], [(0, 10, trace.WINDOW), (0, 10, "ProfilerStep#1")]):
        s = trace.summarize([(0, 5, "k")], cpu, (0, 10))
        assert s.idle_gaps == [["host code", pytest.approx(5e-9)]]
    assert trace.merge([(3, 4), (0, 2), (1, 3)]) == [[0, 4]]


def test_tracer_arms_half_a_second_before_its_stretch():
    assert trace.Tracer(False, 6.0, 3.0).times() == []
    assert trace.Tracer(True, 6.0, 3.0).times() == [5.5, 6.0, 9.0]
    assert trace.Tracer(True, 0.2, 1.0).times() == [0.0, 0.2, 1.2]


def test_gc_pauses_are_counted_by_generation():
    import gc

    from ashbench import harness

    with harness.GcPauses() as p:
        gc.collect()
    s = p.summary()
    assert s[2][0] >= 1 and s[2][1] > 0
    assert gc.callbacks.count(p._on_gc) == 0
