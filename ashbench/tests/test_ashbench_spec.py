"""Every part of the benchmark is found by name, ``BENCHMARK.json``
keeps to the contract's shape, and a part added as new files is found
with no file edited."""
import json
import pathlib
import re

import pytest

from ashbench import spec

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_by_name(cell):
    c = spec.Cell(cell)
    assert c.config["name"] == c.cell["config"]
    assert c.traffic["name"] == c.cell["traffic"]
    assert callable(c.work.traced)
    for m in c.metrics(False) + c.metrics(True):
        assert callable(c.reader(m["name"]).read)


@pytest.mark.parametrize("kind", ["configs", "traffic", "workloads",
                                  "metrics", "work"])
def test_every_file_is_named_for_an_entry(kind):
    named = {
        "configs": {c["name"] for c in BENCH["configs"]},
        "traffic": {w["traffic"] for w in BENCH["workloads"]},
        "workloads": {w["name"] for w in BENCH["workloads"]},
        "metrics": {m["name"] for m in BENCH["end_to_end"]
                    + BENCH["per_layer"]},
        "work": {c["name"] for c in BENCH["configs"]},
    }[kind]
    found = {p.stem if p.suffix == ".json" else p.name[:-3]
             for p in (ROOT / "ashbench" / kind).iterdir()
             if p.suffix in (".json", ".py")}
    assert found == named


def test_benchmark_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "ashbench/run.py"]
    assert BENCH["paths"] == ["ashbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"ashbench/configs/{c['name']}.json"
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        for w in m["workloads"]:  # each listed cell reports what it moves
            assert w in e2e[m["moves"]].get("workloads", [w])
        layers.setdefault(m["layer"], []).append(m["name"])
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reports = spec.metrics_for(BENCH, w["name"], False)
        assert "setup_s" in {m["name"] for m in reports} and len(reports) >= 2
        assert spec.metrics_for(BENCH, w["name"], True)
        cell = json.loads((ROOT / "ashbench" / "workloads"
                           / f"{w['name']}.json").read_text())
        assert {k: cell[k] for k in ("config", "traffic", "chips", "why")} \
            == {k: w[k] for k in ("config", "traffic", "chips", "why")}


def test_a_new_config_mix_cell_and_metric_are_found_by_name(tiny):
    """New files and new entries only: the harness finds them."""
    root, bench_path = tiny
    bench = json.loads(bench_path.read_text())
    cfg = json.loads((root / "configs" / "t2i-10m-flat.json").read_text())
    (root / "configs" / "t2i-new.json").write_text(
        json.dumps({**cfg, "n": 2500}))
    (root / "work" / "t2i-new.py").write_text(
        (root / "work" / "t2i-10m-flat.py").read_text())
    (root / "traffic" / "batch-small.json").write_text(json.dumps(
        {"kind": "batch", "rows_per_call": 32, "pool_rows": 64, "k": 10,
         "rerank": 100}))
    cell = {"config": "t2i-new", "traffic": "batch-small", "chips": 1,
            "why": "a test cell"}
    (root / "workloads" / "t2i-new.batch-small.json").write_text(
        json.dumps(cell))
    (root / "metrics" / "rows_a_second.py").write_text(
        "def read(rec):\n    return rec.rows / rec.window_s\n")
    bench["configs"].append({"name": "t2i-new", "source": "a test",
                             "file": "ashbench/configs/t2i-new.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "t2i-new.batch-small", **cell})
    bench["end_to_end"].append({
        "name": "rows_a_second", "unit": "rows/s", "better": "higher",
        "bound": 0.05, "source": "host_clock",
        "workloads": ["t2i-new.batch-small"]})
    bench_path.write_text(json.dumps(bench))
    c = spec.Cell("t2i-new.batch-small", root=root, bench_path=bench_path)
    assert c.config["n"] == 2500 and c.traffic["rows_per_call"] == 32
    assert [m["name"] for m in c.metrics(False)] == ["setup_s",
                                                     "rows_a_second"]
    from ashbench import harness

    lines = []
    assert harness.run(c, 5, 0.3, False, device="cpu", emit=lines.append,
                       log=lambda s: None) == 0
    result = json.loads(lines[-1])
    assert result["correct"] and "rows_a_second" in result["metrics"]


def test_a_cell_that_disagrees_with_the_benchmark_is_refused(tiny):
    root, bench_path = tiny
    p = root / "workloads" / "t2i-10m-flat.batch1024.json"
    p.write_text(json.dumps({**json.loads(p.read_text()),
                             "traffic": "online-poisson"}))
    with pytest.raises(ValueError):
        spec.Cell("t2i-10m-flat.batch1024", root=root, bench_path=bench_path)


@pytest.mark.parametrize("bad", ["../x", "a/b", " x", ""])
def test_names_that_leave_the_folder_are_refused(bad):
    with pytest.raises(ValueError):
        spec.load_json(spec.HERE, "configs", bad)
