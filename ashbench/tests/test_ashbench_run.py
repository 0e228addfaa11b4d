"""Whole runs of every cell at a tiny size on the CPU: the last line
keeps to the contract's shape and the run is correct."""
import json
import subprocess
import sys

import pytest

from ashbench import harness, spec

CELLS = ["t2i-10m-flat.batch1024", "deep-10m-ivf.batch1024",
         "t2i-10m-flat.online", "deep-10m-ivf.online"]


def _run(tiny, cell, trace, seed=2**31 + 11):
    root, bench = tiny
    lines, logs = [], []
    c = spec.Cell(cell, root=root, bench_path=bench)
    rc = harness.run(c, seed, 0.5, trace, device="cpu", emit=lines.append,
                     log=logs.append)
    return rc, [json.loads(x) for x in lines], logs, c


@pytest.mark.parametrize("cell", CELLS)
def test_last_line_has_the_contract_keys(tiny, cell):
    rc, lines, logs, c = _run(tiny, cell, False)
    assert rc == 0
    last = lines[-1]
    assert list(last)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(last)
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] > 0
    assert set(last["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    want = {m["name"]: m["unit"] for m in c.metrics(False)}
    assert {k: v["unit"] for k, v in last["metrics"].items()} == want
    assert all(v["value"] > 0 for v in last["metrics"].values())
    # each number compared is on stderr beside its limit, last
    assert len(logs) == len(last["checks"])
    for name, s in last["checks"].items():
        assert s["value"] <= s["limit"]
        assert any(line.startswith(f"check {name}:") for line in logs)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_per_layer_metrics_only(tiny, cell):
    rc, lines, _, c = _run(tiny, cell, True)
    assert rc == 0
    names = set(lines[-1]["metrics"])
    assert names and names <= {m["name"] for m in c.metrics(True)}
    assert "setup.build_s" in names


def test_same_seed_same_inputs_and_answers(tiny):
    a = _run(tiny, "deep-10m-ivf.batch1024", False, seed=123)[1][-1]
    b = _run(tiny, "deep-10m-ivf.batch1024", False, seed=123)[1][-1]
    assert a["checks"] == b["checks"]


def test_no_card_no_result():
    """Without a card the command prints nothing on stdout and exits
    non-zero."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "ashbench/run.py", "--workload",
                        "t2i-10m-flat.batch1024", "--seed", "1",
                        "--seconds", "1"], capture_output=True, text=True,
                       cwd=harness.spec.HERE.parent, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_without_the_system_no_result(tmp_path):
    """In a folder holding only BENCHMARK.json and the benchmark's files
    the command prints nothing on stdout and exits non-zero."""
    import shutil

    root = harness.spec.HERE.parent
    shutil.copy(root / "BENCHMARK.json", tmp_path)
    shutil.copytree(root / "ashbench", tmp_path / "ashbench")
    p = subprocess.run([sys.executable, "ashbench/run.py", "--workload",
                        "t2i-10m-flat.batch1024", "--seed", "1",
                        "--seconds", "1"], capture_output=True, text=True,
                       cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "repro_torch" in p.stderr
