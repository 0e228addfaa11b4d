"""Fixtures of the benchmark's own tests, and the ``cuda`` marker of
those that need a card.

Run them from the root of the repository (they are not under the
repository's ``tests/`` and its test run does not collect them):

    PYTHONPATH=src python -m pytest -q ashbench/tests

The card's tests run on a machine with a CUDA device the same way; here
they skip.  ``tiny`` is a copy of the benchmark's files with every
configuration cut to a few thousand rows, so a whole run fits the CPU.
"""
import json
import pathlib
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

TINY = {
    "t2i-10m-flat": dict(n=3000, dim=32, ash={"b": 2, "d": 16,
                                              "n_landmarks": 8}),
    "deep-10m-ivf": dict(n=4000, dim=24, ash={"b": 4, "d": 16,
                                              "n_landmarks": 32},
                         train={"landmark_sample": 1000},
                         search={"nprobe": 8}),
}
TINY_TRAFFIC = {"batch1024": dict(rows_per_call=64, pool_rows=256)}
TINY_RATE = 150.0  # requests a second of the online cells on the CPU
IVF_ONLINE = "deep-10m-ivf.online"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips on CPU-only machines)")


def make_tiny(dst: pathlib.Path) -> tuple[pathlib.Path, pathlib.Path]:
    """(benchmark folder, BENCHMARK.json) of a tiny copy under ``dst``."""
    src = ROOT / "ashbench"
    root = dst / "ashbench"
    shutil.copytree(src, root, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    for name, cut in TINY.items():
        p = root / "configs" / f"{name}.json"
        cfg = json.loads(p.read_text())
        cfg.update(cut)
        p.write_text(json.dumps(cfg))
    for name, cut in TINY_TRAFFIC.items():
        p = root / "traffic" / f"{name}.json"
        p.write_text(json.dumps({**json.loads(p.read_text()), **cut}))
    for p in (root / "workloads").glob("*.json"):
        cell = json.loads(p.read_text())
        if "rate_per_s" in cell:
            p.write_text(json.dumps({**cell, "rate_per_s": TINY_RATE}))
    # the engine over IVF too, a cell the benchmark does not hold (PERF.md)
    extra = {"config": "deep-10m-ivf", "traffic": "online-poisson",
             "chips": 1, "why": "the engine over IVF", "rate_per_s": TINY_RATE}
    (root / "workloads" / f"{IVF_ONLINE}.json").write_text(json.dumps(extra))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": IVF_ONLINE, **{
        k: extra[k] for k in ("config", "traffic", "chips", "why")}})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "t2i-10m-flat.online" in m.get("workloads", ()):
            m["workloads"].append(IVF_ONLINE)
    path = dst / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return root, path


@pytest.fixture
def tiny(tmp_path):
    return make_tiny(tmp_path)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
