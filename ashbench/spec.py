"""Finding the benchmark's parts by name.

Everything that belongs to one cell, configuration, traffic mix, metric
or work count sits in a file of its own under the benchmark's folder,
named after it:

    workloads/<cell>.json   config, traffic, chips, why (and the cell's
                            own parameters, such as an offered rate)
    configs/<config>.json   the deployment: data, index, search, limits
    traffic/<mix>.json      the parameters the one generator reads
    metrics/<metric>.py     ``read(record) -> float | None``
    work/<config>.py        the operations and bytes a search needs

``BENCHMARK.json`` at the root of the repository says which metrics a
cell reports.  A new cell, configuration, mix or metric is a new file
and a new entry: nothing here or in the harness changes.
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
import re

HERE = pathlib.Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _path(root: pathlib.Path, kind: str, name: str, suffix: str):
    if not _NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    p = root / kind / f"{name}{suffix}"
    if not p.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {p}")
    return p


def load_json(root: pathlib.Path, kind: str, name: str) -> dict:
    """``<root>/<kind>/<name>.json`` with its ``name``."""
    return {**json.loads(_path(root, kind, name, ".json").read_text()),
            "name": name}


def load_module(root: pathlib.Path, kind: str, name: str):
    """The module ``<root>/<kind>/<name>.py`` (names may hold dots)."""
    p = _path(root, kind, name, ".py")
    spec = importlib.util.spec_from_file_location(
        f"ashbench_{kind}_{name.replace('.', '_').replace('-', '_')}", p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metric entries a run of ``cell`` reports: its end-to-end
    metrics, or with ``trace`` its per-layer ones.  A metric without a
    ``workloads`` key belongs to every cell (a per-layer one to every
    cell that reports the end-to-end metric it moves)."""
    def has(entry):
        return "workloads" not in entry or cell in entry["workloads"]

    e2e = [m for m in bench["end_to_end"] if has(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in names)]


class Cell:
    """One cell and the files it names."""

    def __init__(self, name: str, root: pathlib.Path = HERE,
                 bench_path: pathlib.Path = BENCHMARK):
        self.root = pathlib.Path(root)
        self.bench = json.loads(pathlib.Path(bench_path).read_text())
        self.cell = load_json(self.root, "workloads", name)
        entry = {w["name"]: w for w in self.bench["workloads"]}.get(name)
        if entry is None:
            raise KeyError(f"cell {name!r} is not in {bench_path}")
        for key in ("config", "traffic", "chips"):
            if entry[key] != self.cell[key]:
                raise ValueError(f"cell {name!r}: {key} is {entry[key]!r} "
                                 f"in the benchmark, {self.cell[key]!r} in "
                                 f"its file")
        self.name = name
        self.config = load_json(self.root, "configs", self.cell["config"])
        self.traffic = load_json(self.root, "traffic", self.cell["traffic"])
        self.work = load_module(self.root, "work", self.cell["config"])

    def metrics(self, trace: bool) -> list[dict]:
        return metrics_for(self.bench, self.name, trace)

    def reader(self, metric: str):
        return load_module(self.root, "metrics", metric)
