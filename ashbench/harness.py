"""One run of one cell: data from the seed, the index built through the
system, the cell's shapes warmed, the measured window, then the plain
reference and the last line.

The system under test is the PyTorch and CUDA package ``repro_torch``:
the batch cells drive ``AshIndex.search`` and the online cells
``ServingFrontend.submit`` over a ``QueryEngine`` with its default
configuration.  From it the benchmark takes only the results, its
counters (``EngineStats.snapshot()``, ``IVFBackend.list_sizes`` and
``probe_sets``) and the device trace.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from ashbench import check, data, spec, traffic
from ashbench import reference as R
from ashbench.trace import Tracer
from repro_torch.core.types import ASHConfig
from repro_torch.index import AshIndex
from repro_torch.serving import QueryEngine, ServingFrontend

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # whole top-level names
ANSWER_WAIT_S = 60.0  # a minute past the close for late answers
TRACE_AT = 0.3  # the traced stretch starts at this share of the window
TRACE_S = 3.0  # and lasts this long (at most 40 % of the window)
JUDGED_REQUESTS = 2048  # online requests sampled for the comparison
WARM_ROWS = 256  # query rows of the online warm-up, never in the window


@dataclasses.dataclass
class Record:
    """What a run measured, for the metric readers (``metrics/*.py``)."""

    kind: str  # "batch" or "open_loop"
    config: dict
    seconds: float
    setup_s: float
    spans: dict  # harness spans around calls into the system, seconds
    window_s: float = 0.0  # batch: first call to the end of the last
    rows: int = 0  # batch: query rows answered in the window
    latency_s: Optional[np.ndarray] = None  # open loop, +inf unanswered
    counters: dict = dataclasses.field(default_factory=dict)
    traced_counters: dict = dataclasses.field(default_factory=dict)
    trace: object = None  # trace.TraceSummary of a --trace 1 run
    traced_work: object = None  # yardstick.Work of the traced stretch
    list_sizes: Optional[np.ndarray] = None  # IVF: live rows a list
    probes: Optional[np.ndarray] = None  # IVF: probed lists of ...
    probe_rows: Optional[np.ndarray] = None  # ... these pool rows


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def card_line(dev: torch.device) -> dict:
    """The card's name and its power limit, as nvidia-smi reads them."""
    line = {"card": torch.cuda.get_device_name(dev)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={dev.index or 0}"],
            capture_output=True, text=True, timeout=30)
        line["nvidia_smi"] = out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        line["nvidia_smi"] = f"unavailable: {e!r}"
    return line


def counters(engine) -> dict:
    snap = engine.stats.snapshot()
    return {k: snap[k] for k in ("requests", "batches", "rows")}


def diff(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


def build_index(cfg: dict, X: torch.Tensor, seed: int, dev):
    gen = torch.Generator(device=dev).manual_seed(data.stream_seed(seed, 4))
    return AshIndex.build(gen, X, ASHConfig(**cfg["ash"]),
                          backend=cfg["backend"], metric=cfg["metric"],
                          device=dev, keep_raw=True, **cfg["train"])


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, *,
        device="cuda", t_start: Optional[float] = None, emit=print,
        log=lambda s: print(s, file=sys.stderr, flush=True)) -> int:
    """One run; returns the exit code.  ``emit`` prints stdout lines, the
    last of which is the result."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cfg, mix = cell.config, cell.traffic
    if dev.type == "cuda":
        emit(json.dumps(card_line(dev)))
    plan = traffic.plan(mix, cell.cell, seconds, data.stream_seed(seed, 3))
    spans = {}
    t = time.perf_counter()
    X, Q = data.draw(cfg, plan.pool_rows + WARM_ROWS, seed, dev)
    _sync(dev)
    spans["data"] = time.perf_counter() - t
    t = time.perf_counter()
    index = build_index(cfg, X, seed, dev)
    _sync(dev)
    spans["build"] = time.perf_counter() - t
    kw = dict(k=plan.k, rerank=plan.rerank, **cfg["search"])
    tracer = Tracer(trace and dev.type == "cuda", TRACE_AT * seconds,
                    min(TRACE_S, 0.4 * seconds))
    tracer.warm()
    rec = Record(plan.kind, cfg, seconds, 0.0, spans)
    engine = frontend = None
    pauses = GcPauses()

    if plan.kind == "batch":
        per = plan.rows_per_call
        t = time.perf_counter()
        for _ in range(2):  # the one shape of the window, built and warm
            s, i = index.search(Q[:per], **kw)
            s.cpu(), i.cpu()
        spans["warm"] = time.perf_counter() - t
        settle()
        rec.setup_s = time.perf_counter() - t_start
        with pauses:
            out = traffic.run_batch(lambda q: index.search(q, **kw), Q,
                                    plan, seconds,
                                    lambda i, t: tracer.at(t, i))
        tracer.close(len(out.calls))
        rec.window_s, rec.rows = out.window_s, out.rows
        attempted, failed = len(out.calls), 0
        judged_rows, scores, ids = _distinct_answers(out.calls, per)
        traced_blocks = ([c[0] for c in out.calls[tracer.marks[0]:
                                                   tracer.marks[1]]]
                         if tracer.marks else [])
    else:
        t = time.perf_counter()
        engine, frontend = open_engine(
            index, Q[plan.pool_rows:].cpu().numpy(), kw)
        pool = Q[:plan.pool_rows].cpu().numpy()
        spans["warm"] = time.perf_counter() - t
        c0 = counters(engine)
        judged = judged_requests(plan, seed)
        settle()
        rec.setup_s = time.perf_counter() - t_start
        t0 = time.perf_counter()
        box = {}
        with pauses:
            sender = _thread(lambda: box.setdefault(
                "out", traffic.run_open_loop(
                    lambda rows: frontend.submit(rows, **kw), pool, plan,
                    keep=judged, start=t0)))
            for at in tracer.times():  # the main thread drives the tracer
                _sleep_until(t0 + at)
                tracer.at(at, counters(engine))
            sender.join()
        tracer.close(counters(engine))
        if tracer.marks:
            rec.traced_counters = diff(*tracer.marks)
        out = box["out"]
        traffic.wait_answers(out, ANSWER_WAIT_S)
        rec.counters = diff(c0, counters(engine))
        rec.latency_s = out.latency_s()
        lag = out.lag_s()
        emit(json.dumps({"sender_lag_ms": {
            "p50": float(np.median(lag)) * 1e3,
            "max": float(lag.max()) * 1e3}, "refused": len(out.errors)}))
        attempted = len(out.due)
        failed = int(np.isinf(rec.latency_s).sum())
        judged_rows, scores, ids = _kept_answers(out, plan)

    memory_peak = (torch.cuda.max_memory_allocated(dev)
                   if dev.type == "cuda" else 0)
    if frontend is not None:
        frontend.stop()
    rec.trace = tracer.summary
    ivf = cfg["backend"] == "ivf"
    nprobe = cfg["search"].get("nprobe") if ivf else None
    probe = None
    if ivf:  # probed lists of the pool (batch) or the judged rows
        rec.probe_rows = (np.arange(plan.pool_rows) if plan.kind == "batch"
                          else judged_rows)
        rec.list_sizes, rec.probes = ivf_counters(
            index, Q[_rows(rec.probe_rows, dev)], nprobe,
            plan.rows_per_call or engine.config.batch_buckets[-1])
        probe = (rec.probes[judged_rows] if plan.kind == "batch"
                 else rec.probes)
    if rec.trace is not None:
        rec.traced_work = cell.work.traced(rec, plan, traced_blocks
                                           if plan.kind == "batch" else None)

    # -- the plain reference, after the window -----------------------
    t_ref = time.perf_counter()
    outputs = check.Outputs(
        W=index.model.W, landmarks=index.model.landmarks,
        codes=index.payload.codes, scale=index.payload.scale,
        offset=index.payload.offset, cluster=index.payload.cluster,
        row_ids=backend_state(index)[1].ids if ivf else None,
        probe=probe,
        scores=scores, ids=ids, unanswered=failed)
    system = [index, engine, frontend]
    del index, engine, frontend

    def drop():  # the system's state, before the reference's search
        system.clear()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    numbers = _reference_numbers(cell, outputs, X,
                                 Q[_rows(judged_rows, dev)], seed, dev,
                                 plan, nprobe, drop)
    spans["reference"] = time.perf_counter() - t_ref
    correct, shown = check.judge(numbers, cfg["limits"])

    metrics = {}
    for m in cell.metrics(trace):
        value = cell.reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else dev.type),
        "count": 1, "memory_peak_bytes": int(memory_peak),
    }
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics,
              "device": device_info}
    if rec.trace is not None:
        device_info.update(busy_s=rec.trace.busy_s,
                           window_s=rec.trace.window_s)
        result["breakdown"] = {"device_ops": rec.trace.device_ops,
                               "idle_gaps": rec.trace.idle_gaps}
    emit(json.dumps({"spans_s": spans, "setup_s": rec.setup_s,
                     "gc_pauses_in_window": pauses.summary()}))
    result["checks"] = shown
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return 4
    for name, s in shown.items():
        log(f"check {name}: {s['value']!r} (limit {s['limit']!r})")
    emit(json.dumps(result))
    return 0


def settle() -> None:
    """The last step of set-up: collect the garbage set-up left and
    freeze what survives (``gc.freeze``), so that a full collection in
    the window walks only the window's own objects.  Otherwise each one
    walks every object the imports and the build made and stalls the
    process 100-180 ms (gen-2 pauses measured on the card), and a 10 s
    window holds none or one of them at random."""
    gc.collect()
    gc.freeze()


class GcPauses:
    """The interpreter's garbage collections while entered: (generation,
    start, seconds) each, from ``gc.callbacks``."""

    def __init__(self):
        self.pauses: list = []
        self._t = None

    def _on_gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.pauses.append((info["generation"], self._t,
                                time.perf_counter() - self._t))
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self._on_gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on_gc)

    def summary(self) -> dict:
        """By generation: [collections, the longest pause in ms]."""
        return {g: [sum(1 for x, _, _ in self.pauses if x == g),
                    max((d for x, _, d in self.pauses if x == g),
                        default=0.0) * 1e3] for g in (0, 1, 2)}


def open_engine(index, warm: np.ndarray, kw: dict):
    """(engine, frontend): a ``QueryEngine`` with its default
    configuration behind a started ``ServingFrontend``, every batch
    bucket's shape warmed on ``warm``'s host rows (rows the window never
    sends), then its prep cache emptied."""
    engine = QueryEngine(index)
    frontend = ServingFrontend(engine).start()
    at = 0
    for rows in engine.config.batch_buckets:
        frontend.submit(warm[at:at + rows], **kw).result(timeout=600)
        at += rows
    engine.invalidate_prep_cache()
    return engine, frontend


def backend_state(index):
    """(backend, state) under the facade.  ``AshIndex`` has no public
    accessor for them, and the IVF counters (``list_sizes``,
    ``probe_sets``) and the payload's row order are the backend's: this
    is the one place the benchmark reads the facade's internals, so a
    refactor that moves them fails here, loudly."""
    return index._backend, index._state


def ivf_counters(index, queries: torch.Tensor, nprobe, per: int):
    """(live rows a list, the lists each query probes), after the
    window: ``probe_sets`` over ``queries`` in calls of ``per`` rows,
    the window's own call shape."""
    backend, state = backend_state(index)
    probes = [backend.probe_sets(state, index.prepare(queries[a:a + per]),
                                 nprobe)
              for a in range(0, queries.shape[0], per)]
    return backend.list_sizes(state), np.concatenate(probes)


def _thread(fn):
    import threading

    th = threading.Thread(target=fn, name="ashbench-sender", daemon=True)
    th.start()
    return th


def _sleep_until(t: float) -> None:
    left = t - time.perf_counter()
    if left > 0:
        time.sleep(left)


def _rows(rows: np.ndarray, dev) -> torch.Tensor:
    return torch.as_tensor(rows, dtype=torch.int64, device=dev)


def _distinct_answers(calls, per):
    """The judged rows and answers of a batch window: every call's
    answer, each distinct answer of a pool block once."""
    seen, rows, scores, ids = set(), [], [], []
    for b, s, i in calls:
        key = (b, s.tobytes(), i.tobytes())
        if key in seen:
            continue
        seen.add(key)
        rows.append(np.arange(b * per, (b + 1) * per))
        scores.append(s)
        ids.append(i)
    return np.concatenate(rows), np.concatenate(scores), np.concatenate(ids)


def judged_requests(plan, seed) -> np.ndarray:
    """The online requests whose answers are compared: a sample drawn
    from the seed before the window."""
    rng = np.random.default_rng(data.stream_seed(seed, 5))
    return np.sort(rng.permutation(len(plan.due))[:JUDGED_REQUESTS])


def _kept_answers(out, plan):
    """(pool rows, scores, ids) of the judged requests that were
    answered, one row per query row."""
    rows, scores, ids = [], [], []
    for i in sorted(out.kept):
        s, d = out.kept[i]
        rows.append(plan.first[i] + np.arange(plan.sizes[i]))
        scores.append(s.numpy())
        ids.append(d.numpy())
    if not rows:
        k = plan.k
        return (np.zeros(0, np.int64), np.zeros((0, k), np.float32),
                np.zeros((0, k), np.int32))
    return np.concatenate(rows), np.concatenate(scores), np.concatenate(ids)


def _reference_numbers(cell, outputs, X, queries, seed, dev, plan, nprobe,
                       drop) -> dict:
    """The reference's model and payload from the same rows and seed,
    the set-up compared, the system's state dropped, then its answers
    compared."""
    cfg = cell.config
    with R.precision(tf32=False):
        gen = torch.Generator(device=dev).manual_seed(
            data.stream_seed(seed, 4))
        model = R.train(gen, X, **cfg["ash"], **cfg["train"])
        payload = R.encode(model, X)
        numbers = check.setup_numbers(outputs, model, payload)
        drop()
        outputs.codes = outputs.scale = outputs.offset = None
        outputs.cluster = outputs.row_ids = None
        gaps, probes = check.answer_gaps(
            outputs, model, payload, X.to(torch.bfloat16), queries,
            cfg["metric"], plan.rerank, cfg["tie"], nprobe)
    if probes is not None:
        numbers["probes"] = probes
    numbers["answers"] = float(gaps.max()) if gaps.size else 0.0
    numbers["unanswered"] = float(outputs.unanswered)
    return numbers


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="ashbench/run.py",
                                description="One run of one cell.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cell = spec.Cell(a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.cell["chips"]:
        print(f"{a.workload} needs {cell.cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    return run(cell, a.seed, a.seconds, bool(a.trace), device="cuda",
               t_start=t_start)
