"""Named spans inside the port, on the profiler's clock.

``span(name)`` is a context manager around one part of the program.

* Off (the default), it reads one module global and returns one shared
  no-op context: no lock, no allocation, no clock read.
* On (:func:`enable`), it enters ``torch.profiler.record_function(name)``,
  so the range lands in any running profiler's trace on the same clock
  as the device's kernels, and adds its host duration to per-name
  totals (:func:`totals`): count, seconds, and self seconds, the
  duration less what spans nested in it on the same thread took.

Search-path spans never synchronise the device: their host seconds are
the time the host spent in them, launches included, not the device
work they queued.  The two ``build.*`` spans run in set-up and
synchronise at their end, so that their seconds hold the device work
they launched.

The span names form the closed set :data:`SPANS`; a name outside it
raises while tracing is on.

=====================  ===============================================
span                   wraps
=====================  ===============================================
index.prep             ``core.scoring.prepare_queries``
index.scan             ``index.common.execute_plan`` (route, kernels,
                       merge, id mapping)
index.rerank           ``index.common.exact_rerank``
ivf.probe              ``index.ivf._probe_lists``
ivf.table              ``index.ivf.candidate_rows``
engine.wait            the frontend driver's wait for work
engine.tick            the rest of a driver pass (pressure, flushes)
engine.flush           ``QueryEngine._flush_group``
engine.plan            ``QueryEngine._plan_chunks``
engine.prep            ``QueryEngine._prep_for`` (the prep cache)
engine.call            the fused ``search_prepped`` call
engine.copy            the fused call's copies to the host
engine.resolve         the stats update and the tickets' resolution
build.kmeans           ``core.learning.kmeans`` (seeding and Lloyd)
build.encode           a flat or IVF build from encoding through the
                       backend's assembly
train.forward_backward the train step's gradients
train.compression      its gradient compression
train.optimizer        its optimizer update
=====================  ===============================================
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

SPANS = (
    "index.prep", "index.scan", "index.rerank",
    "ivf.probe", "ivf.table",
    "engine.wait", "engine.tick", "engine.flush", "engine.plan",
    "engine.prep", "engine.call", "engine.copy", "engine.resolve",
    "build.kmeans", "build.encode",
    "train.forward_backward", "train.compression", "train.optimizer",
)
_NAMES = frozenset(SPANS)
_SYNCED = frozenset(("build.kmeans", "build.encode"))

_on = False
_OFF = contextlib.nullcontext()
_clock = time.perf_counter_ns
_lock = threading.Lock()  # guards _totals alone
_totals: dict = {}  # name -> [count, ns, self ns]
_local = threading.local()  # .stack: this thread's open spans


def enable(on: bool = True) -> None:
    """Turn spans on (or off).  Spans already open keep their state."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def reset() -> None:
    """Forget the totals."""
    with _lock:
        _totals.clear()


def totals() -> dict:
    """``{name: {"count", "s", "self_s"}}`` of every span closed since
    the last :func:`reset` while tracing was on."""
    with _lock:
        return {name: {"count": c, "s": ns / 1e9, "self_s": own / 1e9}
                for name, (c, ns, own) in _totals.items()}


def span(name: str):
    """A context manager around one named part of the program."""
    if not _on:
        return _OFF
    return _Span(name)


class _Span:
    __slots__ = ("name", "child_ns", "_range", "_t0")

    def __init__(self, name: str):
        if name not in _NAMES:
            raise ValueError(f"unknown span {name!r}; spans are {SPANS}")
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        stack.append(self)
        self.child_ns = 0
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._t0 = _clock()
        return self

    def __exit__(self, *exc):
        if self.name in _SYNCED and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        ns = _clock() - self._t0
        self._range.__exit__(*exc)
        stack = _local.stack
        stack.pop()
        if stack:
            stack[-1].child_ns += ns
        with _lock:
            t = _totals.setdefault(self.name, [0, 0, 0])
            t[0] += 1
            t[1] += ns
            t[2] += ns - self.child_ns
        return False
