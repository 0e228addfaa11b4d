"""Fault-injection points of the serving stack.

Counterpart of ``repro.testing.faults`` (the port keeps its own copy).
The write-ahead log, checkpoints, the atomic save, the engine's
mutation apply path and the background compactor's swap register
their points here: the reference's 11.

Production code declares *named points* at the instants that matter
for crash recovery (just before a WAL write hits the file, between
the two renames of an atomic save, after mutations are logged but
before they are applied, ...).  Each point is a single call::

    faults.fire("wal.append", size=len(record))

which is a no-op (one dict lookup) unless a test has armed a *plan*::

    with faults.active({"wal.append": faults.Crash(at=2)}):
        ...  # the 2nd WAL append raises SimulatedCrash

Four actions model the failure modes a process actually has:

* :class:`Crash`  — raise :class:`SimulatedCrash` *before* the guarded
  effect happens (power loss at a clean boundary).  The harness then
  abandons every in-memory object and recovers from disk, exactly as
  a killed process would.
* :class:`Torn`   — for points that write a buffer (``fire(...,
  size=n)``): return a byte count < n; the caller writes that prefix,
  flushes it, and raises ``SimulatedCrash`` — a write torn mid-record.
* :class:`Error`  — raise :class:`InjectedError` (an ordinary
  ``Exception``): the failure path that *is* supposed to be caught,
  e.g. a full disk the engine must surface without losing tickets.
* :class:`Delay`  — sleep, then proceed: widens race windows.

``SimulatedCrash`` derives from ``BaseException`` ON PURPOSE: the
serving stack guards many paths with ``except Exception`` (a failing
fused call must not kill the driver), and a real ``kill -9`` does not
care about those guards — neither may the simulated one.

The registry of points is static (module import registers them), so a
test can *enumerate* every point and prove recovery at each:

    for point in faults.points():
        run_crash_recovery_case(point)
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, Iterator, Optional, Tuple


class SimulatedCrash(BaseException):
    """The process died here.  BaseException so production ``except
    Exception`` guards can't absorb it — only the test harness, which
    then recovers from disk, may catch it."""


class InjectedError(RuntimeError):
    """An ordinary injected failure (disk full, EIO, ...) that the
    production error paths are expected to handle."""


@dataclasses.dataclass(frozen=True)
class Point:
    name: str
    torn: bool = False  # point passes size= and honours a torn cut


@dataclasses.dataclass(frozen=True)
class Crash:
    at: int = 1  # fire on the at-th hit since install
    repeat: bool = False  # also fire on every later hit


@dataclasses.dataclass(frozen=True)
class Torn:
    at: int = 1
    fraction: float = 0.5  # prefix of the write that reaches disk
    repeat: bool = False


@dataclasses.dataclass(frozen=True)
class Error:
    at: int = 1
    repeat: bool = False


@dataclasses.dataclass(frozen=True)
class Delay:
    at: int = 1
    seconds: float = 0.001
    repeat: bool = False


_lock = threading.Lock()
_points: Dict[str, Point] = {}
_plan: Dict[str, object] = {}
_hits: Dict[str, int] = {}


def point(name: str, *, torn: bool = False) -> str:
    """Register a fault point (idempotent); returns ``name`` so call
    sites can bind it to a module constant."""
    with _lock:
        _points[name] = Point(name, torn=torn)
    return name


def points(prefix: str = "") -> Tuple[Point, ...]:
    """Every registered point (optionally filtered by name prefix),
    sorted by name — the enumeration tests iterate."""
    with _lock:
        return tuple(
            p for n, p in sorted(_points.items())
            if n.startswith(prefix)
        )


def install(plan: Dict[str, object]) -> None:
    """Arm ``plan`` ({point name: action}); replaces any previous plan
    and resets hit counters.  Unknown point names are a test bug and
    raise ``ValueError``."""
    with _lock:
        unknown = set(plan) - set(_points)
        if unknown:
            raise ValueError(
                f"unknown fault points {sorted(unknown)}; "
                f"registered: {sorted(_points)}"
            )
        _plan.clear()
        _plan.update(plan)
        _hits.clear()


def reset() -> None:
    """Disarm every fault; ``fire`` returns to its no-op fast path."""
    with _lock:
        _plan.clear()
        _hits.clear()


def hits(name: str) -> int:
    """How many times ``name`` fired since the last install."""
    with _lock:
        return _hits.get(name, 0)


@contextlib.contextmanager
def active(plan: Dict[str, object]) -> Iterator[None]:
    """``with faults.active({...}):`` — install on entry, reset on
    exit (including on the SimulatedCrash the plan raises)."""
    install(plan)
    try:
        yield
    finally:
        reset()


def fire(name: str, *, size: Optional[int] = None) -> Optional[int]:
    """The production-side hook.  Returns None (proceed normally) or,
    for an armed :class:`Torn` at a ``size=``-passing point, the byte
    prefix the caller must write before raising ``SimulatedCrash``.
    """
    if not _plan:  # fast path: benign race, worst case one lock trip
        return None
    with _lock:
        action = _plan.get(name)
        if action is None:
            return None
        _hits[name] = n = _hits.get(name, 0) + 1
    if n < action.at or (n > action.at and not action.repeat):
        return None
    if isinstance(action, Crash):
        raise SimulatedCrash(f"injected crash at {name} (hit {n})")
    if isinstance(action, Torn):
        if size is None or size <= 1:
            # point can't tear a write: degrade to a clean crash
            raise SimulatedCrash(
                f"injected crash at {name} (hit {n}, torn unsupported)"
            )
        return max(1, min(size - 1, int(size * action.fraction)))
    if isinstance(action, Error):
        raise InjectedError(f"injected error at {name} (hit {n})")
    if isinstance(action, Delay):
        time.sleep(action.seconds)
        return None
    raise TypeError(f"unknown fault action {action!r}")
