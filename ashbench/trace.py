"""The traced sub-window of a ``--trace 1`` run and the arithmetic on
its events.

The profiler (CPU and CUDA activities) runs over a steady stretch of
the measured window, marked by a CPU range ``ashbench.traced_window``.
One pass over the raw kineto events (as ``key_averages()`` would, but
without building its event tree) gives:

* ``busy_s``: the union of the device's kernel, copy and memset
  intervals inside the window (a union, not a sum: intervals on several
  streams overlap);
* ``device_ops``: device seconds by operation name;
* ``idle_gaps``: the device's idle time inside the window, by what the
  host was doing: the shortest CPU event (an operator, a runtime call
  or a range, not the window's or the profiler's step) that covers the
  middle of each gap, "host code" where none does.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

WINDOW = "ashbench.traced_window"
STEP = "ProfilerStep#"  # the profiler's own range around a scheduled step


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: list  # [[name, seconds], ...] most first, at most 10
    idle_gaps: list  # [[host activity, seconds], ...] most first

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def merge(intervals):
    """Sorted disjoint union of (start, end) pairs."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def summarize(device, cpu, window, top: int = 10) -> TraceSummary:
    """``device``: (start, end, name) of device activities; ``cpu``:
    (start, end, name) of host events; ``window``: (start, end); all in
    one clock's ns."""
    w0, w1 = window
    by_name: dict = {}
    clipped = []
    for a, b, name in device:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            clipped.append((a, b))
            by_name[name] = by_name.get(name, 0) + (b - a)
    busy = merge(clipped)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    # the shortest host event covering each gap's middle, by one sweep
    # over events sorted by start and gaps sorted by middle
    events = sorted((a, b, name) for a, b, name in cpu
                    if name != WINDOW and not name.startswith(STEP)
                    and b > a)
    heap: list = []
    j = 0
    idle: dict = {}
    for g0, g1 in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (g0 + g1) / 2
        while j < len(events) and events[j][0] <= mid:
            a, b, name = events[j]
            heapq.heappush(heap, (b - a, b, name))
            j += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        name = heap[0][2] if heap else "host code"
        idle[name] = idle.get(name, 0) + (g1 - g0)

    def ranked(d):
        return [[k, v / 1e9] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return TraceSummary(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(b - a for a, b in busy) / 1e9,
        device_ops=ranked(by_name), idle_gaps=ranked(idle),
    )


def kineto_summary(prof) -> Optional[TraceSummary]:
    """The summary of a finished ``torch.profiler.profile``; None when it
    holds no traced window."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, cpu, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        name, a, b = e.name(), e.start_ns(), e.end_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation() and b > a:
                device.append((a, b, name))
        elif name == WINDOW:
            window = (a, b)
        else:
            cpu.append((a, b, name))
    if window is None or window[1] <= window[0]:
        return None
    return summarize(device, cpu, window)


class Tracer:
    """Profiles one stretch of a run, ``length_s`` from ``begin_s`` into
    the window, when enabled; else does nothing.

    The profiler is started ``ARM_S`` before the stretch in its warm-up
    phase, which turns the device's activity tracing on and drops what
    it records; the stretch itself then only switches recording on.  So
    a kernel that another thread launches while tracing is being turned
    on is never what the stretch holds.  The harness calls :meth:`at` as
    the window goes on, with a count of the work done so far, and keeps
    the counts at the stretch's start and end in ``marks``."""

    ARM_S = 0.5

    def __init__(self, enabled: bool, begin_s: float = 0.0,
                 length_s: float = 0.0):
        self.enabled = enabled
        self.begin_s, self.length_s = begin_s, length_s
        self.summary: Optional[TraceSummary] = None
        self.marks: list = []  # the counts at the stretch's start and end
        self._prof = self._range = None

    def warm(self) -> None:
        """Start and stop the profiler once during set-up, so that its
        own start-up cost falls outside the measured window."""
        if self.enabled:
            import torch

            with torch.profiler.profile(activities=self._activities()):
                torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    @staticmethod
    def _activities():
        from torch.profiler import ProfilerActivity
        return [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    def times(self) -> list:
        """The window's times at which :meth:`at` moves the profiler on."""
        if not self.enabled:
            return []
        b = self.begin_s
        return [max(0.0, b - self.ARM_S), b, b + self.length_s]

    def at(self, elapsed: float, count=None) -> None:
        """Arm, start or stop the profiler as ``elapsed`` seconds into
        the window ask."""
        if not self.enabled or len(self.marks) == 2:
            return
        import torch

        if self._prof is None and elapsed >= self.begin_s - self.ARM_S:
            self._prof = torch.profiler.profile(
                activities=self._activities(),
                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1))
            self._prof.start()  # the warm-up phase
        if self._prof is not None and not self.marks \
                and elapsed >= self.begin_s:
            self._prof.step()  # recording from here
            self._range = torch.profiler.record_function(WINDOW)
            self._range.__enter__()
            self.marks.append(count)
        elif len(self.marks) == 1 \
                and elapsed >= self.begin_s + self.length_s:
            self.close(count)

    def close(self, count=None) -> None:
        """End the stretch if it is open (the window ended first)."""
        if len(self.marks) != 1:
            return
        import torch

        torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._prof.stop()
        self.summary = kineto_summary(self._prof)
        self.marks.append(count)
