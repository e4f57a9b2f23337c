"""The program's own spans and counters in the traced window.

knowledgegraphembedding_torch records them (``utils/profiling.py``: ``span``
and ``count``) while a torch.profiler session records, and only then: here,
inside ``trace.traced``. They go to an in-memory store of the program, never
to the device timeline, so the device-trace metrics read the same events with
them as without. Each top-level span also leaves one zero-length mark on the
profiler's host timeline, and ``profiling.clock_offset_us`` fits the store's
clock to the trace's from the marks the window holds.

``window(ctx)`` maps the recorded spans and counter samples onto
``ctx.traced``'s clock and keeps what lies inside the window's bounds, a span
clipped to them. A program without the recorder, or a window that holds none
of its marks, gives None, and every metric that reads it then returns None.

A host span times the host's own work only where the host never waits. In
the eval driver it waits inside CUDA runtime calls: under the profiler each
graph launch is held until CUPTI has recorded its kernels, and the copy to
the host until the device is done. ``host_ms`` takes out of its spans the
time inside runtime and driver calls (``cuda*``, ``cu*``; their own few
microseconds a launch go with them) and the profiler's own host work. The
trace's host events carry no thread, so another thread's runtime calls are
taken out too where they overlap a main-thread span. An eager training step
also waits outside such calls (on the autograd engine's device thread, for
one), so no metric reads a training step's host time from this window.
This is the one file of the benchmark besides ``program.py`` that imports
the package.
"""

from __future__ import annotations

import re
import threading
from typing import Iterable, List, Optional, Sequence, Tuple

from kge_bench.harness.trace import union_us

#: the profiler's own host work, under which the device waits on the tracer
PROFILER_OWN = ("Activity Buffer Request",)
#: CUDA runtime (``cudaLaunchKernel``, ``cudaGraphLaunch``, ...) and driver
#: (``cuLaunchKernel``, ...) calls among the trace's host events
RUNTIME_CALL = re.compile(r"cu(da)?[A-Z]")

Interval = Tuple[float, float]


class Window:
    """Spans (name, parent, thread, start_us, end_us) and counter samples
    (name, thread, t_us, n) of the traced window, on its clock; ``units``:
    its steps or passes."""

    def __init__(self, spans: list, counts: list, units: int, main: int):
        self.spans, self.counts, self.units, self.main = spans, counts, units, main

    def main_spans(self, name: Optional[str] = None) -> list:
        """The main thread's spans (the caller's: the step loop, the eval
        driver, the feed's consumer), of ``name`` or all."""
        return [s for s in self.spans if s[2] == self.main and (name is None or s[0] == name)]

    def ms_per_unit(self, name: str) -> Optional[float]:
        """Milliseconds a unit in the main thread's spans ``name``."""
        spans = self.main_spans(name)
        if not spans or not self.units:
            return None
        return sum(b - a for _, _, _, a, b in spans) / 1e3 / self.units

    def total(self, name: str) -> Optional[int]:
        """The window's sum of counter ``name``, every thread's samples."""
        ns = [n for c, _, _, n in self.counts if c == name]
        return sum(ns) if ns else None

    def share(self, part: str, whole: str) -> Optional[float]:
        """100 x counter ``part`` over counter ``whole``, in %."""
        p, w = self.total(part), self.total(whole)
        if p is None or not w:
            return None
        return 100.0 * p / w


def window(ctx) -> Optional[Window]:
    """The program's records in ``ctx.traced``'s window (cached on ``ctx``)."""
    if "program_trace" not in ctx.extra:
        ctx.extra["program_trace"] = _window(ctx)
    return ctx.extra["program_trace"]


def _window(ctx) -> Optional[Window]:
    tr = ctx.traced
    if tr is None:
        return None
    try:
        from knowledgegraphembedding_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "records"):  # a program without the recorder
        return None
    spans, counts, marks = profiling.records()
    offset = profiling.clock_offset_us(
        (e for e in tr.host_events if e[0].startswith(profiling.MARK)), marks)
    if offset is None:
        return None
    lo, hi = tr.bounds
    kept_spans = []
    for s in spans:
        a, b = max(lo, s.start_ns / 1e3 + offset), min(hi, s.end_ns / 1e3 + offset)
        if a < b:
            kept_spans.append((s.name, s.parent, s.thread, a, b))
    kept_counts = [(c.name, c.thread, c.t_ns / 1e3 + offset, c.n) for c in counts
                   if lo <= c.t_ns / 1e3 + offset <= hi]
    return Window(kept_spans, kept_counts, tr.units, threading.main_thread().ident)


def _complement(merged: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The parts of [lo, hi] outside ``merged`` (sorted, disjoint)."""
    out, at = [], lo
    for a, b in merged:
        if a > at:
            out.append((at, min(a, hi)))
        at = max(at, b)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(a, b) for a, b in out if b > a]


def _intersect(xs: Sequence[Interval], ys: Sequence[Interval]) -> List[Interval]:
    """The intersection of two sorted, disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _merged(intervals: Iterable[Interval]) -> List[Interval]:
    return union_us(list(intervals))[1]


def idle_program_ms(ctx, leave_out: Sequence[str] = ()) -> Optional[float]:
    """Device-idle milliseconds a unit that lie inside the union of the main
    thread's program spans, less the spans named in ``leave_out`` and the
    profiler's own host work (``PROFILER_OWN``)."""
    tr, w = ctx.traced, window(ctx)
    if w is None or not tr.device_events or not tr.units:
        return None
    lo, hi = tr.bounds
    program = _merged((a, b) for _, _, _, a, b in w.main_spans())
    if not program:
        return None
    out = _merged([(a, b) for name, _, _, a, b in w.main_spans() if name in leave_out]
                  + [(a, b) for name, a, b in tr.host_events if name in PROFILER_OWN])
    inside = _intersect(_intersect(_complement(tr.merged, lo, hi), program),
                        _complement(out, lo, hi))
    return sum(b - a for a, b in inside) / 1e3 / tr.units


def host_ms(ctx, name: str, leave_out: Sequence[str] = ()) -> Optional[float]:
    """The host's own milliseconds a unit in the main thread's spans ``name``:
    their time outside the spans named in ``leave_out``, outside CUDA runtime
    and driver calls (``RUNTIME_CALL``) and outside the profiler's own host
    work (``PROFILER_OWN``)."""
    tr, w = ctx.traced, window(ctx)
    if w is None or not tr.units:
        return None
    spans = _merged((a, b) for _, _, _, a, b in w.main_spans(name))
    if not spans:
        return None
    lo, hi = tr.bounds
    out = _merged([(a, b) for n, _, _, a, b in w.main_spans() if n in leave_out]
                  + [(a, b) for n, a, b in tr.host_events
                     if n in PROFILER_OWN or RUNTIME_CALL.match(n)])
    inside = _intersect(spans, _complement(out, lo, hi))
    return sum(b - a for a, b in inside) / 1e3 / tr.units
