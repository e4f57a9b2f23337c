"""The port's tracing: spans and counters on torch.profiler's clock
(counterpart of ``knowledgegraphembedding_tpu/utils/profiling.py``).

Tracing is on while a torch.profiler session records, and only then: the
benchmark's traced window, or the CLI's ``--profile_dir`` through
``trace``. No flag or environment variable turns it on.

- ``span(name)``: a context manager. Off, it reads one flag and returns a
  shared null context: no ``record_function`` call, no allocation. On, it
  records ``(name, parent, thread id, start_ns, end_ns)`` into a bounded
  in-memory store, the parent being the enclosing span on the same thread.
  Threads the profiler does not follow (the prefetch worker) record alike.
- ``count(name, n)``: a timestamped counter sample, recorded only when on;
  ``diverted_counts`` collects a block's samples instead, on or off.

Spans never enter the device timeline. Kineto projects a ``record_function``
range that launches kernels onto the device rows as a user annotation, which
a reader of the trace would take for device work; so no span is one. The
store's stamps are the host's wall clock (``time.time_ns``). To place them on
the profiler's timeline, each top-level span, while on, first enters and
leaves one zero-length mark, ``kge.mark.<seq>``, a range that launches
nothing; ``clock_offset_us`` fits the offset between the two clocks from the
marks a trace holds. ``trace(log_dir)`` writes the recorded spans and
counters into the Chrome trace it writes, on that trace's clock, where
Perfetto shows them beside the host and device rows.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import socket
import statistics
import threading
import time
from typing import Iterable, List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

#: the zero-length marks' names start with this; a sequence number follows
MARK = "kge.mark."
#: the most spans, counter samples and marks the store keeps (oldest dropped)
MAX_RECORDS = 1 << 18
#: the Chrome trace's process row of the spans and counters
TRACE_PID = "Program spans"

# the cheap C++ range where this torch has it
_record_function = getattr(torch._C._profiler, "_RecordFunctionFast",
                           torch.profiler.record_function)


class SpanRecord(NamedTuple):
    name: str
    parent: Optional[str]
    thread: int  # threading.get_ident()
    start_ns: int
    end_ns: int


class CountRecord(NamedTuple):
    name: str
    thread: int
    t_ns: int
    n: int


class MarkRecord(NamedTuple):
    seq: int
    before_ns: int  # just before the mark's range opened
    after_ns: int   # just after it closed


_spans: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_counts: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_marks: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_seq = itertools.count()
_local = threading.local()
_thread_names: dict = {}
_NULL = contextlib.nullcontext()


def enabled() -> bool:
    """True while a torch.profiler session records."""
    return _autograd_profiler._is_profiler_enabled


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
        _thread_names[threading.get_ident()] = threading.current_thread().name
    return stack


def _mark() -> None:
    seq = next(_seq)
    before = time.time_ns()
    with _record_function(f"{MARK}{seq}"):
        pass
    _marks.append(MarkRecord(seq, before, time.time_ns()))


class _Span:
    __slots__ = ("name", "parent", "start")

    def __init__(self, name: str, parent: Optional[str]):
        self.name, self.parent = name, parent

    def __enter__(self):
        if self.parent is None:
            _mark()
        _stack().append(self.name)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _stack().pop()
        _spans.append(SpanRecord(self.name, self.parent, threading.get_ident(),
                                 self.start, end))
        return False


def span(name: str):
    """A named span of host time, recorded while a profiler session records
    (see the module's docstring)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    stack = _stack()
    return _Span(name, stack[-1] if stack else None)


def count(name: str, n: int = 1) -> None:
    """One sample of counter ``name``: ``n`` more, at this time and thread,
    recorded while a profiler session records (inside ``diverted_counts``,
    kept by it instead)."""
    sink = getattr(_local, "sink", None)
    if sink is not None:
        sink.append((name, n))
        return
    if not _autograd_profiler._is_profiler_enabled:
        return
    _counts.append(CountRecord(name, threading.get_ident(), time.time_ns(), n))


@contextlib.contextmanager
def diverted_counts():
    """Every ``count`` of this thread inside the block, profiled or not, goes
    to the list this yields, as ``(name, n)``, and not to the store: a CUDA
    graph's capture runs no step, so it keeps what the captured step counts
    for each replay to count again."""
    outer = getattr(_local, "sink", None)
    _local.sink = sink = []
    try:
        yield sink
    finally:
        _local.sink = outer


def records() -> Tuple[List[SpanRecord], List[CountRecord], List[MarkRecord]]:
    """Copies of what the store holds: spans, counter samples and marks."""
    return list(_spans), list(_counts), list(_marks)


def clear() -> None:
    _spans.clear()
    _counts.clear()
    _marks.clear()


def thread_name(ident: int) -> str:
    return _thread_names.get(ident, str(ident))


def clock_offset_us(events: Iterable[Tuple[str, float, float]],
                    marks: Optional[List[MarkRecord]] = None) -> Optional[float]:
    """The offset, in microseconds, that puts the store's stamps on a
    profiler trace's clock (``trace_us = ns / 1000 + offset``), fitted from
    the trace's ``events`` (name, start_us, end_us) that are the store's
    marks; None when the trace holds none of them.

    A mark's range lies between its two stamps, so each mark bounds the
    offset from both sides; the fit is the middle of the bounds all marks
    leave, or, should round-off leave none, the median of the marks'
    midpoints."""
    stamps = {f"{MARK}{m.seq}": m for m in (_marks if marks is None else marks)}
    lo, hi, mids = -float("inf"), float("inf"), []
    for name, start, end in events:
        m = stamps.get(name)
        if m is None:
            continue
        lo = max(lo, end - m.after_ns / 1e3)
        hi = min(hi, start - m.before_ns / 1e3)
        mids.append((start + end) / 2 - (m.before_ns + m.after_ns) / 2e3)
    if not mids:
        return None
    return (lo + hi) / 2 if lo <= hi else statistics.median(mids)


def _chrome_events(offset_us: float) -> list:
    """The store's spans (complete events) and counters (running totals) as
    Chrome trace events on the clock that ``offset_us`` maps to, one row a
    thread under the process row ``TRACE_PID``."""
    spans, counts, _ = records()
    out = [{"ph": "M", "name": "process_name", "pid": TRACE_PID, "tid": 0,
            "args": {"name": TRACE_PID}}]
    for s in spans:
        out.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": TRACE_PID,
                    "tid": thread_name(s.thread), "ts": s.start_ns / 1e3 + offset_us,
                    "dur": (s.end_ns - s.start_ns) / 1e3, "args": {"parent": s.parent}})
    totals: dict = {}
    for c in sorted(counts, key=lambda c: c.t_ns):
        totals[c.name] = totals.get(c.name, 0) + c.n
        out.append({"ph": "C", "cat": "program_counter", "name": c.name, "pid": TRACE_PID,
                    "ts": c.t_ns / 1e3 + offset_us, "args": {"total": totals[c.name]}})
    return out


def _write_chrome_trace(log_dir: str):
    """``on_trace_ready`` for ``trace``: the profiler's Chrome trace,
    ``<host>_<pid>.<ns>.pt.trace.json`` under ``log_dir``, with the store's
    spans and counters added on its clock."""
    def write(prof) -> None:
        os.makedirs(log_dir, exist_ok=True)
        path = os.path.join(log_dir, f"{socket.gethostname()}_{os.getpid()}."
                                     f"{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
        events = doc["traceEvents"]
        offset = clock_offset_us((e["name"], e["ts"], e["ts"] + e.get("dur", 0.0))
                                 for e in events
                                 if e.get("ph") == "X" and e.get("name", "").startswith(MARK))
        if offset is not None:
            events.extend(_chrome_events(offset))
            with open(path, "w") as f:
                json.dump(doc, f)
    return write


@contextlib.contextmanager
def trace(log_dir: Optional[str], device: Optional[torch.device] = None):
    """Profile the enclosed region when ``log_dir`` is set; no-op otherwise.
    Host ops always, the card's kernels and copies when ``device`` is CUDA,
    and the port's spans and counters, written as one Chrome trace that
    Perfetto opens and TensorBoard's profiler plugin reads."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    clear()
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=_write_chrome_trace(log_dir)):
        yield
