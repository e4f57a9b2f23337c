"""One traced window on torch.profiler, and what the metrics read from it.

The busy arithmetic is a frozen copy of ``chip_smoke.py::profile_run``: the
device is busy while any kernel or copy of the trace runs (the union of their
intervals), and the idle share is the rest of the window. On top of it: the
device ops that took most time, and the longest gaps between device work,
named by what the host was doing then (the benchmark's own span and the
innermost host op that covered the gap's middle).
"""

from __future__ import annotations

import time
from typing import Callable, List, Tuple

import torch

#: the benchmark's spans start with this (torch.profiler.record_function)
SPAN = "kge_bench."
TOP = 10


def span(name: str):
    return torch.profiler.record_function(SPAN + name)


def union_us(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(busy microseconds, the merged intervals) of ``intervals``."""
    busy, merged = 0.0, []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                busy += b - merged[-1][1]
                merged[-1] = (merged[-1][0], b)
        else:
            busy += b - a
            merged.append((a, b))
    return busy, merged


class Trace:
    """What one traced window held: device events (name, start, end in us),
    host events, the window's bounds on the trace's clock, its length on the
    host's clock, and the work units it ran."""

    def __init__(self, device_events, host_events, bounds, window_s: float, units: int):
        self.device_events = device_events
        self.host_events = host_events
        self.bounds = bounds
        self.window_s = window_s
        self.units = units
        busy_us, self.merged = union_us([(a, b) for _, a, b in device_events])
        self.busy_s = busy_us / 1e6

    def kernel_s(self, pattern) -> Tuple[int, float]:
        """(events, seconds) of the device events whose name matches ``pattern``
        (a compiled regular expression)."""
        hits = [b - a for name, a, b in self.device_events if pattern.search(name)]
        return len(hits), sum(hits) / 1e6

    def device_ops(self) -> list:
        totals: dict = {}
        for name, a, b in self.device_events:
            totals[name] = totals.get(name, 0.0) + (b - a) / 1e6
        top = sorted(totals.items(), key=lambda kv: kv[1], reverse=True)[:TOP]
        return [[name[:160], s] for name, s in top]

    def idle_gaps(self) -> list:
        if not self.merged:
            return []
        lo, hi = self.bounds
        edges = [lo] + [x for iv in self.merged for x in iv] + [hi]
        gaps = [(edges[i + 1] - edges[i], edges[i], edges[i + 1])
                for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, reverse=True)[:TOP]
        return [[self._host_at((a + b) / 2), length / 1e6] for length, a, b in gaps]

    def _host_at(self, t: float) -> str:
        """The innermost benchmark span and host op covering time ``t``."""
        best_span, best_op = None, None
        for name, a, b in self.host_events:
            if a <= t <= b:
                slot = "span" if name.startswith(SPAN) else "op"
                cur = best_span if slot == "span" else best_op
                if cur is None or b - a < cur[1]:
                    if slot == "span":
                        best_span = (name[len(SPAN):], b - a)
                    else:
                        best_op = (name, b - a)
        parts = [p[0] for p in (best_span, best_op) if p is not None]
        return ": ".join(parts)[:160] or "no host op"


def traced(fn: Callable[[], int], device: torch.device) -> Trace:
    """Run ``fn`` (which returns the work units it ran) under the profiler,
    host and (on CUDA) device activity, between two synchronizations."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        with span("window"):
            t0 = time.perf_counter()
            units = fn()
            if cuda:
                torch.cuda.synchronize(device)
            window_s = time.perf_counter() - t0
    dev_events, host, bounds = [], [], None
    for e in prof.events():
        item = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(SPAN):  # a span's mark on the device's timeline
                dev_events.append(item)
        else:
            host.append(item)
            if e.name == SPAN + "window":
                bounds = item[1:]
    if bounds is None:
        bounds = (min(a for _, a, _ in dev_events + host), max(b for _, _, b in dev_events + host))
    return Trace(dev_events, host, bounds, window_s, units)
