"""Tracing and throughput hooks on torch.profiler (counterpart of
``knowledgegraphembedding_tpu/utils/profiling.py``).

``trace(log_dir, device)`` profiles a region: host ops always, and the
card's kernels and copies when ``device`` is CUDA. When the region ends it
writes one Chrome trace, ``<host>_<pid>.<ns>.pt.trace.json``, under
``log_dir``, which Perfetto opens and TensorBoard's profiler plugin reads.
``StepTimer`` names a span on that timeline; ``Throughput`` is the rolling
triples/s meter.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str], device: Optional[torch.device] = None):
    """Profile the enclosed region when ``log_dir`` is set; no-op otherwise."""
    if not log_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


class StepTimer:
    """A named span (``torch.profiler.record_function``) around a step or a
    block inside a trace."""

    def __init__(self, name: str = "train_step"):
        self.name = name

    def __enter__(self):
        self._span = torch.profiler.record_function(self.name)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        return self._span.__exit__(*exc)


class Throughput:
    """Rolling triples/s meter."""

    def __init__(self, batch_size: int):
        self.batch_size = batch_size
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._steps = 0

    def tick(self, n_steps: int = 1):
        self._steps += n_steps

    def rate(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._steps * self.batch_size / dt if dt > 0 else 0.0
