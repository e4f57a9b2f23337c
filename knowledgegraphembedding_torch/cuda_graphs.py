"""CUDA graph capture and replay: the one place where the port makes graphs.

Three owners capture bodies and replay them:

  - a trainer's per-step graphs (``train.Trainer.one_step``, kind "step"),
    one ``train_step`` a corruption mode;
  - the fused blocks' graphs (``fused_train.FusedDeviceTrainer.run_block``,
    kind "block"), one fused step a mode, replayed k times a block;
  - the eval scan's chunk graphs (``eval._ChunkGraph``, kind "eval_chunk").

Each owner holds a ``Capturer``: one side stream for warm-ups and captures
and one memory pool, a trainer's for all its graphs, eval's one a device. A
capture (``Capturer.capture``)

  - joins an asynchronous checkpoint still being written: the writer's
    copies must not run beside a capture;
  - runs one eager warm-up on the side stream (the body itself unless the
    owner gives another) and puts back what the body writes, so the owner's
    state is as it found it;
  - captures the body with ``capture_error_mode="thread_local"``: the
    prefetch worker and a checkpoint's writer may be copying on their own
    streams meanwhile;
  - keeps what the captured body counted (``profiling.diverted_counts``).

A replay (``Graph.replay``) runs on the current stream, bumps the autograd
version of every tensor the body writes (a replay bypasses the dispatcher,
and ``rank_kernel.get_ranker`` keys its cache on the versions), counts again
what the capture counted, since a replay runs no Python, and returns the
body's output, which the next replay overwrites. A failed capture or replay
raises; nothing runs eagerly in a graph's place. ``captures`` and
``replays`` tally both by kind over all owners.
"""

from __future__ import annotations

import collections
import contextlib
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import torch

from .checkpoint import wait_for_pending_save
from .utils import profiling

#: graphs captured and replayed, by kind, over all owners
captures: collections.Counter = collections.Counter()
replays: collections.Counter = collections.Counter()


@contextlib.contextmanager
def writes_undone(tensors: Sequence[torch.Tensor]):
    """Run the block, then put ``tensors`` back as they were before it (on
    the current stream): a capture's eager warm-up leaves the state it
    wrote as it found it."""
    saved = [t.detach().clone() for t in tensors]
    yield
    with torch.no_grad():
        for t, s in zip(tensors, saved):
            t.copy_(s)


def bump_versions(tensors: Iterable[torch.Tensor]) -> None:
    """Move the autograd version of each tensor, as a write through the
    dispatcher does."""
    for t in tensors:
        torch.autograd.graph.increment_version(t)


class Graph:
    """One captured body: the CUDA graph, its output, the counts its
    capture recorded and the tensors it writes."""

    def __init__(self, kind: str, graph, out, counts: List[Tuple[str, int]],
                 written: Sequence[torch.Tensor]):
        self.kind = kind
        self.graph = graph
        self.out = out
        self.counts = counts
        self.written = list(written)

    def replay(self):
        """Run the graph on the current stream; the body's output."""
        self.graph.replay()
        bump_versions(self.written)
        for name, n in self.counts:
            profiling.count(name, n)
        replays[self.kind] += 1
        return self.out


class Capturer:
    """The side stream and the memory pool of one owner's graphs, and the
    tensors they were captured on."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._side = None
        self._pool = None
        self._on: Tuple[torch.Tensor, ...] = ()

    def stale(self, on: Sequence[torch.Tensor]) -> bool:
        """Whether ``on`` differ, by identity, from the tensors the owner's
        graphs were captured on (a restore that replaces any of them calls
        for new captures). If so, the owner drops its graphs, and the
        capturer waits for their replays and takes a new pool and ``on``."""
        on = tuple(on)
        if len(on) == len(self._on) and all(a is b for a, b in zip(on, self._on)):
            return False
        if self._pool is not None:
            torch.cuda.synchronize(self.device)  # no replay of the old graphs in flight
            self._pool = None
        self._on = on
        return True

    def capture(self, kind: str, body: Callable, *, written: Sequence[torch.Tensor] = (),
                warm: Optional[Callable] = None) -> Graph:
        """``body()`` captured as a graph of ``kind``, after one eager run of
        ``warm`` (``body`` by default) whose writes to ``written`` are
        undone."""
        wait_for_pending_save()
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        side, cur = self._side, torch.cuda.current_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side), profiling.diverted_counts(), writes_undone(written):
            (warm or body)()
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with profiling.diverted_counts() as counts, torch.cuda.graph(
                graph, pool=self._pool, stream=side, capture_error_mode="thread_local"):
            out = body()
        cur.wait_stream(side)
        captures[kind] += 1
        return Graph(kind, graph, out, counts, written)
