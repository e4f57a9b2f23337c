"""The parts of ``knowledgegraphembedding_torch/cuda_graphs.py`` that need no
card: a warm-up's writes undone, the identity check of the tensors the
graphs were captured on, and a replay (a stand-in for the CUDA graph's)
that counts again what its capture counted, bumps the autograd version of
what the body writes and tallies itself by kind. Capture itself runs on the
card only (``tests/test_torch_cuda.py``)."""

import collections
import contextlib
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from knowledgegraphembedding_torch import cuda_graphs
from knowledgegraphembedding_torch.utils import profiling


def test_writes_undone_puts_back_only_the_listed_tensors():
    a, b, other = torch.arange(4.0), torch.ones(2, 3), torch.zeros(3)
    want = [a.clone(), b.clone()]
    with cuda_graphs.writes_undone([a, b]):
        a.add_(1.0)
        b.mul_(-2.0)
        other.fill_(7.0)
    assert torch.equal(a, want[0]) and torch.equal(b, want[1])
    assert torch.equal(other, torch.full((3,), 7.0))


def _tensors():
    return [torch.zeros(2), torch.ones(3), torch.tensor(0.5)]


# case -> (the tensors asked about, given the ones captured on) and whether stale
STALE = {
    "the same": (lambda on: list(on), False),
    "a clone": (lambda on: [on[0].clone(), *on[1:]], True),
    "one fewer": (lambda on: on[:-1], True),
    "reordered": (lambda on: [on[1], on[0], on[2]], True),
    "equal values": (lambda on: [t.clone() for t in on], True),
}


@pytest.mark.parametrize("case", list(STALE))
def test_stale_compares_the_tensors_by_identity(case):
    """The first look is always stale (nothing captured yet); then only the
    very tensors it was last given are current, whatever their values."""
    on = _tensors()
    capturer = cuda_graphs.Capturer("cpu")
    assert capturer.stale(on)
    assert not capturer.stale(on)
    on[0].add_(1.0)  # values may change: the graphs read the live tensors
    asked, want = STALE[case]
    other = asked(on)
    assert capturer.stale(other) is want
    assert not capturer.stale(other)  # the capturer now holds what it was given


@pytest.mark.parametrize("profiled", [False, True])
def test_replay_counts_again_bumps_versions_and_tallies(profiled):
    """A replay runs the graph, bumps the version of every written tensor
    (and of no other), counts the capture's counts once more when a profiler
    session records, tallies one replay of its kind and returns the body's
    output."""
    written, other = _tensors(), torch.zeros(4)
    ran = []
    out = {"loss": torch.tensor(1.5)}
    graph = cuda_graphs.Graph("test_kind", types.SimpleNamespace(replay=lambda: ran.append(1)),
                              out, [("train_step.gather_scored", 1), ("sampler.kept", 8)],
                              written)
    versions = [t._version for t in written]
    other_version = other._version
    replays = cuda_graphs.replays["test_kind"]
    profiling.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]) if profiled else contextlib.nullcontext():
            assert graph.replay() is out
            assert graph.replay() is out
        counts = collections.Counter()
        for c in profiling.records()[1]:
            counts[c.name] += c.n
    finally:
        profiling.clear()
    assert ran == [1, 1]
    assert [t._version for t in written] == [v + 2 for v in versions]
    assert other._version == other_version
    assert cuda_graphs.replays["test_kind"] == replays + 2
    assert counts == ({"train_step.gather_scored": 2, "sampler.kept": 16} if profiled else {})

