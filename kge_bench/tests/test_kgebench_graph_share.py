"""``train_step.graph_share`` on windows made by hand: 100 x the steps
replayed from captured CUDA graphs over all steps, and nothing where the
program counted no step either way (a program without the counters)."""

import threading

import pytest

from kge_bench.harness import program_trace, spec
from kge_bench.harness.context import Ctx
from kge_bench.harness.trace import Trace


def _ctx(window):
    ctx = Ctx(root="", cell="", cfg={}, mix={}, seed=0, seconds=0.0, trace=True,
              device=None, t0=0.0, model_ref=None, counts={}, peaks={})
    ctx.traced = Trace([], [], (0.0, 100.0), 1e-4, 40)
    ctx.extra["program_trace"] = window
    return ctx


@pytest.mark.parametrize("replayed,eager,want", [(40, 0, 100.0), (30, 10, 75.0),
                                                  (0, 40, 0.0), (None, None, None)])
def test_graph_share_counts_replayed_steps_over_all_steps(replayed, eager, want):
    main = threading.main_thread().ident
    counts = [(name, main, 1.0, n) for name, n in (("train_step.replayed", replayed),
                                                   ("train_step.eager", eager),
                                                   ("train_step.captured", 2))
              if n is not None]
    got = spec.metric(spec.ROOT, "train_step.graph_share").read(
        _ctx(program_trace.Window([], counts, 40, main)))
    assert got == (None if want is None else pytest.approx(want))


def test_graph_share_without_a_window_reads_nothing():
    ctx = _ctx(None)
    assert spec.metric(spec.ROOT, "train_step.graph_share").read(ctx) is None
