"""The per-layer metrics that read the program's own spans and counters
(``harness/program_trace.py``), on the CPU at the cells' tiny sizes: each
reads a float where its records exist, an eval pass's host and pull time add
up to the traced window (on the CPU the host waits in no CUDA runtime call),
the device-idle and host-work arithmetic is right on windows made by hand,
and a program without the recorder gives None, not an error."""

import threading

import pytest

from conftest import CELLS, TINY, tiny_run
from kge_bench.harness import program_trace, spec
from kge_bench.harness.context import Ctx
from kge_bench.harness.trace import Trace

#: read from the device trace too, which a CPU run has not
NEEDS_DEVICE = {"idle_program_ms.train", "idle_program_ms.eval"}


def _program_metrics(cell):
    return [m["name"] for m in spec.per_layer_of(spec.load_benchmark(), cell)
            if m["source"] in ("program_span", "program_counter")]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_program_metrics(cell):
    names = _program_metrics(cell)
    assert NEEDS_DEVICE & set(names)
    r = tiny_run(cell, trace=True)
    got = r["metrics"]
    for name in names:
        if name in NEEDS_DEVICE:
            assert name not in got  # no device events on the CPU
        else:
            assert isinstance(got[name]["value"], float) and got[name]["value"] >= 0, name


@pytest.mark.parametrize("cell", [c for c in CELLS if c.endswith(".eval")])
def test_eval_host_and_pull_add_up_to_the_window(cell):
    config = cell.split(".")[0]
    # a test split long enough that the harness's own work between passes is small
    over = dict(TINY[config], graph={**TINY[config]["graph"], "ntest": 600})
    import time

    import torch

    from kge_bench import run

    r = run.run(cell, 2147483999, 0.5, True, torch.device("cpu"), overrides=over,
                t0=time.perf_counter())
    m = r["metrics"]
    per_pass_ms = 1e3 * r["device"]["window_s"] / 2  # the traffic's trace_passes
    total = m["eval.host_ms"]["value"] + m["eval.pull_wait_ms"]["value"]
    assert total == pytest.approx(per_pass_ms, rel=0.05)


def _ctx(trace, window):
    ctx = Ctx(root="", cell="", cfg={}, mix={}, seed=0, seconds=0.0, trace=True,
              device=None, t0=0.0, model_ref=None, counts={}, peaks={})
    ctx.traced = trace
    ctx.extra["program_trace"] = window
    return ctx


def test_idle_program_ms_counts_idle_inside_program_spans_only():
    main, other = threading.main_thread().ident, -1
    # window 0-100 us; the device busy 10-30 and 60-90, idle 0-10, 30-60, 90-100
    trace = Trace([("k", 10.0, 30.0), ("k", 60.0, 90.0)],
                  [("Activity Buffer Request", 40.0, 45.0)], (0.0, 100.0), 1e-4, 2)
    spans = [("train_step", None, main, 5.0, 50.0),           # idle 5-10, 30-50
             ("train_step.adam", "train_step", main, 35.0, 38.0),
             ("eval.pull", None, main, 92.0, 97.0),           # idle 92-97
             ("sampler.sample", None, other, 0.0, 100.0)]     # not the main thread
    ctx = _ctx(trace, program_trace.Window(spans, [], 2, main))
    # 5 + 20 - 5 (the buffer request) + 5, over 2 units, in ms
    assert program_trace.idle_program_ms(ctx) == pytest.approx(25e-3 / 2)
    assert program_trace.idle_program_ms(ctx, ("eval.pull",)) == pytest.approx(20e-3 / 2)
    assert program_trace.idle_program_ms(_ctx(Trace([], [], (0.0, 100.0), 1e-4, 2),
                                              ctx.extra["program_trace"])) is None


def test_host_ms_leaves_out_runtime_calls_and_the_profilers_work():
    main, other = threading.main_thread().ident, -1
    # window 0-100 us, 2 units; the main thread's passes 0-40 and 50-90
    host = [("cudaLaunchKernel", 5.0, 7.0), ("cudaGraphLaunch", 20.0, 30.0),
            ("cuLaunchKernel", 25.0, 35.0),                    # overlaps the last
            ("Activity Buffer Request", 60.0, 64.0),
            ("cudaMemcpyAsync", 92.0, 99.0),                   # outside every step
            ("aten::cumsum", 50.0, 90.0), ("cudnn_convolution", 50.0, 90.0)]
    trace = Trace([("k", 0.0, 100.0)], host, (0.0, 100.0), 1e-4, 2)
    spans = [("eval.pass", None, main, 0.0, 40.0), ("eval.pass", None, main, 50.0, 90.0),
             ("eval.stack", "eval.pass", main, 80.0, 90.0),
             ("eval.pull", "eval.pass", main, 10.0, 15.0),
             ("eval.pass", None, other, 0.0, 100.0)]           # not the main thread
    ctx = _ctx(trace, program_trace.Window(spans, [], 2, main))
    # 80 us of passes less 2 + 15 (runtime calls, merged) + 4 (buffer request)
    assert program_trace.host_ms(ctx, "eval.pass") == pytest.approx(59e-3 / 2)
    # and less eval.pull's 10-15
    assert program_trace.host_ms(ctx, "eval.pass", ("eval.pull",)) == pytest.approx(
        54e-3 / 2)
    assert program_trace.host_ms(ctx, "train_step") is None


def test_window_sums_spans_and_counters():
    main = threading.main_thread().ident
    spans = [("eval.pass", None, main, 0.0, 4000.0), ("eval.pull", "eval.pass", main,
                                                      3000.0, 4000.0),
             ("eval.pass", None, 7, 0.0, 9000.0)]
    counts = [("sampler.kept", 7, 1.0, 100), ("sampler.kept", main, 2.0, 100),
              ("sampler.rejected", 7, 3.0, 5)]
    w = program_trace.Window(spans, counts, 2, main)
    assert w.ms_per_unit("eval.pass") == pytest.approx(2.0)
    assert w.ms_per_unit("eval.pull") == pytest.approx(0.5)
    assert w.ms_per_unit("train_step") is None
    assert w.share("sampler.rejected", "sampler.kept") == pytest.approx(2.5)
    assert w.share("sampler.starved", "sampler.batches") is None


def test_a_program_without_the_recorder_gives_none(monkeypatch):
    from knowledgegraphembedding_torch.utils import profiling

    monkeypatch.delattr(profiling, "records")
    trace = Trace([("k", 10.0, 30.0)], [], (0.0, 100.0), 1e-4, 2)
    ctx = _ctx(trace, None)
    del ctx.extra["program_trace"]
    for name in {n for c in CELLS for n in _program_metrics(c)}:
        assert spec.metric(spec.ROOT, name).read(ctx) is None, name
