"""Tracing on the port (knowledgegraphembedding_torch/utils/profiling.py and
the spans and counters of the CLI, the trainer, the samplers and the eval
driver) on the CPU.

--profile_dir: the per-step and the fused loop each write one Chrome trace
that parses, holds host events, a program span per step or block and no
device events, and the run's metrics equal those of the same run without
the profiler; trace(None) is a no-op.

The recorder: off, ``span`` and ``count`` return at once (the shared null
context, no record_function, no allocation, nothing recorded); under a
profiler session they record nesting, parents, threads (the prefetch
worker's too) and counter samples; the zero-length marks put a span on the
profiler's clock, around the ops it encloses; the marks are the only ranges
the program adds to a trace; the native sampler's draw count gives the
rejections a Python replay of its generator counts."""

import collections
import contextlib
import json
import os
import threading
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from knowledgegraphembedding_torch import cli as t_cli
from knowledgegraphembedding_torch import native as t_native
from knowledgegraphembedding_torch.config import ModelSpec, TrainSpec
from knowledgegraphembedding_torch.data.filterset import FilterSets
from knowledgegraphembedding_torch.data.synthetic import make_random_kg
from knowledgegraphembedding_torch.eval import split_ranks
from knowledgegraphembedding_torch.models import kge
from knowledgegraphembedding_torch.sampler import negative as t_neg
from knowledgegraphembedding_torch.train import Trainer
from knowledgegraphembedding_torch.utils import profiling

TRAIN = ["--do_train", "--do_valid", "--do_test", "--data_path", "synthetic:clustered",
         "--model", "RotatE", "-de", "-n", "4", "-b", "16", "-d", "8", "-g", "4.0", "-adv",
         "-lr", "0.01", "--max_steps", "24", "--log_steps", "8", "--valid_steps", "12",
         "--save_checkpoint_steps", "12", "--test_batch_size", "8", "--platform", "cpu"]
FLOWS = {"per-step": ([], "train_step", 24),
         # blocks of 4, and one of 1 at the decay (step 12): 7 of them
         "fused": (["--steps_per_dispatch", "4", "--sampler_backend", "device"],
                   "train_block", 7)}
#: every span name the package opens
PROGRAM_SPANS = {"train_step", "train_block", "train_step.forward", "train_step.backward",
                 "train_step.adam", "train_step.decay", "sampler.next", "sampler.queue_get",
                 "sampler.sample", "sampler.upload", "sampler.indices", "sampler.draw",
                 "eval.pass", "eval.stack", "eval.lookup", "eval.enqueue", "eval.capture",
                 "eval.pull", "eval.masks"}
M64 = 2**64 - 1


def read_trace(prof_dir):
    files = [f for f in os.listdir(prof_dir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1, os.listdir(prof_dir)
    with open(os.path.join(prof_dir, files[0])) as f:
        return json.load(f)["traceEvents"]


@pytest.fixture
def recorder():
    profiling.clear()
    yield profiling
    profiling.clear()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.mark.parametrize("flow", list(FLOWS))
def test_profile_dir_writes_a_trace_and_keeps_the_metrics(tmp_path, flow):
    extra, span, count = FLOWS[flow]
    plain = t_cli.main(TRAIN + extra + ["-save", str(tmp_path / "plain")])
    prof = str(tmp_path / "prof")
    traced = t_cli.main(TRAIN + extra + ["-save", str(tmp_path / "traced"),
                                         "--profile_dir", prof])
    assert traced == plain
    events = read_trace(prof)
    spans = [e for e in events if e.get("cat") == "program_span" and e.get("name") == span]
    assert len(spans) == count
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert not any(e.get("cat") in ("kernel", "gpu_memcpy") for e in events)  # --platform cpu


def test_profile_dir_writes_program_spans_and_counters_on_the_trace_clock(tmp_path):
    prof = str(tmp_path / "prof")
    t_cli.main(TRAIN + ["-save", str(tmp_path / "s"), "--profile_dir", prof])
    events = read_trace(prof)
    names = collections.Counter((e["tid"], e["name"]) for e in events
                                if e.get("cat") == "program_span")
    main = {k[1]: v for k, v in names.items() if k[0] == "MainThread"}
    worker = {k[1]: v for k, v in names.items() if k[0] != "MainThread"}
    assert main["train_step"] == main["train_step.forward"] == main["sampler.next"] == 24
    assert main["train_step.decay"] == 1
    assert main["eval.pass"] == main["eval.pull"] == 2  # Valid at steps 12 and 24
    # the prefetch worker samples up to its queue's depth (4) and one batch
    # ahead, before the session began too
    assert 24 - 5 <= worker["sampler.sample"] <= 24 + 5
    counters = {e["name"] for e in events if e.get("cat") == "program_counter"}
    # RotatE on the CPU scores its negatives by gather, on the chain: no
    # train_step.score_kernel, which counts the card's kernel path; and its
    # steps run eagerly: no train_step.replayed or .captured, which count
    # the card's graphs
    assert counters == {"sampler.batches", "sampler.starved", "sampler.kept",
                        "sampler.rejected", "train_step.gather_scored", "train_step.eager"}
    window = [e for e in events if e.get("cat") == "Trace"][0]
    lo, hi = window["ts"], window["ts"] + window["dur"]
    steps = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "program_span" and e["name"] == "train_step")
    assert lo <= steps[0][0] and steps[-1][1] <= hi
    assert all(a[1] <= b[0] for a, b in zip(steps, steps[1:]))
    threads = {e["tid"] for e in events if e.get("cat") == "program_span"}
    assert "MainThread" in threads and len(threads) == 2


def test_trace_none_is_a_no_op_and_step_timer_names_a_span(tmp_path, recorder):
    with profiling.trace(None):
        with profiling.span("named_span"):
            torch.ones(3).sum()
    assert profiling.records() == ([], [], [])
    with profiling.trace(str(tmp_path), torch.device("cpu")):
        with profiling.span("named_span"):
            torch.ones(3).sum()
    events = read_trace(str(tmp_path))
    assert [e["name"] for e in events if e.get("cat") == "program_span"] == ["named_span"]
    assert not [e for e in events if e.get("cat") == "user_annotation"]


def test_off_span_and_count_record_nothing_and_allocate_nothing(recorder, monkeypatch):
    def refuse(*_):
        raise AssertionError("a record_function call while tracing is off")

    monkeypatch.setattr(profiling, "_record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not profiling.enabled()
    assert profiling.span("a") is profiling.span("b") is profiling._NULL
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with profiling.span("train_step"):
                profiling.count("sampler.batches")
                profiling.count("sampler.kept", 4096)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == profiling.__file__ and d.size_diff > 0]
    assert not grown
    assert recorder.records() == ([], [], [])


def test_on_records_nesting_parents_threads_and_counters(recorder):
    ds = make_random_kg(nentity=40, nrelation=3, ntriples=300, n_valid=10, n_test=10, seed=2)
    it = t_neg.build_train_iterator(ds.train, ds.nentity, ds.nrelation, 8, 5, seed=1,
                                    prefetch_depth=2, backend="numpy")
    try:
        with cpu_profile():
            for _ in range(6):
                with profiling.span("train_step"):
                    with profiling.span("train_step.forward"):
                        next(it)
    finally:
        it.close()
    spans, counts, marks = recorder.records()
    main = threading.main_thread().ident
    mine = [s for s in spans if s.thread == main]
    assert [s.name for s in mine if s.parent is None] == ["train_step"] * 6
    assert {(s.name, s.parent) for s in mine} == {
        ("train_step", None), ("train_step.forward", "train_step"),
        ("sampler.next", "train_step.forward"), ("sampler.queue_get", "sampler.next")}
    for s in mine:
        assert s.start_ns <= s.end_ns
    # the prefetch worker samples on its own thread; the profiler does not
    # follow it, the recorder does
    worker = [s for s in spans if s.thread != main]
    pairs = {(s.name, s.parent) for s in worker}
    assert ("sampler.sample", "sampler.next") in pairs
    # a sample begun as the session began has no recorded parent
    assert pairs <= {("sampler.next", None), ("sampler.sample", "sampler.next"),
                     ("sampler.sample", None)}
    assert profiling.thread_name(worker[0].thread) != "MainThread"
    by_name = collections.defaultdict(list)
    for c in counts:
        by_name[c.name].append(c)
    assert sum(c.n for c in by_name["sampler.batches"]) == 6
    assert len(by_name["sampler.starved"]) == 6
    assert {c.n for c in by_name["sampler.starved"]} <= {0, 1}
    assert all(c.thread == main for c in by_name["sampler.batches"])
    # B n a batch; up to 3 (the queue's 2 and one waiting to be queued) were
    # sampled before the session began
    assert {c.n for c in by_name["sampler.kept"]} == {40} and len(by_name["sampler.kept"]) >= 3
    assert all(c.thread != main for c in by_name["sampler.kept"] + by_name["sampler.rejected"])
    # a mark for each top-level span: the main thread's 6 and each worker span's
    assert len(marks) == 6 + sum(s.parent is None for s in worker)


def test_span_encloses_its_ops_on_the_profiler_clock(recorder):
    a = torch.randn(192, 192)
    with cpu_profile() as prof:
        for _ in range(5):
            with profiling.span("outer"):
                torch.mm(a, a)
    events = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]
    offset = profiling.clock_offset_us(e for e in events if e[0].startswith(profiling.MARK))
    assert offset is not None
    spans = [s for s in recorder.records()[0] if s.name == "outer"]
    ops = sorted((s, e) for n, s, e in events if n == "aten::mm")
    assert len(spans) == len(ops) == 5
    for span, (start, end) in zip(sorted(spans, key=lambda s: s.start_ns), ops):
        lo, hi = span.start_ns / 1e3 + offset, span.end_ns / 1e3 + offset
        assert lo - 50 <= start and end <= hi + 50, (lo, start, end, hi)


def test_clock_offset_takes_the_bounds_every_mark_leaves():
    marks = [profiling.MarkRecord(0, 1000, 9000), profiling.MarkRecord(1, 20000, 21000)]
    # the trace's clock runs 5 us ahead; each range lies between its stamps
    events = [("kge.mark.0", 3.0 + 5, 4.0 + 5), ("kge.mark.1", 20.2 + 5, 20.8 + 5),
              ("aten::mm", 0.0, 1.0)]
    assert profiling.clock_offset_us(events, marks) == pytest.approx(5.0)
    assert profiling.clock_offset_us(events[2:], marks) is None


def _tiny_program():
    ds = make_random_kg(nentity=30, nrelation=3, ntriples=200, n_valid=10, n_test=12, seed=4)
    spec = ModelSpec(model_name="RotatE", nentity=ds.nentity, nrelation=ds.nrelation,
                     hidden_dim=4, gamma=4.0, double_entity_embedding=True)
    tspec = TrainSpec(negative_sample_size=4, batch_size=8)
    params = kge.init_params(spec, torch.Generator().manual_seed(0), device="cpu")
    filters = FilterSets.build(ds.train, ds.all_true_triples, ds.nentity, ds.nrelation)
    return ds, spec, tspec, params, filters


def test_the_only_ranges_the_program_adds_are_zero_length_marks(recorder):
    ds, spec, tspec, params, filters = _tiny_program()
    trainer = Trainer(spec, tspec, params, lr=0.01, warm_up_steps=1)
    it = t_neg.build_train_iterator(ds.train, ds.nentity, ds.nrelation, 8, 4, seed=0,
                                    prefetch_depth=0, backend="numpy")
    with cpu_profile() as prof:
        for _ in range(3):
            pos, neg, w, mode = next(it)
            trainer.one_step((torch.from_numpy(pos), torch.from_numpy(neg),
                              torch.from_numpy(w), mode))
        split_ranks(trainer.params, spec, ds.test, filters, test_batch_size=4)
    events = list(prof.events())
    assert not [e.name for e in events if e.name in PROGRAM_SPANS]
    marks = [e for e in events if e.name.startswith(profiling.MARK)]
    spans = recorder.records()[0]
    assert {s.name for s in spans} >= {"train_step", "train_step.adam", "train_step.decay",
                                       "sampler.next", "eval.pass", "eval.masks", "eval.pull"}
    assert len(marks) == sum(s.parent is None for s in spans) == 3 + 3 + 1
    for e in marks:
        assert not e.cpu_children and e.time_range.end - e.time_range.start < 1000


@pytest.mark.parametrize("profiled", [False, True], ids=["off", "on"])
def test_diverted_counts_collect_a_blocks_counts_off_the_store(recorder, profiled):
    """Inside ``diverted_counts`` this thread's counts go to its list, as
    ``(name, n)``, profiled or not, and never to the store; a nested block
    keeps its own; outside, counting is as before."""
    with contextlib.ExitStack() as stack:
        if profiled:
            stack.enter_context(cpu_profile())
        with profiling.diverted_counts() as outer:
            profiling.count("a")
            with profiling.diverted_counts() as inner:
                profiling.count("b", 3)
            other = threading.Thread(target=profiling.count, args=("c",))
            other.start()
            other.join()
            profiling.count("d", 2)
        profiling.count("e")
    assert outer == [("a", 1), ("d", 2)] and inner == [("b", 3)]
    stored = [(c.name, c.n) for c in recorder.records()[1]]
    assert stored == ([("c", 1), ("e", 1)] if profiled else [])


@pytest.mark.parametrize("model", ["RotatE", "TransE", "DistMult"])
def test_cpu_steps_run_eagerly_and_capture_nothing(recorder, model):
    """On the CPU every ``Trainer.one_step`` runs ``train_step`` eagerly and
    counts ``train_step.eager``; no graph is made or counted."""
    from knowledgegraphembedding_torch import cuda_graphs

    ds, _, tspec, _, _ = _tiny_program()
    spec = ModelSpec(model_name=model, nentity=ds.nentity, nrelation=ds.nrelation,
                     hidden_dim=4, gamma=4.0, double_entity_embedding=model == "RotatE")
    params = kge.init_params(spec, torch.Generator().manual_seed(0), device="cpu")
    trainer = Trainer(spec, tspec, params, lr=0.01, warm_up_steps=1)
    it = t_neg.build_train_iterator(ds.train, ds.nentity, ds.nrelation, 8, 4, seed=0,
                                    prefetch_depth=0, backend="numpy")
    tallies = (cuda_graphs.captures["step"], cuda_graphs.replays["step"])
    with cpu_profile():
        for _ in range(4):
            pos, neg, w, mode = next(it)
            trainer.one_step((torch.from_numpy(pos), torch.from_numpy(neg),
                              torch.from_numpy(w), mode))
    counts = collections.Counter()
    for c in recorder.records()[1]:
        counts[c.name] += c.n
    assert counts["train_step.eager"] == 4
    assert not counts["train_step.replayed"] and not counts["train_step.captured"]
    assert trainer._capturer is None
    assert (cuda_graphs.captures["step"], cuda_graphs.replays["step"]) == tallies


def _splitmix64(x):
    x = (x + 0x9E3779B97F4A7C15) & M64
    z = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
    return x, z ^ (z >> 31)


class _Xoshiro256:
    """sampler.cpp's generator (xoshiro256** seeded by splitmix64, Lemire's
    bounded draw) in Python integers."""

    def __init__(self, seed):
        self.s, x = [], seed
        for _ in range(4):
            x, z = _splitmix64(x)
            self.s.append(z)

    def next(self):
        s = self.s
        rotl = lambda v, k: ((v << k) | (v >> (64 - k))) & M64  # noqa: E731
        result = (rotl((s[1] * 5) & M64, 7) * 9) & M64
        t = (s[1] << 17) & M64
        s[2] ^= s[0]
        s[3] ^= s[1]
        s[1] ^= s[2]
        s[0] ^= s[3]
        s[2] ^= t
        s[3] = rotl(s[3], 45)
        return result

    def bounded(self, bound):
        m = self.next() * bound
        if (m & M64) < bound:
            floor = (2**64 - bound) % bound
            while (m & M64) < floor:
                m = self.next() * bound
        return m >> 64


def _replay(true_enc, keys, nentity, n, seed):
    """(negatives, rejected draws) of sampler.cpp's rows, drawn again."""
    true = set(true_enc.tolist())
    rows, rejected = [], 0
    for b, key in enumerate(keys.tolist()):
        rng = _Xoshiro256((seed * 0x9E3779B97F4A7C15 + b) & M64)
        row = []
        while len(row) < n:
            cand = rng.bounded(nentity)
            if key * nentity + cand in true:
                rejected += 1
            else:
                row.append(cand)
        rows.append(row)
    return np.asarray(rows, np.int32), rejected


def _native():
    if not t_native.available():
        pytest.skip("g++ is missing: the native sampler cannot be built")


def test_native_rejections_equal_a_python_replay_of_its_draws():
    _native()
    rng = np.random.default_rng(3)
    nentity, n = 50, 40
    keys = np.arange(8, dtype=np.int64)
    true_enc = np.unique(keys[:, None] * nentity + rng.integers(0, nentity, (8, 30)))
    for seed in (1, 2**63 - 5):
        neg, draws = t_native.sample_negatives(true_enc, keys, nentity, n, seed=seed)
        want, rejected = _replay(true_enc, keys, nentity, n, seed & M64)
        np.testing.assert_array_equal(neg, want)
        assert draws - neg.size == rejected > 0


@pytest.mark.parametrize("backend", ["native", "numpy"])
def test_sampler_counts_kept_and_rejected_draws(recorder, backend):
    if backend == "native":
        _native()
    ds = make_random_kg(nentity=20, nrelation=2, ntriples=300, n_valid=10, n_test=10, seed=5)
    args = (ds.train, ds.nentity, ds.nrelation, 16, 12, t_neg.TAIL_BATCH)
    sampler = t_neg.TrainSampler(*args, seed=9, backend=backend)
    with cpu_profile():
        neg = sampler.next_batch()[1]
    counts = {c.name: c.n for c in recorder.records()[1]}
    assert counts["sampler.kept"] == neg.size == 16 * 12
    if backend == "native":
        twin = t_neg.TrainSampler(*args, seed=9, backend=backend)
        keys = twin._row_keys(twin.triples[twin._next_indices()])
        want, rejected = _replay(twin._true_enc, keys, ds.nentity, 12,
                                 int(twin.rng.integers(0, 2**63)))
        np.testing.assert_array_equal(neg, want)
        assert counts["sampler.rejected"] == rejected
    else:
        assert counts["sampler.rejected"] >= 0
