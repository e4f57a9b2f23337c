"""--profile_dir on the port (knowledgegraphembedding_torch/utils/profiling.py
and the CLI's train loops) on the CPU: the per-step and the fused loop each
write one Chrome trace that parses, holds host events and a named span per
step or block and no device events, and the run's metrics equal those of
the same run without the profiler; trace(None) is a no-op, StepTimer names
a span, Throughput counts triples a second."""

import json
import os
import time

import pytest
import torch

from knowledgegraphembedding_torch import cli as t_cli
from knowledgegraphembedding_torch.utils import profiling

TRAIN = ["--do_train", "--do_valid", "--do_test", "--data_path", "synthetic:clustered",
         "--model", "RotatE", "-de", "-n", "4", "-b", "16", "-d", "8", "-g", "4.0", "-adv",
         "-lr", "0.01", "--max_steps", "24", "--log_steps", "8", "--valid_steps", "12",
         "--save_checkpoint_steps", "12", "--test_batch_size", "8", "--platform", "cpu"]
FLOWS = {"per-step": ([], "train_step", 24),
         # blocks of 4, and one of 1 at the decay (step 12): 7 of them
         "fused": (["--steps_per_dispatch", "4", "--sampler_backend", "device"],
                   "train_block", 7)}


def read_trace(prof_dir):
    files = [f for f in os.listdir(prof_dir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1, os.listdir(prof_dir)
    with open(os.path.join(prof_dir, files[0])) as f:
        return json.load(f)["traceEvents"]


@pytest.mark.parametrize("flow", list(FLOWS))
def test_profile_dir_writes_a_trace_and_keeps_the_metrics(tmp_path, flow):
    extra, span, count = FLOWS[flow]
    plain = t_cli.main(TRAIN + extra + ["-save", str(tmp_path / "plain")])
    prof = str(tmp_path / "prof")
    traced = t_cli.main(TRAIN + extra + ["-save", str(tmp_path / "traced"),
                                         "--profile_dir", prof])
    assert traced == plain
    events = read_trace(prof)
    spans = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == span]
    assert len(spans) == count
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert not any(e.get("cat") in ("kernel", "gpu_memcpy") for e in events)  # --platform cpu


def test_trace_none_is_a_no_op_and_step_timer_names_a_span(tmp_path):
    with profiling.trace(None):
        torch.ones(3).sum()
    with profiling.trace(str(tmp_path), torch.device("cpu")):
        with profiling.StepTimer("named_span"):
            torch.ones(3).sum()
    assert [e["name"] for e in read_trace(str(tmp_path))
            if e.get("cat") == "user_annotation"] == ["named_span"]


def test_throughput_counts_triples_a_second():
    meter = profiling.Throughput(batch_size=100)
    meter.tick(3)
    time.sleep(0.01)
    rate = meter.rate()
    assert 0 < rate <= 300 / 0.01
    meter.reset()
    assert meter.rate() == 0.0
