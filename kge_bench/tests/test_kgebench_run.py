"""Whole runs on the CPU at a tiny size, the chip's look skipped: a sound
run is correct; each fault a cell can have, planted under the timed path,
makes it not correct; the bfloat16 control fails; a cell, a traffic mix and
a metric added as new files run with no edit to a file of the harness."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import CELLS, ROOT, TINY, tiny_run
from kge_bench import faults


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = tiny_run(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) >= {"setup_s"} and len(r["metrics"]) == 2
    assert [k for k in r if k not in ("readings", "marks")][-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_per_layer_metrics(cell):
    r = tiny_run(cell, trace=True)
    assert r["correct"]
    assert "setup_s" not in r["metrics"] and r["metrics"]
    assert r["device"]["window_s"] > 0 and "breakdown" in r
    assert all(isinstance(v["value"], float) for v in r["metrics"].values())


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in faults.FAULTS[c.split(".")[1]]])
def test_planted_fault_is_not_correct(cell, fault):
    r = tiny_run(cell, plant=fault)
    assert not r["correct"], r["checks"]


def test_rotate_train_control_is_not_correct():
    """The program's own bfloat16 path, the control of a float32 config."""
    over = dict(TINY["rotate_fb15k237"], precision="bf16")
    import time

    import torch

    from kge_bench import run

    r = run.run("rotate_fb15k237.train", 5, 0.3, False, torch.device("cpu"),
                overrides=over, t0=time.perf_counter())
    assert not r["correct"], r["checks"]


def test_rotate_eval_control_reads_over_the_limit():
    r = tiny_run("rotate_fb15k237.eval", controls=True)
    assert r["correct"]
    assert r["readings"]["control.rank_gap"] > r["checks"]["rank_gap"]["limit"]


def test_new_cell_mix_and_metric_are_found_by_name(tmp_path):
    """A copy of the benchmark gains a configuration, a traffic mix, a limit
    file and a metric as new files, and entries in BENCHMARK.json; the run
    finds them all, and no file of the harness changed."""
    shutil.copytree(os.path.join(ROOT, "kge_bench"), tmp_path / "kge_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache", "tests"))
    before = {p: open(p, "rb").read() for p in _files(tmp_path / "kge_bench")}
    base = tmp_path / "kge_bench"
    cfg = json.load(open(base / "configs" / "distmult_fb15k237.json"))
    cfg.update(TINY["distmult_fb15k237"], graph={**cfg["graph"],
                                                 **TINY["distmult_fb15k237"]["graph"]})
    json.dump(cfg, open(base / "configs" / "tiny_distmult.json", "w"))
    json.dump({"kind": "eval", "why": "valid split", "split": "valid", "warmup_passes": 1,
               "trace_passes": 1, "check_queries": 64},
              open(base / "traffic" / "eval_valid.json", "w"))
    json.dump({"rank_gap": {"limit": 6e-07}, "shape_faults": {"limit": 0}},
              open(base / "limits" / "tiny_distmult.eval_valid.json", "w"))
    (base / "metrics" / "eval.passes.py").write_text(
        'UNIT = "passes"\nBETTER = "higher"\nLAYER = "whole eval pass"\n'
        'MOVES = "eval_queries_per_s"\nSOURCE = "host_clock"\n\n\n'
        'def read(ctx):\n    return float(ctx.window["units"])\n')
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    bench["configs"].append({"name": "tiny_distmult", "source": "a test",
                             "file": "kge_bench/configs/tiny_distmult.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny_distmult.eval_valid", "config": "tiny_distmult",
                               "traffic": "eval_valid", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "eval_queries_per_s":
            m["workloads"].append("tiny_distmult.eval_valid")
    bench["per_layer"].append({"name": "eval.passes", "unit": "passes", "better": "higher",
                               "source": "host_clock", "layer": "whole eval pass",
                               "moves": "eval_queries_per_s",
                               "workloads": ["tiny_distmult.eval_valid"]})
    json.dump(bench, open(tmp_path / "BENCHMARK.json", "w"))
    code = (
        "import json, sys, time, torch\n"
        "sys.path[:0] = [%r, %r]\n"
        "from kge_bench import run\n"
        "assert run.__file__.startswith(%r)\n"
        "r = run.run('tiny_distmult.eval_valid', 3, 0.3, True, torch.device('cpu'),\n"
        "            t0=time.perf_counter())\n"
        "print(json.dumps({k: r[k] for k in ('correct', 'metrics')}))\n"
    ) % (str(tmp_path), ROOT, str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] and r["metrics"]["eval.passes"]["value"] >= 1
    assert "eval.other_device_ms" not in r["metrics"]  # no device trace on the CPU
    for p, body in before.items():
        assert open(p, "rb").read() == body, p


def _files(base):
    for dirpath, dirnames, files in os.walk(base):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for f in files:
            yield os.path.join(dirpath, f)
