"""BENCHMARK.json keeps to the benchmark's contract, and every piece a cell
names is found by name: its configuration, traffic, limits, runner, metrics,
reference model and counts."""

import json
import os
import re

import pytest

from kge_bench.harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
#: the most cells a benchmark holds; a full check makes 2 + 14 runs a cell
MAX_CELLS = 24


@pytest.fixture(scope="module")
def bench(root):
    return spec.load_benchmark(root)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_paths(bench, root):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "kge_bench/run.py"]
    assert bench["paths"] == ["kge_bench"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * MAX_CELLS
    assert runs * (bench["run_seconds"] + 60) + MAX_CELLS * 180 + 1200 <= 43200
    assert os.path.getsize(os.path.join(root, "BENCHMARK.json")) <= 64 * 1024


def test_configs(bench, root):
    assert 1 <= len(bench["configs"]) <= 24
    used = {w["config"] for w in bench["workloads"]}
    for cfg in bench["configs"]:
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(cfg["name"]) and cfg["name"] in used
        assert _line(cfg["source"]) and _line(cfg["why"])
        assert cfg["file"].startswith("kge_bench/configs/")
        with open(os.path.join(root, cfg["file"])) as f:
            body = json.load(f)
        assert body["reduced"] == cfg["reduced"] and len(cfg["reduced"]) <= 16
        for key in cfg["reduced"]:  # never a width
            assert NAME.match(key) and not key.endswith(("_dim", "_rank"))
    assert len({c["file"] for c in bench["configs"]}) == len(bench["configs"])


def test_workloads(bench):
    cells = bench["workloads"]
    assert 1 <= len(cells) <= MAX_CELLS
    assert len({c["name"] for c in cells}) == len(cells)
    assert len({(c["config"], c["traffic"]) for c in cells}) == len(cells)
    for c in cells:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert c["name"] == f"{c['config']}.{c['traffic']}" and NAME.match(c["traffic"])
        assert c["chips"] == 1 and _line(c["why"])


def test_metrics(bench):
    names = set()
    cells = {c["name"] for c in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in bench["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert _line(m["layer"]) and m["moves"] in e2e


@pytest.mark.parametrize("cell", ["rotate_fb15k237.train", "rotate_fb15k237.eval",
                                  "distmult_fb15k237.train", "distmult_fb15k237.eval"])
def test_cell_reports_and_finds_its_pieces(bench, root, cell):
    w = spec.workload(bench, cell)
    cfg = spec.load_config(root, bench, w["config"])
    mix = spec.load_json(root, "traffic", w["traffic"])
    assert spec.kind(root, mix["kind"]).run
    limits = spec.load_json(root, "limits", cell)
    assert limits and all(v["limit"] >= 0 for v in limits.values())
    assert spec.reference_model(root, cfg["model"]).scores_all
    assert spec.model_counts(root, cfg["model"])["score_ops_per_element"] > 0
    reported = [m["name"] for m in spec.end_to_end_of(bench, cell)]
    assert "setup_s" in reported and len(reported) >= 2
    layer = spec.per_layer_of(bench, cell)
    assert layer
    for m in layer:
        assert m["moves"] in reported  # a metric's cells report what it moves
        module = spec.metric(root, m["name"])
        assert (module.UNIT, module.BETTER, module.LAYER, module.MOVES, module.SOURCE) == (
            m["unit"], m["better"], m["layer"], m["moves"], m["source"])


def test_every_file_under_paths_is_named_from_name_characters(root):
    for dirpath, dirnames, files in os.walk(os.path.join(root, "kge_bench")):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", ".cache")]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), root)
            assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel
