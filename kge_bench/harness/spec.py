"""Everything the harness runs is found by name under the benchmark's folder.

- ``BENCHMARK.json`` at the checkout's root lists the cells
  (``<config>.<traffic>``) and the metrics;
- ``configs/<config>.json``: one model configuration and its graph;
- ``traffic/<traffic>.json``: one traffic mix; its ``kind`` names the
  runner ``kinds/<kind>.py``;
- ``limits/<cell>.json``: the limit of each number the cell's output check
  compares;
- ``metrics/<metric>.py``: one per-layer metric (``UNIT``, ``LAYER``,
  ``MOVES``, ``SOURCE`` and ``read(ctx)``);
- ``reference/models/<model>.py`` and ``counts/models/<model>.json``: the
  plain reference and the operation counts of one model family.

A cell, a mix or a metric that a later change adds is a new file and a new
entry in ``BENCHMARK.json``; no file of the harness changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from types import ModuleType
from typing import Optional

#: the checkout's root (the parent of the benchmark's folder)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FOLDER = "kge_bench"


def folder(root: str = ROOT) -> str:
    return os.path.join(root, FOLDER)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(known: {', '.join(c['name'] for c in bench['workloads'])})")


def config_entry(bench: dict, name: str) -> dict:
    for cfg in bench["configs"]:
        if cfg["name"] == name:
            return cfg
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_json(root: str, sub: str, name: str) -> dict:
    path = os.path.join(folder(root), sub, name + ".json")
    with open(path) as f:
        return json.load(f)


def load_config(root: str, bench: dict, name: str, overrides: Optional[dict] = None) -> dict:
    """The configuration as run: the file that BENCHMARK.json names for it,
    with ``overrides`` (tests shrink a configuration this way) merged in,
    the ``graph`` group key by key."""
    entry = config_entry(bench, name)
    with open(os.path.join(root, entry["file"])) as f:
        cfg = json.load(f)
    for key, value in (overrides or {}).items():
        if key == "graph":
            cfg["graph"] = {**cfg["graph"], **value}
        else:
            cfg[key] = value
    cfg["name"] = name
    return cfg


def load_module(path: str, name: str) -> ModuleType:
    """A module from its file, whatever its file name holds (metric names
    carry dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def kind(root: str, name: str) -> ModuleType:
    return load_module(os.path.join(folder(root), "kinds", name + ".py"),
                       f"kge_bench_kind_{name}")


def metric(root: str, name: str) -> ModuleType:
    module = load_module(os.path.join(folder(root), "metrics", name + ".py"),
                         "kge_bench_metric_" + name.replace(".", "_").replace("-", "_"))
    for attr in ("UNIT", "LAYER", "MOVES", "SOURCE", "read"):
        if not hasattr(module, attr):
            raise AttributeError(f"metrics/{name}.py lacks {attr}")
    return module


def reference_model(root: str, model: str) -> ModuleType:
    return load_module(os.path.join(folder(root), "reference", "models", model + ".py"),
                       f"kge_bench_reference_{model}")


def model_counts(root: str, model: str) -> dict:
    return load_json(root, os.path.join("counts", "models"), model)


def peaks(root: str) -> dict:
    return load_json(root, "counts", "peaks")


def end_to_end_of(bench: dict, cell: str) -> list:
    """The end-to-end metrics the cell reports: those without ``workloads``
    and those that list the cell."""
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer_of(bench: dict, cell: str) -> list:
    """The per-layer metrics the cell reports: those that list it, and those
    without ``workloads`` whose end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end_of(bench, cell)}
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif m["moves"] in reported:
            out.append(m)
    return out
