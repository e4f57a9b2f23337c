"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference and the counts load nothing of the measured package. Top-level
module names are compared whole: the measured package's name begins with
the JAX package's."""

import ast
import os
import subprocess
import sys

import pytest

from conftest import ROOT, TINY

FORBIDDEN = {"jax", "jaxlib", "flax", "knowledgegraphembedding_tpu"}
MEASURED = "knowledgegraphembedding_torch"


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def _sources(sub=""):
    base = os.path.join(ROOT, "kge_bench", sub)
    for dirpath, dirnames, files in os.walk(base):
        dirnames[:] = [d for d in dirnames if d not in ("__pycache__", ".cache")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_source_imports_jax_or_the_jax_package():
    found = {(p, m) for p in _sources() for m in _imports(p) if m in FORBIDDEN}
    assert not found


@pytest.mark.parametrize("sub", ["reference", "counts"])
def test_yardstick_imports_nothing_of_the_measured_package(sub):
    found = {(p, m) for p in _sources(sub) for m in _imports(p) if m == MEASURED}
    assert not found


def test_a_run_holds_no_forbidden_module():
    """A whole run in a fresh process (the chip's look skipped), then the
    harness's own check of ``sys.modules``."""
    code = (
        "import sys, time, torch; sys.path.insert(0, %r)\n"
        "from kge_bench import run\n"
        "run.run('rotate_fb15k237.eval', 7, 0.3, False, torch.device('cpu'),\n"
        "        overrides=%r, t0=time.perf_counter())\n"
        "print(run.forbidden_modules())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & %r))\n"
    ) % (ROOT, TINY["rotate_fb15k237"], FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split("\n")[-3:-1] == ["[]", "[]"]
