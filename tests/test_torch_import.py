"""The PyTorch port stands alone: importing it loads neither JAX nor the JAX
package, and no source file of the port (or chip_smoke.py) imports them."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "knowledgegraphembedding_torch")
FORBIDDEN = ("jax", "jaxlib", "knowledgegraphembedding_tpu")


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(os.path.relpath(p, ROOT) for p in out)


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import knowledgegraphembedding_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_loaded = int(proc.stdout.split()[0])
    assert n_loaded >= 15, proc.stdout  # every module really was imported


@pytest.mark.parametrize("relpath", _port_sources())
def test_source_imports_no_jax(relpath):
    with open(os.path.join(ROOT, relpath)) as f:
        tree = ast.parse(f.read(), relpath)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (relpath, node.lineno, name)
