"""The PyTorch port stands alone: importing it loads neither JAX nor the JAX
package, and no source file of the port (or chip_smoke.py) imports them or,
for the native sources, names the JAX package's files."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "knowledgegraphembedding_torch")
FORBIDDEN = ("jax", "jaxlib", "knowledgegraphembedding_tpu")


#: modules of the training slice that the walk above must reach
TRAIN_MODULES = ("optim", "train", "ops/loss", "sampler/negative", "native/__init__")


def test_training_modules_are_scanned():
    scanned = set(_port_sources())
    for mod in TRAIN_MODULES:
        assert os.path.join("knowledgegraphembedding_torch", mod + ".py") in scanned, mod


@pytest.mark.parametrize("mod", ["ops/_nvcc", "ops/chain_probe", "ops/matmul_scoring",
                                 "utils/sass", "utils/vpu_probe", "vpu_roofline"])
def test_roofline_and_dense_modules_are_scanned(mod):
    assert os.path.join("knowledgegraphembedding_torch", mod + ".py") in _port_sources()


@pytest.mark.parametrize("mod", ["parallel/__init__", "parallel/sharding",
                                 "parallel/shard_map_step", "parallel/routed_step",
                                 "parallel/eval_sharded", "parallel/multihost"])
def test_mesh_modules_are_scanned(mod):
    """The multi-device modules (torch.distributed, never JAX) are among the
    sources whose imports are checked, and the import walk loads them."""
    assert os.path.join("knowledgegraphembedding_torch", mod + ".py") in _port_sources()


def test_native_sources_build_from_the_port_only():
    """The port builds its own copy of the sampler source into its own
    _build/ directory, never the JAX package's."""
    from knowledgegraphembedding_torch import native

    native_dir = os.path.join(PKG, "native")
    assert [f for f in os.listdir(native_dir) if f.endswith((".cpp", ".h"))] == ["sampler.cpp"]
    assert native._SRC == os.path.join(native_dir, "sampler.cpp")
    assert native.BUILD_DIR == os.path.join(PKG, "_build")


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
        "from knowledgegraphembedding_torch import native\n"
        "assert native.available() in (True, False)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_loaded = int(proc.stdout.split()[0])
    assert n_loaded >= 20, proc.stdout  # every module really was imported


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
