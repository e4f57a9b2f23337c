"""Builds the port's CUDA sources into shared libraries with a plain C
interface, loaded with ctypes by the kernel wrappers.

``build(source)`` compiles one ``csrc/*.cu`` file with ``nvcc`` for
``sm_90a`` into the git-ignored ``_build/`` directory, named by a digest of
the source and the flags, so an unchanged source is compiled once per
checkout. The compiler's output (the ptxas register, stack and spill
report) is kept beside the library as ``<name>.log``. There is no nvcc on
a machine without the CUDA toolkit: building there raises.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# no -use_fast_math: the kernels keep IEEE sqrtf/sinf and uncontracted
# arithmetic where their plain versions need it
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def cuda_tool(name: str) -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``): on PATH,
    else under ``$CUDA_HOME/bin`` or ``/usr/local/cuda/bin``."""
    found = shutil.which(name)
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)
    if os.path.exists(cand):
        return cand
    raise RuntimeError(f"{name} not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path(source: str) -> str:
    """Where ``build(source)`` puts the library of this source and flags."""
    with open(source, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def build(source: str) -> str:
    """Compile ``source`` unless a library built from the same source and
    flags is already there; return the library's path."""
    so_path = library_path(source)
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cuda_tool("nvcc"), *NVCC_FLAGS, "-o", tmp, source],
                              capture_output=True, text=True)
        with open(so_path[:-3] + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so_path
