"""ctypes loader and builder for the native host sampler (``sampler.cpp``).

The port's counterpart of ``knowledgegraphembedding_tpu/native``. At first
use ``g++`` builds the source into the package's ``_build/`` directory
(named by a digest of the source and flags, so an edited source is rebuilt)
and the library is loaded with ctypes. ``available()`` is False when the
toolchain is missing or the build fails; callers then sample with numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "sampler.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
# no -march=native: the build directory may be shared by hosts of another ISA
_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libkge_sampler-{digest}.so")


def _build(path: str) -> bool:
    """g++ into a temporary name, then an atomic rename: a killed compiler
    never leaves a truncated library behind."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.unlink(tmp)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = _lib_path()
        if not os.path.exists(path) and not _build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _build_failed = True
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.kge_sample_negatives.argtypes = [
            i64p, ctypes.c_int64, i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_uint64, ctypes.POINTER(ctypes.c_int32), i64p]
        lib.kge_sample_negatives.restype = None
        lib.kge_openmp_threads.argtypes = []
        lib.kge_openmp_threads.restype = ctypes.c_int
        lib.kge_set_threads.argtypes = [ctypes.c_int]
        lib.kge_set_threads.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def openmp_threads() -> int:
    lib = _load()
    return int(lib.kge_openmp_threads()) if lib else 0


def set_threads(n: int) -> None:
    """Cap the sampler's OpenMP threads (the reference's -cpu flag)."""
    lib = _load()
    if lib is not None:
        lib.kge_set_threads(int(n))


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def sample_negatives(true_enc: np.ndarray, row_keys: np.ndarray, nentity: int,
                     n_neg: int, seed: int) -> Tuple[np.ndarray, int]:
    """(i32[B, n_neg] negatives, draws): per row b, the first n_neg uniform
    draws whose encoding ``row_keys[b] * nentity + id`` is not in the sorted
    ``true_enc`` (see sampler.cpp), and the candidates drawn over the batch;
    draws less B * n_neg were rejected as train-true."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native sampler library unavailable")
    true_enc = np.ascontiguousarray(true_enc, np.int64)
    row_keys = np.ascontiguousarray(row_keys, np.int64)
    out = np.empty((len(row_keys), n_neg), np.int32)
    draws = ctypes.c_int64(0)
    lib.kge_sample_negatives(
        _i64(true_enc), len(true_enc), _i64(row_keys), len(row_keys), nentity,
        n_neg, seed & (2**64 - 1), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(draws))
    return out, draws.value
