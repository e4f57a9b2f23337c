"""Fused filtered-rank counting for the distance-family scorers.

Counterpart of ``knowledgegraphembedding_tpu/ops/pallas_rank.py``. The
evaluation hot loop (reference: codes/model.py §test_step ≈L332-390) scores
every entity as a corruption candidate. For RotatE and TransE the score
against candidate c is ``gamma - sum_i |L_i - C_i|`` (complex modulus for
RotatE), where L depends only on the (fixed entity, relation) pair. So the
wrapper computes L once per batch and ``rank_counts`` fuses score, filter
mask, compare-with-true and count over the whole table: nothing
``[B, E]``-shaped is written to device memory.

``rank_counts`` launches the hand-written CUDA kernel ``csrc/rank_counts.cu``
(which replaces ``pallas_rank.py::_rank_kernel``) for CUDA tensors and runs
its plain PyTorch version ``rank_counts_ref`` for CPU tensors. The kernel is
built with ``nvcc`` at first use into ``_build/`` and bound with ctypes.
What bounds it on an H100 is set out at the top of the CUDA source: by
bytes and data-sheet FLOPs the table read; the measured time points to
instruction issue (the IEEE sqrt sequence, shared-memory loads per element).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import torch

from ..config import ModelSpec
from ..models import scorers

FAMILIES = ("RotatE", "TransE")
_FAMILY_CODE = {"RotatE": 0, "TransE": 1}

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "rank_counts.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
# no -use_fast_math: rank parity needs the correctly rounded sqrtf
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# dynamic shared memory a block may use on Hopper, less the static counts
_MAX_SMEM = 232448 - 64
_KERNEL_ROWS = 8  # kRows in the CUDA source

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the rank kernel cannot be built")


def build() -> str:
    """Compile ``csrc/rank_counts.cu`` into ``_build/`` unless a library
    built from the same source and flags is already there; return its path.
    The compiler's output (ptxas register and spill report) is kept beside
    it as ``<name>.log``."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    so_path = os.path.join(BUILD_DIR, f"librank_counts-{digest}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        with open(so_path[:-3] + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so_path


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rank_counts_launch.argtypes = [
            ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ctypes.c_longlong,
            ctypes.c_float, ci, vp]
        lib.rank_counts_launch.restype = ci
        lib.rank_counts_error_string.argtypes = [ci]
        lib.rank_counts_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def distance_scores(left: torch.Tensor, cand: torch.Tensor, family: str,
                    gamma: float) -> torch.Tensor:
    """``gamma - sum_i |L_i - C_i|`` over the last dim of broadcastable L and
    candidate rows (RotatE: complex modulus of re | im halves) — the
    kernel's per-candidate arithmetic in plain ops, with the unguarded sqrt
    (evaluation takes no gradient)."""
    if family == "RotatE":
        half = left.shape[-1] // 2
        dre = left[..., :half] - cand[..., :half]
        dim = left[..., half:] - cand[..., half:]
        mag = torch.sqrt(dre * dre + dim * dim)
        return gamma - torch.sum(mag, dim=-1, dtype=torch.float32)
    if family == "TransE":
        return gamma - torch.sum(torch.abs(left - cand), dim=-1, dtype=torch.float32)
    raise ValueError(f"family {family!r} not in {FAMILIES}")


def rank_counts_ref(left, true_score, true_ids, table, mask, *, family: str,
                    gamma: float, E: int, chunk: int = 256) -> torch.Tensor:
    """Plain PyTorch version of the kernel: i32[B] beat counts, the same
    four predicates, candidates in chunks of ``chunk`` rows."""
    B = left.shape[0]
    count = torch.zeros(B, dtype=torch.int32, device=left.device)
    tid = true_ids.to(torch.int64)[:, None]
    for c0 in range(0, E, chunk):
        c1 = min(c0 + chunk, E)
        score = distance_scores(left[:, None, :], table[None, c0:c1], family, gamma)
        ids = torch.arange(c0, c1, device=left.device)[None, :]
        beats = (
            (score > true_score[:, None])
            & (ids < E)
            & (mask[:, c0:c1] == 0)
            & (ids != tid)
        )
        count += torch.sum(beats, dim=1, dtype=torch.int32)
    return count


#: scores this close to the true score, relative to max(1, |true|), may
#: compare differently under two summation orders (kernel, plain, XLA)
TIE_RTOL = 1e-5


def near_tie_counts(left, true_score, true_ids, table, mask, *, family: str,
                    gamma: float, E: int, chunk: int = 256) -> torch.Tensor:
    """i64[B]: per row, the unfiltered candidates other than the true entity
    whose score lies within ``TIE_RTOL * max(1, |true|)`` of the true score.
    Two rankers that sum in different orders may disagree on exactly these,
    so it bounds how far their ranks of that row may differ."""
    count = torch.zeros(left.shape[0], dtype=torch.int64, device=left.device)
    tid = true_ids.to(torch.int64)[:, None]
    tol = TIE_RTOL * torch.clamp(true_score.abs(), min=1.0)[:, None]
    for c0 in range(0, E, chunk):
        c1 = min(c0 + chunk, E)
        score = distance_scores(left[:, None, :], table[None, c0:c1], family, gamma)
        ids = torch.arange(c0, c1, device=left.device)[None, :]
        near = ((score - true_score[:, None]).abs() <= tol) & (mask[:, c0:c1] == 0) & (ids != tid)
        count += near.sum(dim=1)
    return count


def _check(name, t, dtypes, ndim, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def rank_counts(left, true_score, true_ids, table, mask, *, family: str,
                gamma: float, E: int) -> torch.Tensor:
    """i32[B] counts of candidates c < E that beat ``true_score`` (score
    strictly greater), are unfiltered (``mask[b, c] == 0``) and are not the
    true entity ``true_ids[b]``. The rank is 1 + count.

    left f32[B, D]; true_score f32[B]; true_ids i32[B]; table f32[>=E, D]
    (RotatE: re | im halves); mask bool/u8[B, W >= E], row-major.
    CUDA tensors launch the kernel; CPU tensors run ``rank_counts_ref``."""
    if family not in FAMILIES:
        raise ValueError(f"family {family!r} not in {FAMILIES}")
    device = left.device
    if device.type == "cpu":
        for name, t in (("true_score", true_score), ("true_ids", true_ids),
                        ("table", table), ("mask", mask)):
            if t.device != device:
                raise ValueError(f"{name} is on {t.device}, expected {device}")
        return rank_counts_ref(left, true_score, true_ids, table, mask,
                               family=family, gamma=gamma, E=E)
    if device.type != "cuda":
        raise ValueError(f"rank_counts runs on CUDA or CPU tensors, not {device}")
    _check("left", left, (torch.float32,), 2, device)
    _check("true_score", true_score, (torch.float32,), 1, device)
    _check("true_ids", true_ids, (torch.int32,), 1, device)
    _check("table", table, (torch.float32,), 2, device)
    _check("mask", mask, (torch.bool, torch.uint8), 2, device)
    B, D = left.shape
    if table.shape[1] != D:
        raise ValueError(f"table width {table.shape[1]} != left width {D}")
    if not 0 < E <= table.shape[0]:
        raise ValueError(f"E={E} outside 1..{table.shape[0]} (table rows)")
    if true_score.shape[0] != B or true_ids.shape[0] != B or mask.shape[0] != B:
        raise ValueError("true_score, true_ids and mask must have B rows")
    if mask.shape[1] < E:
        raise ValueError(f"mask width {mask.shape[1]} < E={E}")
    if family == "RotatE" and D % 2:
        raise ValueError(f"RotatE rows need an even width, got {D}")
    if _KERNEL_ROWS * D * 4 > _MAX_SMEM:
        raise ValueError(f"width {D} exceeds the kernel's shared-memory budget")
    if max(B, E, table.numel()) >= 2**31:
        raise ValueError("sizes must fit in int32")
    out = torch.zeros(B, dtype=torch.int32, device=device)
    if B == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.rank_counts_launch(
        _FAMILY_CODE[family], left.data_ptr(), true_score.data_ptr(),
        true_ids.data_ptr(), table.data_ptr(), mask.data_ptr(), out.data_ptr(),
        B, D, E, mask.stride(0), float(gamma), device.index or 0, stream)
    if err != 0:
        raise RuntimeError("rank_counts kernel launch failed: "
                           + lib.rank_counts_error_string(err).decode())
    rank_counts.launches += 1
    return out


rank_counts.launches = 0


def left_from_rows(fixed, r, spec: ModelSpec, mode: str):
    """L rows from gathered fixed-entity rows [B, de] and relation rows
    [B, dr] (tail-batch: fixed = heads; head-batch: fixed = tails)."""
    name = spec.model_name
    sign = 1.0 if mode == scorers.TAIL_BATCH else -1.0
    if name == "TransE":
        # tail: L = h + r;  head: |h + r - t| = |t - r - h| -> L = t - r
        return fixed + sign * r
    if name == "RotatE":
        half = fixed.shape[-1] // 2
        re_f, im_f = fixed[..., :half], fixed[..., half:]
        phase = r / (spec.embedding_range / scorers.PI)
        re_r = torch.cos(phase)
        im_r = torch.sin(phase) * sign  # head-batch uses conj(r)
        re_l = re_f * re_r - im_f * im_r
        im_l = re_f * im_r + im_f * re_r
        return torch.cat([re_l, im_l], dim=-1)
    raise unported(name)


def unported(name: str) -> NotImplementedError:
    if name == "pRotatE":
        return NotImplementedError(
            "pRotatE ranking needs the factorized-trig kernel, not ported yet "
            "(ROADMAP Queue 2, K3)")
    return NotImplementedError(
        f"{name} ranking needs dense matmul scoring, not ported yet "
        "(ROADMAP Queue 1, item 9)")


class Ranker:
    """Ranks eval batches of one parameter set through ``rank_counts``.
    The table keeps its JAX layout [E, de]: the kernel needs no padding."""

    def __init__(self, params, spec: ModelSpec):
        if spec.model_name not in FAMILIES:
            raise unported(spec.model_name)
        self.spec = spec
        self.table = params["entity_embedding"].contiguous()
        self.rel = params["relation_embedding"]

    def inputs(self, pos: torch.Tensor, mode: str):
        """The kernel's per-batch inputs for the positives ``pos``:
        (left f32[B, de], true_score f32[B], true_ids i32[B])."""
        pos = pos.to(torch.int64)
        fixed_ids = pos[:, 0] if mode == scorers.TAIL_BATCH else pos[:, 2]
        true_ids = pos[:, 0] if mode == scorers.HEAD_BATCH else pos[:, 2]
        left = left_from_rows(self.table[fixed_ids], self.rel[pos[:, 1]],
                              self.spec, mode).contiguous()
        # the true entity's score in the kernel's form (pallas_rank.true_scores)
        true_score = distance_scores(left, self.table[true_ids], self.spec.model_name,
                                     self.spec.gamma)
        return left, true_score.contiguous(), true_ids.to(torch.int32)

    def ranks(self, pos: torch.Tensor, filter_mask: torch.Tensor, mode: str):
        """i32[B] filtered ranks (1-based) of the true entities of ``pos``."""
        left, true_score, true_ids = self.inputs(pos, mode)
        counts = rank_counts(
            left, true_score, true_ids, self.table, filter_mask,
            family=self.spec.model_name, gamma=self.spec.gamma,
            E=self.spec.nentity)
        return counts + 1


# test_step runs several times against the same params (valid, then test);
# keep the last two rankers, keyed on the table's identity. Each entry holds
# its table, so at most two tables stay alive through the cache.
_RANKER_CACHE_MAX = 2
_ranker_cache: dict = {}


def get_ranker(params, spec: ModelSpec) -> Ranker:
    table = params["entity_embedding"]
    key = (id(table), spec)
    got = _ranker_cache.get(key)
    if got is not None and got[0] is table:
        return got[1]
    ranker = Ranker(params, spec)
    while len(_ranker_cache) >= _RANKER_CACHE_MAX:
        _ranker_cache.pop(next(iter(_ranker_cache)))
    _ranker_cache[key] = (table, ranker)
    return ranker


def ranks_batch_kernel(params, spec: ModelSpec, pos, filter_mask, mode: str):
    """One-shot ranking of one batch (counterpart of
    ``pallas_rank.ranks_batch_pallas``)."""
    return Ranker(params, spec).ranks(pos, filter_mask, mode)
