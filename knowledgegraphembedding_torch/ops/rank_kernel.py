"""Fused filtered-rank counting for the distance-family scorers.

Counterpart of ``knowledgegraphembedding_tpu/ops/pallas_rank.py``. The
evaluation hot loop (reference: codes/model.py §test_step ≈L332-390) scores
every entity as a corruption candidate. For RotatE and TransE the score
against candidate c is ``gamma - sum_i |L_i - C_i|`` (complex modulus for
RotatE), where L depends only on the (fixed entity, relation) pair. pRotatE
scores ``gamma - modulus * sum_i |sin(L_i - P_i)|`` over phases, in the
factored form ``|sin L_i cos P_i - cos L_i sin P_i|`` with the candidates'
sin/cos built once per evaluation. So the wrapper computes L once per batch
and ``rank_counts`` fuses score, filter mask, compare-with-true and count
over the whole table: nothing ``[B, E]``-shaped is written to device memory.

``rank_counts`` launches the hand-written CUDA kernel ``csrc/rank_counts.cu``
(which replaces ``pallas_rank.py::_rank_kernel`` and
``::_rank_kernel_protate``) for CUDA tensors and runs its plain PyTorch
version ``rank_counts_ref`` for CPU tensors. The kernel is
built with ``nvcc`` at first use into ``_build/`` and bound with ctypes.
What bounds it on an H100 is set out at the top of the CUDA source: by
bytes and data-sheet FLOPs the table read; the measured time points to
instruction issue (the IEEE sqrt sequence, shared-memory loads per element).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from ..config import ModelSpec
from ..models import scorers
from . import _nvcc

FAMILIES = ("RotatE", "TransE", "pRotatE")
_FAMILY_CODE = {"RotatE": 0, "TransE": 1, "pRotatE": 2}
#: families whose rows are two halves: RotatE re | im, pRotatE sin | cos
_TWO_HALVES = ("RotatE", "pRotatE")

SOURCE = os.path.join(_nvcc.CSRC, "rank_counts.cu")
# dynamic shared memory a block may use on Hopper, less the static counts
_MAX_SMEM = 232448 - 64
_KERNEL_ROWS = 8  # kRows in the CUDA source

_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile ``csrc/rank_counts.cu`` into ``_build/`` (once per source and
    flags, ``_nvcc.build``); return the library's path."""
    return _nvcc.build(SOURCE)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rank_counts_launch.argtypes = [
            ci, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ctypes.c_longlong,
            ctypes.c_float, ci, vp]
        lib.rank_counts_launch.restype = ci
        lib.rank_counts_error_string.argtypes = [ci]
        lib.rank_counts_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def distance_scores(left: torch.Tensor, cand: torch.Tensor, family: str,
                    gamma: float, modulus=None) -> torch.Tensor:
    """The kernel's per-candidate score in plain ops, over the last dim of
    broadcastable L and candidate rows:
      RotatE  ``gamma - sum_i |L_i - C_i|``, complex modulus of re | im
              halves, with the unguarded sqrt (evaluation takes no gradient);
      TransE  ``gamma - sum_i |L_i - C_i|``;
      pRotatE ``gamma - (sum_i |ls_i tc_i - lc_i ts_i|) * modulus`` over
              sin | cos halves of the L and candidate phases."""
    if family in _TWO_HALVES:
        half = left.shape[-1] // 2
        a, b = left[..., :half], left[..., half:]
        c, d = cand[..., :half], cand[..., half:]
        if family == "RotatE":
            dre, dim = a - c, b - d
            mag = torch.sqrt(dre * dre + dim * dim)
            return gamma - torch.sum(mag, dim=-1, dtype=torch.float32)
        acc = torch.sum(torch.abs(a * d - b * c), dim=-1, dtype=torch.float32)
        return gamma - acc * modulus
    if family == "TransE":
        return gamma - torch.sum(torch.abs(left - cand), dim=-1, dtype=torch.float32)
    raise ValueError(f"family {family!r} not in {FAMILIES}")


def rank_counts_ref(left, true_score, true_ids, table, mask, *, family: str,
                    gamma: float, E: int, modulus=None, chunk: int = 256) -> torch.Tensor:
    """Plain PyTorch version of the kernel: i32[B] beat counts, the same
    four predicates, candidates in chunks of ``chunk`` rows."""
    B = left.shape[0]
    count = torch.zeros(B, dtype=torch.int32, device=left.device)
    tid = true_ids.to(torch.int64)[:, None]
    for c0 in range(0, E, chunk):
        c1 = min(c0 + chunk, E)
        score = distance_scores(left[:, None, :], table[None, c0:c1], family, gamma,
                                modulus)
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
                    gamma: float, E: int, modulus=None, chunk: int = 256) -> torch.Tensor:
    """i64[B]: per row, the unfiltered candidates other than the true entity
    whose score lies within ``TIE_RTOL * max(1, |true|)`` of the true score.
    Two rankers that sum in different orders may disagree on exactly these,
    so it bounds how far their ranks of that row may differ."""
    count = torch.zeros(left.shape[0], dtype=torch.int64, device=left.device)
    tid = true_ids.to(torch.int64)[:, None]
    tol = TIE_RTOL * torch.clamp(true_score.abs(), min=1.0)[:, None]
    for c0 in range(0, E, chunk):
        c1 = min(c0 + chunk, E)
        score = distance_scores(left[:, None, :], table[None, c0:c1], family, gamma,
                                modulus)
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
                gamma: float, E: int, modulus=None) -> torch.Tensor:
    """i32[B] counts of candidates c < E that beat ``true_score`` (score
    strictly greater), are unfiltered (``mask[b, c] == 0``) and are not the
    true entity ``true_ids[b]``. The rank is 1 + count.

    left f32[B, D]; true_score f32[B]; true_ids i32[B]; table f32[>=E, D]
    (RotatE: re | im halves; pRotatE: sin | cos halves of the phases);
    mask bool/u8[B, W >= E], row-major; modulus f32[] (pRotatE only, read
    on the device). CUDA tensors launch the kernel; CPU tensors run
    ``rank_counts_ref``."""
    if family not in FAMILIES:
        raise ValueError(f"family {family!r} not in {FAMILIES}")
    if (modulus is None) != (family != "pRotatE"):
        raise ValueError("modulus is given for pRotatE and only for pRotatE")
    device = left.device
    operands = (("true_score", true_score), ("true_ids", true_ids),
                ("table", table), ("mask", mask))
    if modulus is not None:
        operands += (("modulus", modulus),)
    if device.type == "cpu":
        for name, t in operands:
            if t.device != device:
                raise ValueError(f"{name} is on {t.device}, expected {device}")
        return rank_counts_ref(left, true_score, true_ids, table, mask,
                               family=family, gamma=gamma, E=E, modulus=modulus)
    if device.type != "cuda":
        raise ValueError(f"rank_counts runs on CUDA or CPU tensors, not {device}")
    _check("left", left, (torch.float32,), 2, device)
    _check("true_score", true_score, (torch.float32,), 1, device)
    _check("true_ids", true_ids, (torch.int32,), 1, device)
    _check("table", table, (torch.float32,), 2, device)
    _check("mask", mask, (torch.bool, torch.uint8), 2, device)
    if modulus is not None:
        _check("modulus", modulus, (torch.float32,), 0, device)
    B, D = left.shape
    if table.shape[1] != D:
        raise ValueError(f"table width {table.shape[1]} != left width {D}")
    if not 0 < E <= table.shape[0]:
        raise ValueError(f"E={E} outside 1..{table.shape[0]} (table rows)")
    if true_score.shape[0] != B or true_ids.shape[0] != B or mask.shape[0] != B:
        raise ValueError("true_score, true_ids and mask must have B rows")
    if mask.shape[1] < E:
        raise ValueError(f"mask width {mask.shape[1]} < E={E}")
    if family in _TWO_HALVES and D % 2:
        raise ValueError(f"{family} rows need an even width, got {D}")
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
        true_ids.data_ptr(), table.data_ptr(), mask.data_ptr(),
        None if modulus is None else modulus.data_ptr(), out.data_ptr(),
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
    if name == "pRotatE":
        # phases: tail: L = ph + pr; head: |sin(ph + pr - pt)| = |sin(pt - pr - ph)|
        scale = spec.embedding_range / scorers.PI
        return (fixed / scale) + sign * (r / scale)
    if name == "RotatE":
        half = fixed.shape[-1] // 2
        re_f, im_f = fixed[..., :half], fixed[..., half:]
        phase = r / (spec.embedding_range / scorers.PI)
        re_r = torch.cos(phase)
        im_r = torch.sin(phase) * sign  # head-batch uses conj(r)
        re_l = re_f * re_r - im_f * im_r
        im_l = re_f * im_r + im_f * re_r
        return torch.cat([re_l, im_l], dim=-1)
    raise no_family(name)


def no_family(name: str) -> ValueError:
    return ValueError(
        f"{name} has no rank-kernel family (one of {FAMILIES}): bilinear models rank "
        "through dense matmul scoring (ops/matmul_scoring.py, eval.dense_ranks_window)")


class Ranker:
    """Ranks eval batches of one parameter set through ``rank_counts``.
    RotatE/TransE rank against the entity table in its JAX layout [E, de]
    (no padding, no copy). pRotatE ranks against a table built here once,
    [E, 2d] = sin | cos of every candidate phase (``table * pi/range``, the
    JAX ``_prep_sincos``), so its ranks hold only for the weights of this
    moment: build a new ranker after the weights change (``get_ranker``
    does)."""

    @torch.no_grad()
    def __init__(self, params, spec: ModelSpec):
        if spec.model_name not in FAMILIES:
            raise no_family(spec.model_name)
        self.spec = spec
        self.ent = params["entity_embedding"]
        self.rel = params["relation_embedding"]
        self.modulus = params.get("modulus")
        if spec.model_name == "pRotatE":
            phase = self.ent * (scorers.PI / spec.embedding_range)
            self.table = torch.cat([torch.sin(phase), torch.cos(phase)], dim=1)
        else:
            self.table = self.ent.contiguous()

    @torch.no_grad()
    def inputs(self, pos: torch.Tensor, mode: str):
        """The kernel's per-batch inputs for the positives ``pos``:
        (left f32[B, D], true_score f32[B], true_ids i32[B])."""
        pos = pos.to(torch.int64)
        fixed_ids = pos[:, 0] if mode == scorers.TAIL_BATCH else pos[:, 2]
        true_ids = pos[:, 0] if mode == scorers.HEAD_BATCH else pos[:, 2]
        left = left_from_rows(self.ent[fixed_ids], self.rel[pos[:, 1]], self.spec, mode)
        if self.spec.model_name == "pRotatE":
            left = torch.cat([torch.sin(left), torch.cos(left)], dim=-1)
        left = left.contiguous()
        # the true entity's score in the kernel's form (pallas_rank.true_scores;
        # for pRotatE the factored form on the prepared table, _ranks_jit)
        true_score = distance_scores(left, self.table[true_ids], self.spec.model_name,
                                     self.spec.gamma, self.modulus)
        return left, true_score.contiguous(), true_ids.to(torch.int32)

    def ranks(self, pos: torch.Tensor, filter_mask: torch.Tensor, mode: str):
        """i32[B] filtered ranks (1-based) of the true entities of ``pos``."""
        left, true_score, true_ids = self.inputs(pos, mode)
        counts = rank_counts(
            left, true_score, true_ids, self.table, filter_mask,
            family=self.spec.model_name, gamma=self.spec.gamma,
            E=self.spec.nentity, modulus=self.modulus)
        return counts + 1


# An evaluation ranks many batches against one parameter set, and a run
# evaluates the same weights more than once (valid, then test). Keep the last
# two rankers, keyed on each parameter's identity and version: training
# updates the tables in place, which bumps ``_version``, so a ranker (and
# pRotatE's sin/cos table) built from older weights is never used again. An
# entry whose tables have moved is dropped at the next lookup; each entry
# holds its params, so an id cannot be reused while the entry lives.
_RANKER_CACHE_MAX = 2
_ranker_cache: dict = {}


def _params_key(params):
    return tuple((k, id(v), v._version) for k, v in sorted(params.items()))


def get_ranker(params, spec: ModelSpec) -> Ranker:
    key = (_params_key(params), spec)
    ids = tuple(k[:2] for k in key[0])
    for old in [k for k in _ranker_cache
                if k != key and tuple(x[:2] for x in k[0]) == ids]:
        del _ranker_cache[old]  # the same tables at an older version
    got = _ranker_cache.get(key)
    if got is not None:
        return got[1]
    ranker = Ranker(params, spec)
    while len(_ranker_cache) >= _RANKER_CACHE_MAX:
        _ranker_cache.pop(next(iter(_ranker_cache)))
    _ranker_cache[key] = (dict(params), ranker)
    return ranker


def ranks_batch_kernel(params, spec: ModelSpec, pos, filter_mask, mode: str):
    """One-shot ranking of one batch (counterpart of
    ``pallas_rank.ranks_batch_pallas``)."""
    return Ranker(params, spec).ranks(pos, filter_mask, mode)
