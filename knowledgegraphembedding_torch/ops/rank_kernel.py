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
What bounds it on an H100, and its design (one pass over the table, a
register tile of 4 rows x 4 candidates a thread, width chunks staged with
cp.async, no width limit), are set out at the top of the CUDA source.
``launch_plan`` computes a launch's grid, tiles and shared memory once per
shape and SM count; the wrapper passes it to the C entry point.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple, Optional, Tuple

import torch

from ..config import ModelSpec
from ..models import scorers
from . import _nvcc

FAMILIES = ("RotatE", "TransE", "pRotatE")
_FAMILY_CODE = {"RotatE": 0, "TransE": 1, "pRotatE": 2}
#: families whose rows are two halves: RotatE re | im, pRotatE sin | cos
_TWO_HALVES = ("RotatE", "pRotatE")

SOURCE = os.path.join(_nvcc.CSRC, "rank_counts.cu")

# The kernel's compile-time shape (constants at the top of the CUDA source;
# the library's rank_counts_shape is checked against them when it loads)
_THREADS = 256      # threads a block
_MIN_BLOCKS = 2     # resident blocks per SM that the launch bound guarantees
_ROW_BLOCK = 16     # eval rows a block holds
_TILE = 16          # candidates a tile
_CHUNK = 64         # elements of each half staged per step
_STAGES = 4         # cp.async ring depth: this chunk and 3 ahead
_SPLIT = 16         # threads that split the width of one (row, candidate) tile
_REG_TILE = (4, 4)  # (rows, candidates) a thread accumulates
_PAD = {2: 4, 1: 8}  # floats after each staged line half, by halves a row
_SHAPE = (_THREADS, _MIN_BLOCKS, _ROW_BLOCK, _TILE, _CHUNK, _STAGES, _SPLIT) + _REG_TILE
#: (row, candidate, element) terms one thread scores per staged chunk
PAIR_ELEMENTS_PER_STEP = _REG_TILE[0] * _REG_TILE[1] * _CHUNK // _SPLIT
# Hopper: shared memory per SM, the most one block may take, and what the
# runtime reserves per resident block
_SMEM_PER_SM = 233472
_SMEM_PER_BLOCK = 232448
_SMEM_RESERVED = 1024
_MAX_THREADS_PER_SM = 2048

_lib: Optional[ctypes.CDLL] = None
_ready_devices: set = set()
_sm_counts: dict = {}


def build() -> str:
    """Compile ``csrc/rank_counts.cu`` into ``_build/`` (once per source and
    flags, ``_nvcc.build``); return the library's path."""
    return _nvcc.build(SOURCE)


def _library(device: torch.device) -> ctypes.CDLL:
    """The loaded library, its shape checked against ``_SHAPE``, with the
    shared-memory attribute set once on ``device``."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rank_counts_launch.argtypes = [
            ci, vp, vp, vp, vp, vp, vp, vp, vp, ci, ci, ci, ctypes.c_longlong,
            ctypes.c_float, ci, ci, ci, ci, ci, ci, vp]
        lib.rank_counts_launch.restype = ci
        lib.rank_counts_error_string.argtypes = [ci]
        lib.rank_counts_error_string.restype = ctypes.c_char_p
        lib.rank_counts_smem_bytes.argtypes = [ci]
        lib.rank_counts_smem_bytes.restype = ci
        lib.rank_counts_init.restype = ci
        lib.rank_counts_occupancy.argtypes = [ci, ci, ctypes.POINTER(ci)]
        lib.rank_counts_occupancy.restype = ci
        lib.rank_counts_sqrt.argtypes = [vp, vp, ctypes.c_longlong, vp]
        lib.rank_counts_sqrt.restype = ci
        shape = (ci * len(_SHAPE))()
        lib.rank_counts_shape(shape)
        if tuple(shape) != _SHAPE:
            raise RuntimeError(f"{SOURCE} is built with shape {tuple(shape)}, "
                               f"this module plans for {_SHAPE}")
        for family, code in _FAMILY_CODE.items():
            if lib.rank_counts_smem_bytes(code) != smem_bytes(family):
                raise RuntimeError(f"{family}: the library takes "
                                   f"{lib.rank_counts_smem_bytes(code)} bytes of shared "
                                   f"memory, the plan {smem_bytes(family)}")
        _lib = lib
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _ready_devices:
        with torch.cuda.device(index):
            _raise(_lib, _lib.rank_counts_init(), "rank_counts_init")
        _ready_devices.add(index)
    return _lib


def _raise(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: " + lib.rank_counts_error_string(err).decode())


def _halves(family: str) -> int:
    return 2 if family in _TWO_HALVES else 1


def smem_bytes(family: str) -> int:
    """Dynamic shared memory of one block: the ``_STAGES`` staging buffers
    (L rows and candidates, each half of ``_CHUNK`` floats and a pad) and
    the partial sums of the width split, which share the ring buffer of a
    tile's last chunk where they fit (two halves a row), else follow it."""
    halves = _halves(family)
    stage = (_ROW_BLOCK + _TILE) * halves * (_CHUNK + _PAD[halves])
    partials = _SPLIT * (_ROW_BLOCK * _TILE + 4)
    return 4 * (_STAGES * stage + (0 if stage >= partials else partials))


class LaunchPlan(NamedTuple):
    """How one ``rank_counts`` launch covers its B x E pairs and D floats."""
    family: str
    halves: int          # 2: re | im (sin | cos) halves; 1: TransE
    half: int            # elements a half holds (D / halves)
    chunks: int          # staged steps along the width per tile
    tiles: int           # candidate tiles of _TILE
    grid: Tuple[int, int]  # (row blocks of _ROW_BLOCK, candidate-tile slots)
    threads: int
    smem_bytes: int
    stages: int
    vec16: bool          # 16-byte copies (a half's width a multiple of 4)
    blocks_per_sm: int   # resident blocks per SM the plan counts on
    waves: float         # blocks / (SMs x blocks_per_sm)
    handed: bool         # tiles past the first handed out by a counter
    tiles_per_block: Tuple[int, int]  # fewest and most tiles a block walks
                                      # when they are not handed out


def _sm_count(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _sm_counts:
        _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return _sm_counts[index]


@functools.lru_cache(maxsize=256)
def launch_plan(family: str, B: int, D: int, E: int, sms: int,
                aligned: bool = True) -> LaunchPlan:
    """The launch of ``rank_counts`` for B rows, width D, E candidates on a
    card of ``sms`` SMs (``aligned``: L and the table start on 16 bytes).
    One wave: as many candidate-tile slots per row block as the resident
    blocks allow. Block y scores tile y first; where a tile has more chunks
    than the copies run ahead, the kernel hands out the rest from a counter
    per row block as blocks finish (``handed``), else each block walks its
    tiles with a grid stride, so blocks differ by at most one tile. Cached
    per shape and SM count."""
    if family not in FAMILIES:
        raise ValueError(f"family {family!r} not in {FAMILIES}")
    if B < 1 or D < 1 or E < 1:
        raise ValueError(f"B={B}, D={D}, E={E}: each must be at least 1")
    halves = _halves(family)
    if D % halves:
        raise ValueError(f"{family} rows need an even width, got {D}")
    half = D // halves
    smem = smem_bytes(family)
    if smem > _SMEM_PER_BLOCK:
        raise ValueError(f"{smem} bytes of shared memory exceed a block's {_SMEM_PER_BLOCK}")
    blocks_per_sm = min(_MIN_BLOCKS, _SMEM_PER_SM // (smem + _SMEM_RESERVED),
                        _MAX_THREADS_PER_SM // _THREADS)
    gx = -(-B // _ROW_BLOCK)
    tiles = -(-E // _TILE)
    gy = min(tiles, max(1, sms * blocks_per_sm // gx))
    chunks = -(-half // _CHUNK)
    return LaunchPlan(
        family=family, halves=halves, half=half, chunks=chunks, tiles=tiles,
        grid=(gx, gy), threads=_THREADS, smem_bytes=smem, stages=_STAGES,
        vec16=aligned and half % 4 == 0, blocks_per_sm=blocks_per_sm,
        waves=gx * gy / (sms * blocks_per_sm), handed=chunks >= _STAGES,
        tiles_per_block=(tiles // gy, -(-tiles // gy)))


def group_sqrt(x: torch.Tensor) -> torch.Tensor:
    """The rank kernel's square root (``sqrt_group`` in the CUDA source:
    sqrtf's fast path for 16 values at a time behind one range test) over a
    contiguous f32 tensor whose size is a multiple of 16, for holding it
    against ``torch.sqrt``; on the CPU, ``torch.sqrt``."""
    if x.device.type == "cpu":
        return torch.sqrt(x)
    _check("x", x, (torch.float32,), x.dim(), x.device)
    if x.numel() % 16:
        raise ValueError(f"{x.numel()} values: group_sqrt takes a multiple of 16")
    y = torch.empty_like(x)
    lib = _library(x.device)
    with torch.cuda.device(x.device):
        _raise(lib, lib.rank_counts_sqrt(x.data_ptr(), y.data_ptr(), x.numel(),
                                         torch.cuda.current_stream(x.device).cuda_stream),
               "rank_counts_sqrt")
    return y


def occupancy(family: str, vec16: bool = True, device="cuda") -> int:
    """Resident blocks per SM of one instantiation on ``device``, by the
    occupancy API (registers, shared memory and threads)."""
    device = torch.device(device)
    lib = _library(device)
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device):
        _raise(lib, lib.rank_counts_occupancy(_FAMILY_CODE[family], int(vec16),
                                              ctypes.byref(blocks)), "rank_counts_occupancy")
    return blocks.value


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


def synthetic_inputs(family: str, B: int, E: int, D: int, seed: int = 0, device="cpu"):
    """Random inputs of one launch at any shape, for holding the kernel
    against its plain version at the tile edges: (args, kwargs) of
    ``rank_counts``. L and the table uniform in [-1, 1); each row's true
    entity drawn from the E candidates and its true score the plain score
    against it, so counts spread over 0..E-1; about a tenth of the mask
    set; the mask one column wider than E."""
    gen = torch.Generator().manual_seed(seed)
    left = torch.rand(B, D, generator=gen) * 2 - 1
    table = torch.rand(E, D, generator=gen) * 2 - 1
    true_ids = torch.randint(0, E, (B,), generator=gen, dtype=torch.int32)
    mask = torch.rand(B, E + 1, generator=gen) < 0.1
    modulus = torch.tensor(0.75) if family == "pRotatE" else None
    true_score = distance_scores(left, table[true_ids.long()], family, 9.0, modulus)
    args = tuple(t.to(device).contiguous() for t in (left, true_score, true_ids, table, mask))
    kw = dict(family=family, gamma=9.0, E=E,
              modulus=None if modulus is None else modulus.to(device))
    return args, kw


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


def _check(name, t, dtypes, ndim, device, rows_strided=False):
    """Device, dtype and rank of one operand, and its layout: contiguous,
    or with ``rows_strided`` unit column stride and any row stride (a
    column window of a wider mask)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}, expected one of {dtypes}")
    if t.dim() != ndim:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {ndim} dims")
    if rows_strided:
        if t.shape[1] > 1 and t.stride(1) != 1:
            raise ValueError(f"{name} must have unit column stride, has strides {t.stride()}")
    elif not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def rank_counts(left, true_score, true_ids, table, mask, *, family: str,
                gamma: float, E: int, modulus=None) -> torch.Tensor:
    """i32[B] counts of candidates c < E that beat ``true_score`` (score
    strictly greater), are unfiltered (``mask[b, c] == 0``) and are not the
    true entity ``true_ids[b]``. The rank is 1 + count.

    left f32[B, D]; true_score f32[B]; true_ids i32[B]; table f32[>=E, D]
    (RotatE: re | im halves; pRotatE: sin | cos halves of the phases);
    mask bool/u8[B, W >= E], unit column stride and any row stride (a
    column window of a wider mask reaches the kernel as it is); modulus
    f32[] (pRotatE only, read
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
    _check("mask", mask, (torch.bool, torch.uint8), 2, device, rows_strided=True)
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
    if max(B, E, table.numel(), left.numel()) >= 2**31:
        raise ValueError("sizes must fit in int32")
    if B == 0:
        return torch.zeros(0, dtype=torch.int32, device=device)
    aligned = left.data_ptr() % 16 == 0 and table.data_ptr() % 16 == 0
    plan = launch_plan(family, B, D, E, _sm_count(device), aligned)
    # the counts and each row block's tile counter, zeroed at once
    zeroed = torch.zeros(B + plan.grid[0], dtype=torch.int32, device=device)
    out, handed = zeroed[:B], zeroed[B:]
    lib = _library(device)
    # inside torch.cuda.graph, the capture stream (its device is made the
    # current one): the launch is recorded into the graph, not run
    stream = torch.cuda.current_stream(device).cuda_stream
    args = (_FAMILY_CODE[family], left.data_ptr(), true_score.data_ptr(),
            true_ids.data_ptr(), table.data_ptr(), mask.data_ptr(),
            None if modulus is None else modulus.data_ptr(), out.data_ptr(),
            handed.data_ptr(), B, D, E, mask.stride(0), float(gamma), *plan.grid,
            plan.smem_bytes, plan.chunks, plan.tiles, int(plan.vec16), stream)
    if device.index is None or device.index == torch.cuda.current_device():
        err = lib.rank_counts_launch(*args)
        capturing = torch.cuda.is_current_stream_capturing()
    else:
        with torch.cuda.device(device):
            err = lib.rank_counts_launch(*args)
            capturing = torch.cuda.is_current_stream_capturing()
    _raise(lib, err, "rank_counts kernel launch")
    if capturing:
        rank_counts.captured += 1
    else:
        rank_counts.launches += 1
    return out


#: kernels that ran on the card (a graph's replay adds the launches its
#: capture recorded), and launches recorded into graphs, which ran none
rank_counts.launches = 0
rank_counts.captured = 0


def prepare(device: torch.device) -> None:
    """The one-time setup of a launch on ``device`` (the library loaded and
    its shared-memory attribute set, the SM count read), so that a launch
    inside a graph capture makes no call but the launch."""
    _library(device)
    _sm_count(device)


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
    does). ``graphs`` holds the CUDA graphs of the evaluation's scan chunks
    that read this ranker's tables (``eval._ChunkGraph``): they die with it."""

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
        self.graphs: dict = {}

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
# updates the tables in place, which bumps ``_version`` (a CUDA graph replay
# does not; ``cuda_graphs.Graph.replay`` bumps it after each replay, and
# any other write that bypasses the dispatcher must too), so a ranker (and
# pRotatE's sin/cos table) built from older weights is never used again. An
# entry whose tables have moved is dropped at the next lookup; each entry
# holds its params, so an id cannot be reused while the entry lives.
_RANKER_CACHE_MAX = 2
_ranker_cache: dict = {}


def _params_key(params):
    return tuple((k, id(v), v._version) for k, v in sorted(params.items()))


def cached_on_params(cache: dict, params, extra, build):
    """The value in ``cache`` for ``params`` at their current versions and
    ``extra`` (hashable), made by ``build()`` on a miss, under the rule of
    the ranker cache above: an entry of the same tensors at another version
    or ``extra`` is dropped, at most ``_RANKER_CACHE_MAX`` entries are kept
    (the oldest goes), and each entry holds its params."""
    key = (_params_key(params), extra)
    ids = tuple(k[:2] for k in key[0])
    for old in [k for k in cache if k != key and tuple(x[:2] for x in k[0]) == ids]:
        del cache[old]  # the same tables at an older version
    got = cache.get(key)
    if got is not None:
        return got[1]
    value = build()
    while len(cache) >= _RANKER_CACHE_MAX:
        cache.pop(next(iter(cache)))
    cache[key] = (dict(params), value)
    return value


def get_ranker(params, spec: ModelSpec) -> Ranker:
    return cached_on_params(_ranker_cache, params, spec, lambda: Ranker(params, spec))


def ranks_batch_kernel(params, spec: ModelSpec, pos, filter_mask, mode: str):
    """One-shot ranking of one batch (counterpart of
    ``pallas_rank.ranks_batch_pallas``)."""
    return Ranker(params, spec).ranks(pos, filter_mask, mode)
