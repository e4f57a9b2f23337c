"""RotatE's negative scores against per-row gathered rows, forward and
backward, as hand-written CUDA kernels.

Replaces no TPU kernel: the JAX package's train step leaves this chain to
XLA. In the port, ``models/scorers.py::rotate`` on ``ent[neg]`` builds every
``[B, n, 2d]`` intermediate in device memory and autograd walks back over
them; here the same function reads each gathered row straight from the
table, once in the forward and once in the backward, and writes only the
``[B, n]`` scores and the gradients.

Both modes reduce to one form. With ``q[b]`` the per-row query (re | im
halves; tail-batch ``h∘r``, head-batch ``conj(r)∘t``, computed by ``query``
in plain torch with the chain's association) and ``x = table[neg[b, j]]``:

    score[b, j] = gamma - sum_k sqrt(max(re_k^2 + im_k^2, 1e-30)),
    (re, im) = q[b] - x.

``negative_scores`` launches the kernels of ``csrc/rotate_score.cu`` for
CUDA tensors (an autograd Function: the backward returns ``d q`` and the
dense ``[E, 2d]`` gradient of the table that the chain's index_select
gives) and runs the plain twin ``negative_scores_ref`` for CPU tensors.
Each element rounds as the chain rounds it; only the order of the sums
differs, and that order is fixed, so the gradients repeat bit for bit. The
backward sorts the ``B n`` occurrences by entity with ``torch.sort``
(stable) and reads nothing on the host, so a CUDA graph captures it.

``takes`` is the train step's route: RotatE, a plain f32 CUDA table, no
bf16, per-row ``[B, n]`` negatives. Every other case keeps the chain.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from ..config import ModelSpec
from ..models import kge, scorers
from . import _nvcc
from .rank_kernel import _check

SOURCE = os.path.join(_nvcc.CSRC, "rotate_score.cu")
#: the chain's clamp of the squared modulus
FLOOR = 1e-30

_lib: Optional[ctypes.CDLL] = None


def build() -> str:
    """Compile ``csrc/rotate_score.cu`` into ``_build/`` (once per source and
    flags, ``_nvcc.build``); return the library's path."""
    return _nvcc.build(SOURCE)


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.rotate_score_forward.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ctypes.c_float, vp]
        lib.rotate_score_grad_query.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
        lib.rotate_score_offsets.argtypes = [vp, ci, ci, vp, vp]
        lib.rotate_score_grad_table.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, vp]
        for fn in (lib.rotate_score_forward, lib.rotate_score_grad_query,
                   lib.rotate_score_offsets, lib.rotate_score_grad_table):
            fn.restype = ci
        lib.rotate_score_error_string.argtypes = [ci]
        lib.rotate_score_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(device: torch.device, what: str, fn, *args) -> None:
    """One launch on ``device``'s current stream (inside a capture, the
    capture stream: the launch is recorded, not run); raises on its error
    code."""
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} failed: " + _lib.rotate_score_error_string(err).decode())
    if torch.cuda.is_current_stream_capturing():
        negative_scores.captured += 1
    else:
        negative_scores.launches += 1


def query(fixed: torch.Tensor, r: torch.Tensor, embedding_range: float, mode: str):
    """q [B, 2d] from the fixed side's rows [B, 2d] (tail-batch: heads;
    head-batch: tails) and relation rows [B, d], with the chain's
    association (``scorers.rotate``): tail ``re_h re_r - im_h im_r``,
    ``re_h im_r + im_h re_r``; head ``re_r re_t + im_r im_t``,
    ``re_r im_t - im_r re_t``."""
    re_f, im_f = scorers._split2(fixed)
    phase_r = r / (embedding_range / scorers.PI)
    re_r = torch.cos(phase_r)
    im_r = torch.sin(phase_r)
    if mode == scorers.HEAD_BATCH:
        re_q = re_r * re_f + im_r * im_f
        im_q = re_r * im_f - im_r * re_f
    elif mode == scorers.TAIL_BATCH:
        re_q = re_f * re_r - im_f * im_r
        im_q = re_f * im_r + im_f * re_r
    else:
        raise ValueError(f"mode {mode} has no negatives")
    return torch.cat([re_q, im_q], dim=-1)


def negative_scores_ref(q: torch.Tensor, table: torch.Tensor, neg: torch.Tensor,
                        gamma: float) -> torch.Tensor:
    """The plain twin: the chain's arithmetic on ``table[neg]`` with
    autograd, [B, n] scores in the table's dtype (f32 sums at least)."""
    half = q.shape[-1] // 2
    x = table[neg.long()]  # [B, n, 2d]
    re = q[:, None, :half] - x[..., :half]
    im = q[:, None, half:] - x[..., half:]
    sq = re * re + im * im
    mag = torch.sqrt(torch.clamp(sq, min=FLOOR))
    return gamma - torch.sum(mag, dim=-1, dtype=scorers._acc(mag))


class _Score(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, table, neg, gamma):
        B, n = neg.shape
        out = torch.empty((B, n), dtype=torch.float32, device=q.device)
        ctx.save_for_backward(q, table, neg)
        if out.numel():
            lib = _library()
            _launch(q.device, "rotate_score_forward", lib.rotate_score_forward,
                    q.data_ptr(), table.data_ptr(), neg.data_ptr(), out.data_ptr(), B, n,
                    q.shape[1] // 2, table.shape[0], float(gamma))
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        q, table, neg = ctx.saved_tensors
        want_q, want_table = ctx.needs_input_grad[:2]
        if not grad.numel():
            return (torch.zeros_like(q) if want_q else None,
                    torch.zeros_like(table) if want_table else None, None, None)
        grad = grad.contiguous()
        (B, n), half, E = neg.shape, q.shape[1] // 2, table.shape[0]
        lib, dev = _library(), q.device
        grad_q = grad_table = None
        if want_q:
            grad_q = torch.empty_like(q)
            _launch(dev, "rotate_score_grad_query", lib.rotate_score_grad_query,
                    q.data_ptr(), table.data_ptr(), neg.data_ptr(), grad.data_ptr(),
                    grad_q.data_ptr(), B, n, half, E)
        if want_table:
            # the occurrences b n + j by entity, each entity's in ascending order
            keys, order = torch.sort(neg.reshape(-1), stable=True)
            offsets = torch.empty(E + 1, dtype=torch.int32, device=dev)
            _launch(dev, "rotate_score_offsets", lib.rotate_score_offsets,
                    keys.data_ptr(), keys.numel(), E, offsets.data_ptr())
            grad_table = torch.empty_like(table)
            _launch(dev, "rotate_score_grad_table", lib.rotate_score_grad_table,
                    q.data_ptr(), table.data_ptr(), order.data_ptr(), offsets.data_ptr(),
                    grad.data_ptr(), grad_table.data_ptr(), n, half, E)
        return grad_q, grad_table, None, None


def negative_scores(q: torch.Tensor, table: torch.Tensor, neg: torch.Tensor,
                    gamma: float) -> torch.Tensor:
    """f32 [B, n] scores of ``q`` f32 [B, 2d] against ``table[neg]``: table
    f32 [E, 2d], neg i32 or i64 [B, n] (i64 is narrowed to i32 on the
    device: its values must lie in [0, E); one outside gives a NaN score
    and no gradient). All contiguous. Differentiable in ``q`` and
    ``table``. CUDA tensors launch the kernels; CPU tensors run
    ``negative_scores_ref``."""
    device = q.device
    if device.type == "cpu":
        for name, t in (("table", table), ("neg", neg)):
            if t.device != device:
                raise ValueError(f"{name} is on {t.device}, expected {device}")
        return negative_scores_ref(q, table, neg, gamma)
    if device.type != "cuda":
        raise ValueError(f"negative_scores runs on CUDA or CPU tensors, not {device}")
    _check("q", q, (torch.float32,), 2, device)
    _check("table", table, (torch.float32,), 2, device)
    _check("neg", neg, (torch.int32, torch.int64), 2, device)
    if q.shape[1] % 2 or table.shape[1] != q.shape[1] or neg.shape[0] != q.shape[0]:
        raise ValueError(f"shapes q {tuple(q.shape)}, table {tuple(table.shape)}, neg "
                         f"{tuple(neg.shape)}: expected [B, 2d], [E, 2d], [B, n]")
    if max(table.numel(), q.numel(), neg.numel()) >= 2**31:
        raise ValueError("sizes must fit in int32")
    if neg.dtype == torch.int64:
        neg = neg.to(torch.int32)
    return _Score.apply(q, table, neg, gamma)


#: the library's kernels that ran on the card (a graph's replay runs what
#: its capture recorded), and launches recorded into graphs, which ran none
negative_scores.launches = 0
negative_scores.captured = 0


def takes(spec: ModelSpec, params: kge.Params, pos: torch.Tensor, neg: torch.Tensor,
          compute_dtype: Optional[torch.dtype]) -> bool:
    """Whether a train step's negative scores go through the kernels: RotatE,
    the entity table a plain ``torch.Tensor`` (not a subclass such as a
    DTensor) on CUDA in f32, no bf16 compute, and per-row ``[B, n]``
    negatives (not one shared row)."""
    ent = params["entity_embedding"]
    return (spec.model_name == "RotatE" and compute_dtype is None
            and type(ent) is torch.Tensor and ent.is_cuda
            and ent.dtype == torch.float32
            and neg.dim() == 2 and neg.shape[0] == pos.shape[0])


def rotate_negative_scores(params: kge.Params, spec: ModelSpec, pos: torch.Tensor,
                           neg: torch.Tensor, mode: str) -> torch.Tensor:
    """``kge.forward(params, spec, (pos, neg), mode)`` for RotatE through
    ``negative_scores``: the fixed side's and the relation's rows gathered,
    ``q`` built in plain torch, the negatives scored by the kernels."""
    ent = params["entity_embedding"]
    fixed = ent[pos[:, 2] if mode == scorers.HEAD_BATCH else pos[:, 0]]
    r = params["relation_embedding"][pos[:, 1]]
    q = query(fixed, r, spec.embedding_range, mode).contiguous()
    return negative_scores(q, ent, neg.contiguous(), spec.gamma)
