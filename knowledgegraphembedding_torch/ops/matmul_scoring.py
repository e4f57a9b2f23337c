"""Dense matmul scoring for the bilinear scorers (DistMult, ComplEx).

Counterpart of ``knowledgegraphembedding_tpu/ops/matmul_scoring.py``. Both
scorers are bilinear in the candidate entity:

    DistMult:  s(h, r, t) = <h * r, t>
    ComplEx:   s(h, r, t) = Re(<h, r, conj(t)>) = <phi(h, r), t>

so the scores against every entity are one matrix product with the entity
table, ``phi [B, de] @ table.T [de, E]``, and the sampled negatives' scores
a gather from that ``[B, E]`` block. The backward is matrix products too
(autograd: no scatter over ``[B, n, d]`` rows). The reduction order changes
(the product accumulates in its own order), the math does not.

The product is an ordinary ``torch.matmul`` (cuBLAS on the card), as the JAX
package left it to XLA: no hand kernel. f32 runs in full f32, never TF32,
mirroring the JAX package's ``Precision.HIGHEST``: the functions here raise
if the process has lowered the f32 matmul precision, rather than trusting a
default. The compute dtype follows the params (f64 parity runs stay f64),
unless ``--precision bf16`` asks for bf16 operands with f32 results.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import ModelSpec
from ..models.scorers import HEAD_BATCH, TAIL_BATCH, _split2

DENSE_MODELS = ("DistMult", "ComplEx")


def supports_dense(model_name: str) -> bool:
    return model_name in DENSE_MODELS


def phi(model_name: str, h: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Left factor of the bilinear form, one row per positive:
    DistMult ``h * r``; ComplEx ``concat(re_h re_r - im_h im_r,
    re_h im_r + im_h re_r)`` against the tail's natural (re, im) layout."""
    if model_name == "DistMult":
        return h * r
    if model_name == "ComplEx":
        re_h, im_h = _split2(h)
        re_r, im_r = _split2(r)
        return torch.cat([re_h * re_r - im_h * im_r, re_h * im_r + im_h * re_r], dim=-1)
    raise ValueError(f"{model_name} has no dense bilinear form")


def phi_for_mode(model_name: str, fixed: torch.Tensor, rel: torch.Tensor,
                 mode: str) -> torch.Tensor:
    """Left factor when the candidate side varies: tail-batch ``phi(h, r)``;
    head-batch DistMult ``r * t``, ComplEx ``concat(re_r re_t + im_r im_t,
    re_r im_t - im_r re_t)`` against the head's (re, im) layout."""
    if mode == TAIL_BATCH:
        return phi(model_name, fixed, rel)
    if mode != HEAD_BATCH:
        raise ValueError(f"mode {mode} not supported")
    if model_name == "DistMult":
        return rel * fixed
    if model_name != "ComplEx":
        raise ValueError(f"{model_name} has no dense bilinear form")
    re_r, im_r = _split2(rel)
    re_t, im_t = _split2(fixed)
    return torch.cat([re_r * re_t + im_r * im_t, re_r * im_t - im_r * re_t], dim=-1)


def check_full_precision(dtype: torch.dtype) -> None:
    """Refuse an f32 product that would run in TF32 (about three decimal
    digits): the counterpart of the JAX package's ``Precision.HIGHEST``."""
    if dtype == torch.float32 and (torch.get_float32_matmul_precision() != "highest"
                                   or torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError(
            "dense scoring needs full-f32 matmuls, but this process lowered the f32 "
            f"matmul precision (torch.get_float32_matmul_precision() = "
            f"{torch.get_float32_matmul_precision()!r}, allow_tf32 = "
            f"{torch.backends.cuda.matmul.allow_tf32}); set it back to 'highest'")


def dense_scores_all(spec: ModelSpec, params, pos: torch.Tensor, mode: str,
                     compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """[B, E] scores of every entity as the corrupted slot of ``pos`` [B, 3],
    in ``compute_dtype`` (default: the params' dtype; f32 or f64).

    ``torch.bfloat16``: the JAX package's bf16 product with f32 results, the
    sums of products of bf16-rounded operands. The operands are rounded to
    bf16 and multiplied back in full f32: a product of two bf16 values is
    exact in f32, so this is that function, where a bf16 ``matmul`` would
    round every score to 8 bits. The gradient reaches each operand rounded
    to bf16, as the JAX product's transpose gives it."""
    ent = params["entity_embedding"]
    dtype = compute_dtype or ent.dtype
    if dtype not in (torch.float32, torch.float64, torch.bfloat16):
        raise ValueError(f"dense scoring in {dtype}: f32, f64 or bf16")
    pos = pos.to(torch.int64)
    rel = params["relation_embedding"][pos[:, 1]]
    fixed = ent[pos[:, 2] if mode == HEAD_BATCH else pos[:, 0]]
    left, right = phi_for_mode(spec.model_name, fixed, rel, mode), ent.t()
    if dtype == torch.bfloat16:
        left, right = (x.to(dtype).to(torch.float32) for x in (left, right))
        dtype = torch.float32
    check_full_precision(dtype)
    return torch.matmul(left.to(dtype), right.to(dtype))


def dense_negative_scores(spec: ModelSpec, params, pos: torch.Tensor, neg: torch.Tensor,
                          mode: str, compute_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """[B, n]: the gather path's ``forward(..., mode)`` scores, through one
    [B, E] product and a gather along the entity axis. A shared ``neg``
    [1, n] is expanded to every row (``torch.gather`` does not broadcast,
    where JAX's ``take_along_axis`` does)."""
    all_scores = dense_scores_all(spec, params, pos, mode, compute_dtype)
    neg = neg.to(torch.int64)
    return torch.gather(all_scores, 1, neg.expand(all_scores.shape[0], neg.shape[1]))
