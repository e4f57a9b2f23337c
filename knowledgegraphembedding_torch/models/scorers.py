"""The five KGE scoring functions as plain functions on tensors.

Counterpart of ``knowledgegraphembedding_tpu/models/scorers.py`` (reference:
codes/model.py §TransE ≈L172, §DistMult ≈L182, §ComplEx ≈L192, §RotatE
≈L212, §pRotatE ≈L247). Each scorer is ``(h, r, t, *static) -> score`` over
broadcastable tensors:

  - ``single``:     h, r, t are ``[B, 1, d]``             -> score ``[B, 1]``
  - ``head-batch``: h is ``[B, n, de]``, r/t ``[B, 1, ·]`` -> score ``[B, n]``
  - ``tail-batch``: t is ``[B, n, de]``, h/r ``[B, 1, ·]`` -> score ``[B, n]``

The reference's associativity is kept per mode (``h + (r - t)`` in
head-batch, ``(h + r) - t`` in tail-batch) so float outputs follow the same
rounding as the JAX package. ``torch.abs`` already has the reference's
subgradient 0 at the kink, so no custom rule is needed for it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

PI = math.pi

HEAD_BATCH = "head-batch"
TAIL_BATCH = "tail-batch"
SINGLE = "single"
MODES = (SINGLE, HEAD_BATCH, TAIL_BATCH)


def _split2(x):
    """Split the trailing dim into (re, im) halves — the reference's
    ``torch.chunk(x, 2, dim=2)`` (codes/model.py ≈L195, ≈L216)."""
    half = x.shape[-1] // 2
    return x[..., :half], x[..., half:]


def _acc(x) -> torch.dtype:
    """Accumulator dtype of the embedding-dim reduction: at least f32, never
    a downcast (f64 runs stay f64)."""
    return torch.promote_types(x.dtype, torch.float32)


def transe(h, r, t, gamma: float, mode: str):
    """score = gamma - || h + r - t ||_1  (codes/model.py §TransE ≈L172-180)."""
    if mode == HEAD_BATCH:
        score = h + (r - t)
    else:
        score = (h + r) - t
    return gamma - torch.sum(torch.abs(score), dim=-1, dtype=_acc(score))


def distmult(h, r, t, mode: str):
    """score = sum(h * r * t)  (codes/model.py §DistMult ≈L182-190)."""
    if mode == HEAD_BATCH:
        score = h * (r * t)
    else:
        score = (h * r) * t
    return torch.sum(score, dim=-1, dtype=_acc(score))


def complex_(h, r, t, mode: str):
    """score = Re(<h, r, conj(t)>)  (codes/model.py §ComplEx ≈L192-210)."""
    re_h, im_h = _split2(h)
    re_r, im_r = _split2(r)
    re_t, im_t = _split2(t)
    if mode == HEAD_BATCH:
        re_score = re_r * re_t + im_r * im_t
        im_score = re_r * im_t - im_r * re_t
        score = re_h * re_score + im_h * im_score
    else:
        re_score = re_h * re_r - im_h * im_r
        im_score = re_h * im_r + im_h * re_r
        score = re_score * re_t + im_score * im_t
    return torch.sum(score, dim=-1, dtype=_acc(score))


def rotate(h, r, t, gamma: float, embedding_range: float, mode: str):
    """score = gamma - sum_i |h_i ∘ r_i - t_i|  with |r_i| = 1.

    Relation rows hold phases scaled by ``embedding_range / pi``
    (codes/model.py §RotatE ≈L212-245)."""
    re_h, im_h = _split2(h)
    re_t, im_t = _split2(t)
    phase_r = r / (embedding_range / PI)
    re_r = torch.cos(phase_r)
    im_r = torch.sin(phase_r)
    if mode == HEAD_BATCH:
        # conj(r) ∘ t - h : rotate the tail backwards onto the head
        re_score = re_r * re_t + im_r * im_t - re_h
        im_score = re_r * im_t - im_r * re_t - im_h
    else:
        # h ∘ r - t
        re_score = re_h * re_r - im_h * im_r - re_t
        im_score = re_h * im_r + im_h * re_r - im_t
    # zero-guarded magnitude: the value equals sqrt(sq) for sq >= 1e-30 and
    # the gradient at 0 is 0, as the reference's norm gives
    sq = re_score * re_score + im_score * im_score
    mag = torch.sqrt(torch.clamp(sq, min=1e-30))
    return gamma - torch.sum(mag, dim=-1, dtype=_acc(mag))


def protate(h, r, t, gamma: float, embedding_range: float, modulus, mode: str):
    """score = gamma - modulus * sum |sin(ph + pr - pt)|  with a trainable
    scalar ``modulus`` (codes/model.py §pRotatE ≈L247-265)."""
    scale = embedding_range / PI
    ph = h / scale
    pr = r / scale
    pt = t / scale
    if mode == HEAD_BATCH:
        score = ph + (pr - pt)
    else:
        score = (ph + pr) - pt
    score = torch.abs(torch.sin(score))
    return gamma - torch.sum(score, dim=-1, dtype=_acc(score)) * modulus


def score_fn(
    model_name: str,
    h,
    r,
    t,
    *,
    gamma: float,
    embedding_range: float,
    modulus: Optional[torch.Tensor] = None,
    mode: str = SINGLE,
):
    """Dispatch on the model name (codes/model.py §KGEModel.forward ≈L150-165)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode} not supported")
    if model_name == "TransE":
        return transe(h, r, t, gamma, mode)
    if model_name == "DistMult":
        return distmult(h, r, t, mode)
    if model_name == "ComplEx":
        return complex_(h, r, t, mode)
    if model_name == "RotatE":
        return rotate(h, r, t, gamma, embedding_range, mode)
    if model_name == "pRotatE":
        if modulus is None:
            raise ValueError("pRotatE requires a modulus parameter")
        return protate(h, r, t, gamma, embedding_range, modulus, mode)
    raise ValueError(f"model {model_name} not supported")
