"""Self-adversarial negative-sampling loss and L3 regularization.

Counterpart of ``knowledgegraphembedding_tpu/ops/loss.py`` (reference:
codes/model.py §train_step ≈L267-330), and ``kge_loss_global``, the same
loss normalized over every rank of a ``torch.distributed`` group, which the
hand-scheduled mesh schedules (``parallel/shard_map_step.py``,
``parallel/routed_step.py``) share.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..config import TrainSpec


def _row_terms(positive_score: torch.Tensor, negative_score: torch.Tensor,
               spec: TrainSpec) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-row positive and negative terms [B] of the reference loss:
    logsigmoid(pos_score), and the self-adversarial sum (softmax weights
    detached) or the mean of logsigmoid(-n_score)."""
    if spec.negative_adversarial_sampling:
        adv_w = torch.softmax(negative_score * spec.adversarial_temperature, dim=1).detach()
        neg_term = torch.sum(adv_w * F.logsigmoid(-negative_score), dim=1)
    else:
        neg_term = torch.mean(F.logsigmoid(-negative_score), dim=1)
    return F.logsigmoid(positive_score)[:, 0], neg_term


def kge_loss(positive_score: torch.Tensor, negative_score: torch.Tensor,
             subsampling_weight: torch.Tensor,
             spec: TrainSpec) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference loss (codes/model.py ≈L285-315).

    positive_score [B, 1], negative_score [B, n], subsampling_weight [B].
      - self-adversarial: softmax(n_score * alpha) over the negatives,
        detached (the reference calls .detach()), times logsigmoid(-n_score),
        summed; otherwise the mean of logsigmoid(-n_score);
      - positive term: logsigmoid(pos_score);
      - word2vec subsampling weights unless uni_weight:
        loss_x = -(w * term_x).sum() / w.sum();
      - loss = (positive_sample_loss + negative_sample_loss) / 2."""
    pos_term, neg_term = _row_terms(positive_score, negative_score, spec)
    if spec.uni_weight:
        positive_sample_loss = -torch.mean(pos_term)
        negative_sample_loss = -torch.mean(neg_term)
    else:
        w = subsampling_weight
        wsum = torch.sum(w)
        positive_sample_loss = -torch.sum(w * pos_term) / wsum
        negative_sample_loss = -torch.sum(w * neg_term) / wsum

    loss = (positive_sample_loss + negative_sample_loss) / 2
    logs = {
        "positive_sample_loss": positive_sample_loss,
        "negative_sample_loss": negative_sample_loss,
        "loss": loss,
    }
    return loss, logs


def l3_regularization(params, coeff: float) -> torch.Tensor:
    """coeff * (||E||_3^3 + ||R||_3^3) over the whole tables, every row, not
    only those of the batch (codes/model.py ≈L305-312)."""
    e = params["entity_embedding"]
    r = params["relation_embedding"]
    return coeff * (torch.sum(torch.abs(e) ** 3) + torch.sum(torch.abs(r) ** 3))


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group in the forward; the identity in the backward. The
    sum is replicated and every rank differentiates the same global loss,
    so each rank's cotangent of the sum is already the cotangent of its own
    term: summing the cotangents too would scale every gradient by the
    group size (the JAX package's note on psum under shard_map)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``group``."""
    return _AllReduceSum.apply(x, group)


def kge_loss_global(positive_score: torch.Tensor, negative_score: torch.Tensor,
                    subsampling_weight: torch.Tensor, spec: TrainSpec, group, n_shards: int,
                    ent_local: torch.Tensor = None, rel_replicated: torch.Tensor = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``kge_loss`` with GLOBAL normalization, for a rank that holds rows
    [Bl] of the global batch: the per-row terms are computed locally and
    every numerator and denominator is summed over ``group``
    (``all_reduce_sum``), so each rank returns the same global scalars, not
    a mean of means (JAX ``ops/loss.py::kge_loss_global``).

    L3 regularization, when the tables are given (gspmd adds its own term
    on DTensors): ``ent_local`` holds this rank's entity rows (a sum of
    the per-rank sums); the relation table is replicated, so its term is
    divided by ``n_shards`` inside the sum and counted once, and the
    relation gradients the caller sums over the group count it once too."""
    pos_term, neg_term = _row_terms(positive_score, negative_score, spec)
    if spec.uni_weight:
        denom = float(pos_term.shape[0] * n_shards)
        sums = all_reduce_sum(torch.stack([torch.sum(pos_term), torch.sum(neg_term)]), group)
        positive_sample_loss = -sums[0] / denom
        negative_sample_loss = -sums[1] / denom
    else:
        w = subsampling_weight
        sums = all_reduce_sum(torch.stack([torch.sum(w), torch.sum(w * pos_term),
                                           torch.sum(w * neg_term)]), group)
        positive_sample_loss = -sums[1] / sums[0]
        negative_sample_loss = -sums[2] / sums[0]

    loss = (positive_sample_loss + negative_sample_loss) / 2
    logs = {
        "positive_sample_loss": positive_sample_loss,
        "negative_sample_loss": negative_sample_loss,
        "loss": loss,
    }
    if spec.regularization != 0.0 and ent_local is not None:
        l3 = all_reduce_sum(torch.stack([torch.sum(torch.abs(ent_local) ** 3),
                                         torch.sum(torch.abs(rel_replicated) ** 3) / n_shards]),
                            group)
        reg = spec.regularization * (l3[0] + l3[1])
        loss = loss + reg
        logs["regularization"] = reg
        logs["loss"] = loss
    return loss, logs
