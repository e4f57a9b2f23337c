"""Self-adversarial negative-sampling loss and L3 regularization.

Counterpart of ``knowledgegraphembedding_tpu/ops/loss.py`` (reference:
codes/model.py §train_step ≈L267-330). The loss of multi-device schedules
(``kge_loss_global``) is not ported yet (ROADMAP Queue 1, item 14).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..config import TrainSpec


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
    if spec.negative_adversarial_sampling:
        adv_w = torch.softmax(negative_score * spec.adversarial_temperature, dim=1).detach()
        neg_term = torch.sum(adv_w * F.logsigmoid(-negative_score), dim=1)
    else:
        neg_term = torch.mean(F.logsigmoid(-negative_score), dim=1)
    pos_term = F.logsigmoid(positive_score)[:, 0]

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
