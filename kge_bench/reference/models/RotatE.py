"""RotatE in plain PyTorch (Sun et al., ICLR 2019; ``codes/model.py``
§KGEModel.RotatE of the RotatE codebase, DeepGraphLearning/
KnowledgeGraphEmbedding).

An entity is d complex numbers stored as [re | im] (2d reals), a relation d
phases ``r / (embedding_range / pi)``. Tail-batch scores ``gamma - sum_k
|h_k r_k - t_k|``; head-batch ``gamma - sum_k |conj(r_k) t_k - h_k|``, the
codebase's two forms. Any dtype; no kernel, cache or batching.
"""

from __future__ import annotations

import math

import torch

EPSILON = 2.0
HEAD, TAIL = "head-batch", "tail-batch"


def embedding_range(cfg: dict) -> float:
    return (cfg["gamma"] + EPSILON) / cfg["hidden_dim"]


def shapes(cfg: dict) -> dict:
    g, d = cfg["graph"], cfg["hidden_dim"]
    return {"entity_embedding": (g["nentity"], 2 * d), "relation_embedding": (g["nrelation"], d)}


def query(ent: torch.Tensor, rel: torch.Tensor, pos: torch.Tensor, mode: str,
          cfg: dict) -> torch.Tensor:
    """[B, 2d] rows that every candidate is held against: h r for
    tail-batch, conj(r) t for head-batch; ``pos`` i64 [B, 3]."""
    phase = rel[pos[:, 1]] / (embedding_range(cfg) / math.pi)
    re_r, im_r = torch.cos(phase), torch.sin(phase)
    anchor = ent[pos[:, 0]] if mode == TAIL else ent[pos[:, 2]]
    re_a, im_a = anchor.chunk(2, dim=-1)
    if mode == TAIL:
        re_q, im_q = re_a * re_r - im_a * im_r, re_a * im_r + im_a * re_r
    else:
        re_q, im_q = re_r * re_a + im_r * im_a, re_r * im_a - im_r * re_a
    return torch.cat([re_q, im_q], dim=-1)


def score(q: torch.Tensor, cand: torch.Tensor, cfg: dict,
          sum_dtype: torch.dtype = None) -> torch.Tensor:
    """gamma - sum_k |q_k - c_k| over the last axis (broadcast)."""
    re_q, im_q = q.chunk(2, dim=-1)
    re_c, im_c = cand.chunk(2, dim=-1)
    re, im = re_q - re_c, im_q - im_c
    dist = torch.sqrt(re * re + im * im)
    return cfg["gamma"] - dist.sum(dim=-1, dtype=sum_dtype or dist.dtype)


def scores_all(q: torch.Tensor, ent: torch.Tensor, cfg: dict,
               precision: str = "exact") -> torch.Tensor:
    """[B, E] scores of every entity; ``precision`` 'exact' keeps the
    inputs' dtype, 'bf16' computes the chain in bfloat16 and sums in f32."""
    if precision == "bf16":
        q, ent, sum_dtype = q.to(torch.bfloat16), ent.to(torch.bfloat16), torch.float32
    elif precision == "exact":
        sum_dtype = None
    else:
        raise ValueError(f"RotatE has no {precision} path")
    step = max(1, (1 << 27) // max(1, q.shape[0] * ent.shape[1]))
    return torch.cat([score(q[:, None, :], ent[None, s:s + step, :], cfg, sum_dtype)
                      for s in range(0, ent.shape[0], step)], dim=1)


def train_scores(ent, rel, pos, neg, mode, cfg, precision: str = "exact"):
    """(positive [B], negative [B, n]) scores of a training batch."""
    if precision != "exact":
        raise ValueError(f"RotatE's training reference has no {precision} path")
    positive = score(query(ent, rel, pos, TAIL, cfg), ent[pos[:, 2]], cfg)
    negative = score(query(ent, rel, pos, mode, cfg)[:, None, :], ent[neg], cfg)
    return positive, negative
