"""DistMult in plain PyTorch (Yang et al., ICLR 2015; ``codes/model.py``
§KGEModel.DistMult of the RotatE codebase, DeepGraphLearning/
KnowledgeGraphEmbedding): ``score = sum_k h_k r_k t_k``, a relation row as
wide as an entity row. Any dtype; no kernel, cache or batching.
"""

from __future__ import annotations

import torch

from kge_bench.reference.train import tf32

HEAD, TAIL = "head-batch", "tail-batch"


def shapes(cfg: dict) -> dict:
    g, d = cfg["graph"], cfg["hidden_dim"]
    return {"entity_embedding": (g["nentity"], d), "relation_embedding": (g["nrelation"], d)}


def query(ent: torch.Tensor, rel: torch.Tensor, pos: torch.Tensor, mode: str,
          cfg: dict) -> torch.Tensor:
    """[B, d]: h r for tail-batch, r t for head-batch."""
    anchor = ent[pos[:, 0]] if mode == TAIL else ent[pos[:, 2]]
    return anchor * rel[pos[:, 1]]


def score(q: torch.Tensor, cand: torch.Tensor, cfg: dict) -> torch.Tensor:
    return (q * cand).sum(dim=-1)


def scores_all(q: torch.Tensor, ent: torch.Tensor, cfg: dict,
               precision: str = "exact") -> torch.Tensor:
    """[B, E] scores of every entity: in the inputs' dtype ('exact'), or a
    float32 matmul in TF32 ('tf32')."""
    if precision == "exact":
        return q @ ent.T
    if precision == "tf32":
        with tf32(True):
            return q.float() @ ent.float().T
    raise ValueError(f"DistMult has no {precision} path")


def train_scores(ent, rel, pos, neg, mode, cfg, precision: str = "exact"):
    """(positive [B], negative [B, n]) scores of a training batch. 'tf32'
    scores the negatives as the dense path does, one matmul against the
    whole table and a gather of the n columns, in the TF32 that the caller
    turned on for the whole step."""
    positive = score(query(ent, rel, pos, TAIL, cfg), ent[pos[:, 2]], cfg)
    q = query(ent, rel, pos, mode, cfg)
    if precision == "exact":
        negative = score(q[:, None, :], ent[neg], cfg)
    elif precision == "tf32":
        negative = torch.gather(q @ ent.T, 1, neg)
    else:
        raise ValueError(f"DistMult has no {precision} path")
    return positive, negative
