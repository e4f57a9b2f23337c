"""Parameter initialization and the gather→score forward pass.

Counterpart of ``knowledgegraphembedding_tpu/models/kge.py`` (reference:
codes/model.py §KGEModel.__init__ ≈L25-100, §forward ≈L102-170). Parameters
are a plain dict with the JAX package's key names, so checkpoints and test
comparisons line up key for key:

  params = {
    "entity_embedding":   f32[nentity, entity_dim],
    "relation_embedding": f32[nrelation, relation_dim],
    "modulus":            f32[] (pRotatE only),
  }
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..config import ModelSpec
from . import scorers

Params = Dict[str, torch.Tensor]


def init_params(spec: ModelSpec, generator: Optional[torch.Generator] = None,
                device="cuda", dtype=torch.float32) -> Params:
    """Uniform(-range, range) init of both tables (codes/model.py ≈L40-50,
    ``nn.init.uniform_``) plus pRotatE's ``modulus = 0.5 * embedding_range``
    (≈L52-55). ``generator`` must live on ``device``."""
    rng = spec.embedding_range

    def uniform(shape):
        out = torch.empty(shape, dtype=dtype, device=device)
        return out.uniform_(-rng, rng, generator=generator)

    params: Params = {
        "entity_embedding": uniform((spec.nentity, spec.entity_dim)),
        "relation_embedding": uniform((spec.nrelation, spec.relation_dim)),
    }
    if spec.has_modulus:
        params["modulus"] = torch.tensor(0.5 * rng, dtype=dtype, device=device)
    return params


def params_from_numpy(arrays: Mapping[str, np.ndarray], device) -> Params:
    """The JAX package's params as numpy (``{k: np.asarray(v)}``, or the
    ``param.*`` entries of its ``checkpoint.npz`` with the prefix dropped)
    -> the port's params on ``device``, dtype kept."""
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in arrays.items()}


def trainable(params: Mapping[str, torch.Tensor]) -> Params:
    """Copies of ``params`` as leaf tensors that require grad: a trainer
    owns and updates its own tables, and the caller's stay as they were."""
    return {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}


def forward(params: Params, spec: ModelSpec, sample,
            mode: str = scorers.SINGLE,
            compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Mode-dependent gather + score (codes/model.py §KGEModel.forward).

    - ``single``:     sample = i64[B, 3]                      -> [B, 1]
    - ``head-batch``: sample = (pos i64[B, 3], neg i64[B, n]) -> [B, n]
      (negatives replace the head)
    - ``tail-batch``: sample = (pos i64[B, 3], neg i64[B, n]) -> [B, n]
      (negatives replace the tail)

    ``neg`` may also be one shared row ``[1, n]`` (``--negative_sharing
    batch``): its ``[1, n, de]`` rows broadcast against the ``[B, 1, ·]``
    rows of the positives. ``compute_dtype=torch.bfloat16`` casts both tables
    once and gathers from the casts, as the JAX package does: the score math
    runs in bf16, the scorers reduce in f32, the scores are f32, and the
    gather's backward sums duplicate rows into a bf16 gradient (on the CPU
    one bf16 add at a time; on the card in f32, rounded once) before the
    cast's backward brings it to the tables' dtype.
    """
    ent = params["entity_embedding"]
    rel = params["relation_embedding"]
    if compute_dtype is not None and ent.dtype != compute_dtype:
        ent = ent.to(compute_dtype)
        rel = rel.to(compute_dtype)
    if mode == scorers.SINGLE:
        pos = sample
        h = ent[pos[:, 0]][:, None, :]
        r = rel[pos[:, 1]][:, None, :]
        t = ent[pos[:, 2]][:, None, :]
    elif mode == scorers.HEAD_BATCH:
        pos, neg = sample
        h = ent[neg]  # [B, n, de]
        r = rel[pos[:, 1]][:, None, :]
        t = ent[pos[:, 2]][:, None, :]
    elif mode == scorers.TAIL_BATCH:
        pos, neg = sample
        h = ent[pos[:, 0]][:, None, :]
        r = rel[pos[:, 1]][:, None, :]
        t = ent[neg]  # [B, n, de]
    else:
        raise ValueError(f"mode {mode} not supported")
    return scorers.score_fn(
        spec.model_name, h, r, t,
        gamma=spec.gamma,
        embedding_range=spec.embedding_range,
        modulus=params.get("modulus"),
        mode=mode,
    )
