"""The row-routing mesh step: each rank asks the owner of every entity row
its batch touches for exactly that row, over ``all_to_all``
(``--spmd_mode routed``).

Counterpart of ``knowledgegraphembedding_tpu/parallel/routed_step.py``.

  fetch_rows(table_local, ids):
    owner    = ids // rows_per_shard                  (uniform row shard)
    send     = ids bucketed by owner into [W, C] slots (stable sort)
    requests = all_to_all_single(send)                 (the ids)
    rows     = table_local[requests - my_offset]       (local gather)
    replies  = all_to_all_single(rows)                 (the rows)
    result   = unbucketed back to the ids' order

The reply exchange is an autograd Function whose backward is the reverse
all_to_all: the gradient rows travel back to their owners, where the local
gather's backward adds them into the owned rows. The loss is the global one
of ``ops/loss.kge_loss_global``, shared with ``shard_map_step.py``.

Capacity: each (rank, owner) bucket has a fixed ``C`` (static shapes, as
the JAX schedule's, and as a CUDA graph needs). Negative ids are uniform,
so 1.3x their binomial mean + 64 suffices; positives follow the graph's
skewed degrees, so the budget lets all of a rank's positives land on one
owner. A bucket past ``C`` would silently drop rows, so the step logs
``routed_overflow`` (1 when any bucket of any rank overflowed) and the CLI
raises on it before any checkpoint is written.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from .. import optim
from ..config import ModelSpec, TrainSpec
from ..models import scorers
from ..ops import loss as loss_ops
from .shard_map_step import sum_replicated_grads
from .sharding import ENTITY, data_group, data_index, data_size

LANE = 128


def _capacity(n_uniform: int, n_shards: int, n_skewed: int = 0) -> int:
    """Static per-(rank, owner) bucket size: every skewed (positive) id may
    land on one owner, the uniform (negative) ids at 1.3x their mean + 64;
    rounded up to a multiple of 128."""
    c = n_skewed + int(n_uniform / n_shards * 1.3) + 64
    return -(-c // LANE) * LANE


class _Exchange(torch.autograd.Function):
    """``all_to_all_single`` of [W * C, ...] rows, slot block s to rank s;
    the backward sends the gradient rows back the same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def fetch_rows(table_local: torch.Tensor, ids: torch.Tensor, *, n_shards: int, capacity: int,
               group, rank: int):
    """[L] ids of any rank's rows -> ([L, d] rows, the fullest bucket's
    fill, a 0-d tensor). Differentiable in ``table_local``."""
    rows_per_shard = table_local.shape[0]
    ids = ids.to(torch.int64)
    L = ids.shape[0]
    owner = torch.div(ids, rows_per_shard, rounding_mode="floor")
    order = torch.argsort(owner, stable=True)
    ids_sorted = ids[order]
    owner_sorted = owner[order]
    counts = torch.bincount(owner, minlength=n_shards)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(L, device=ids.device) - starts[owner_sorted]
    fill = counts.max()
    slot_c = torch.clamp(slot, max=capacity - 1)  # past C: overflow, flagged by fill
    # an unused slot asks its owner for row (slot mod rows): spread over the
    # rows, so the gather's backward adds its zero gradient without piling
    # every unused slot onto one row
    everywhere = torch.arange(n_shards * capacity, device=ids.device)
    send = (everywhere % rows_per_shard
            + torch.div(everywhere, capacity, rounding_mode="floor") * rows_per_shard)
    flat_slot = owner_sorted * capacity + slot_c
    send[flat_slot] = ids_sorted
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)  # recv[s, c]: what rank s asked me
    local_idx = torch.clamp(recv - rank * rows_per_shard, 0, rows_per_shard - 1)
    replies = _Exchange.apply(table_local[local_idx], group)  # answers my send[s, c]
    # id j's reply sits at slot flat_slot[position of j in the sorted order]
    return replies[flat_slot[torch.argsort(order)]], fill


def routed_train_step(params, opt_state: optim.AdamState, pos, neg, weight,
                      lr: torch.Tensor, *, spec: ModelSpec, tspec: TrainSpec, mesh,
                      mode: str) -> Dict[str, torch.Tensor]:
    """One routed step on this rank's blocks and batch rows; params and
    moments updated in place. Logs carry ``routed_overflow``."""
    group = data_group(mesh)
    n_shards = data_size(mesh)
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    ent_local = leaves[ENTITY]
    Bl = pos.shape[0]
    pos = pos.to(torch.int64)
    n_neg = neg.shape[0] * neg.shape[1]  # [1, n] when shared: uniform ids
    ids = torch.cat([pos[:, 0], pos[:, 2], neg.reshape(-1).to(torch.int64)])
    cap = _capacity(n_neg, n_shards, n_skewed=2 * Bl)
    rows, fill = fetch_rows(ent_local, ids, n_shards=n_shards, capacity=cap, group=group,
                            rank=data_index(mesh))
    r_rows = leaves["relation_embedding"][pos[:, 1]]
    if tspec.precision == "bf16":
        # bf16 score math on the f32 rows the exchange moved; f32 sums in the
        # loss and f32 masters in Adam, as the other schedules
        rows = rows.to(torch.bfloat16)
        r_rows = r_rows.to(torch.bfloat16)
    h = rows[:Bl][:, None, :]
    t = rows[Bl:2 * Bl][:, None, :]
    neg_rows = rows[2 * Bl:].reshape(*neg.shape, -1)  # [Bl | 1, n, de]
    r = r_rows[:, None, :]
    kw = dict(gamma=spec.gamma, embedding_range=spec.embedding_range,
              modulus=leaves.get("modulus"))
    if mode == scorers.HEAD_BATCH:
        negative_score = scorers.score_fn(spec.model_name, neg_rows, r, t, mode=mode, **kw)
    else:
        negative_score = scorers.score_fn(spec.model_name, h, r, neg_rows, mode=mode, **kw)
    positive_score = scorers.score_fn(spec.model_name, h, r, t, mode=scorers.SINGLE, **kw)
    loss, logs = loss_ops.kge_loss_global(positive_score, negative_score, weight, tspec, group,
                                          n_shards, ent_local=ent_local,
                                          rel_replicated=leaves["relation_embedding"])
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    sum_replicated_grads(grads, group)
    optim.apply_update(params, grads, opt_state, lr)
    overflow = (fill > cap).to(torch.float32)
    dist.all_reduce(overflow, op=dist.ReduceOp.MAX, group=group)
    out = {k: v.detach() for k, v in logs.items()}
    out["routed_overflow"] = overflow.to(out["loss"].dtype)
    return out
