"""The hand-scheduled mesh step: the table all-gathered in the forward, its
gradient reduce-scattered in the backward (``--spmd_mode shardmap``).

Counterpart of ``knowledgegraphembedding_tpu/parallel/shard_map_step.py``.
On each rank of the ``data`` group:

  forward:   full table = all_gather(entity rows of this rank)
  backward:  d(entity rows) = reduce_scatter(d(full table), SUM)
  rel/mod:   gradients all-reduced (SUM): the tables are replicated
  update:    dense Adam on the local blocks only

Gathering the table moves 2·E·d floats a step (table out, gradient back),
where routing rows to their owners (``routed_step.py``) moves the batch's
B·(n+2)·d rows and their gradients; at the reference scales B·(n+2) > 2·E,
so the gather is the cheaper exchange, dense, and without a capacity.

The loss is assembled from all-reduced numerators and denominators
(``ops/loss.kge_loss_global``), so every rank computes the global weighted
loss of the reference, not a mean of means. Gradient bookkeeping: the
all-reduce inside the loss is the identity in the backward (every rank
differentiates the same replicated loss), the gather's backward sums the
ranks' table gradients into each owner's rows, and the replicated leaves'
gradients are summed once after the backward. Summing again anywhere would
scale the gradients by the group size; the tests pin the Adam moments to
the single-device trainer's.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from .. import optim
from ..config import ModelSpec, TrainSpec
from ..ops import loss as loss_ops
from ..train import batch_scores
from .multihost import all_gather_flat, reduce_scatter_flat
from .sharding import ENTITY, data_group, data_size


class _AllGatherRows(torch.autograd.Function):
    """Rows of every rank of ``group``, in rank order; the backward sums the
    ranks' gradients of the gathered rows into each rank's own rows."""

    @staticmethod
    def forward(ctx, local, group):
        ctx.group = group
        n = dist.get_world_size(group)
        out = local.new_empty((n * local.shape[0],) + tuple(local.shape[1:]))
        all_gather_flat(out, local.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // n,) + tuple(g.shape[1:]))
        reduce_scatter_flat(out, g.contiguous(), op=dist.ReduceOp.SUM, group=ctx.group)
        return out, None


def all_gather_rows(local: torch.Tensor, group) -> torch.Tensor:
    return _AllGatherRows.apply(local, group)


def global_loss_and_logs(params_local, spec: ModelSpec, tspec: TrainSpec, pos, neg, weight,
                         mode: str, group, n_shards: int):
    """Per-rank loss body; every returned scalar is the same GLOBAL value on
    every rank of ``group``."""
    full = all_gather_rows(params_local[ENTITY], group)
    positive_score, negative_score = batch_scores(dict(params_local, **{ENTITY: full}), spec,
                                                  tspec, pos, neg, mode)
    return loss_ops.kge_loss_global(positive_score, negative_score, weight, tspec, group,
                                    n_shards, ent_local=params_local[ENTITY],
                                    rel_replicated=params_local["relation_embedding"])


def sum_replicated_grads(grads: Dict[str, torch.Tensor], group) -> None:
    """All-reduce (SUM) the gradients of the replicated leaves in place, in
    one flat buffer."""
    names = [k for k in grads if k != ENTITY]
    if not names:
        return
    flat = torch.cat([grads[k].reshape(-1) for k in names])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    i = 0
    for k in names:
        n = grads[k].numel()
        grads[k] = flat[i:i + n].view_as(grads[k])
        i += n


def shardmap_train_step(params, opt_state: optim.AdamState, pos, neg, weight,
                        lr: torch.Tensor, *, spec: ModelSpec, tspec: TrainSpec, mesh,
                        mode: str) -> Dict[str, torch.Tensor]:
    """One explicit-collective step on this rank's blocks and batch rows;
    params and moments updated in place. Entity rows must be padded to a
    multiple of the mesh size (``sharding.pad_params``)."""
    group = data_group(mesh)
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    loss, logs = global_loss_and_logs(leaves, spec, tspec, pos, neg, weight, mode, group,
                                      data_size(mesh))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    sum_replicated_grads(grads, group)
    optim.apply_update(params, grads, opt_state, lr)
    return {k: v.detach() for k, v in logs.items()}
