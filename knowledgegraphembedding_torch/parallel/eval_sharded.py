"""Filtered ranking with the candidate axis sharded over the mesh.

Counterpart of ``knowledgegraphembedding_tpu/parallel/eval_sharded.py``.
The entity table stays row-sharded as training left it: each rank counts
the candidates of ITS rows that beat the true score, and an
``all_reduce(SUM)`` of the int32 counts over the ``data`` group gives the
exact global rank (no gather of the table, no sort).

Per corruption mode, every rank fetches the fixed and true entities' rows
of all the split's batches from their owners in one collective
(``gather_rows``); per batch it builds the same candidate-independent
inputs, the left rows L and the true score, as
``ops/rank_kernel.Ranker.inputs`` builds them, and counts on its block of
``e_local`` rows starting at ``offset``:

  - RotatE, TransE, pRotatE: ``rank_kernel.rank_counts`` (on CUDA the hand
    kernels K1/K2/K3, on the CPU their plain version) over the block, with
    ``true_ids - offset``, the filter mask's column window ``[offset,
    offset + e_local)`` (a view: the kernel takes any row stride) and
    ``E`` = the block's real rows, so padding rows never count;
  - DistMult, ComplEx: one matmul against the block (``ops/matmul_scoring``)
    and, with the device-resident filter, the window correction of
    ``eval.dense_ranks_window`` restricted to the ids the block owns (JAX
    ``_ranks_body_window``); with host masks, the masked count.

One ``all_reduce`` of the ``[batches, B]`` counts ends a call of
``_Block.ranks``. With the device-resident filter a mode's batches go in
chunks of up to ``eval._SCAN_CHUNK`` (JAX ``get_sharded_scan_fn``): each
chunk is one call, the rows' gather, its batches and the counts' sum; on
NCCL it is captured once as a CUDA graph (``eval._ChunkGraph``, the
collectives inside) and replayed for every chunk, on gloo it runs eagerly.
With host masks a mode is one call. On a 2-D ``(data, model)`` mesh the
ranks of a ``model`` group first all-gather their column blocks of both
tables, then count as on the 1-D mesh (JAX leaves this case to GSPMD).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import eval as eval_mod
from ..config import ModelSpec
from ..data.filterset import MAX_DENSE_KEYS, FilterSets
from ..models import scorers
from ..ops import matmul_scoring, rank_kernel
from .multihost import all_gather_flat
from .sharding import (ENTITY, data_group, data_index, data_size, is_model_sharded,
                       model_group, model_size)

def gather_rows(table_local: torch.Tensor, ids: torch.Tensor, offset: int, group) -> torch.Tensor:
    """[L, d] rows of global ``ids`` of the row-sharded table, the same on
    every rank of ``group``: each rank contributes the rows it owns (zeros
    elsewhere) and each row is taken from its owner's contribution, so the
    values are exact."""
    e_local = table_local.shape[0]
    ids = ids.to(torch.int64)
    mine = (ids >= offset) & (ids < offset + e_local)
    rows = table_local[torch.clamp(ids - offset, 0, e_local - 1)]
    rows = torch.where(mine[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                         device=rows.device))
    n = dist.get_world_size(group)
    gathered = rows.new_empty((n * rows.shape[0], rows.shape[1]))
    all_gather_flat(gathered, rows.contiguous(), group=group)
    owner = torch.div(ids, e_local, rounding_mode="floor")
    return gathered.view(n, *rows.shape)[owner, torch.arange(len(ids), device=ids.device)]


def full_columns(local: torch.Tensor, group, n: int) -> torch.Tensor:
    """[rows, n * c]: the column blocks of the ``n`` ranks of ``group``."""
    rows, c = local.shape
    out = local.new_empty((n * rows, c))
    all_gather_flat(out, local.contiguous(), group=group)
    return out.view(n, rows, c).permute(1, 0, 2).reshape(rows, n * c)


class _Block:
    """This rank's view of the table at one moment of its weights: its rows
    in the kernel's layout, the replicated inputs of each batch, and the
    CUDA graphs of its scan chunks (``graphs``), which die with it."""

    @torch.no_grad()
    def __init__(self, params, spec: ModelSpec, mesh):
        self.mesh = mesh
        self.graphs: dict = {}
        ent, rel = params[ENTITY].detach(), params["relation_embedding"].detach()
        if is_model_sharded(mesh):
            ent = full_columns(ent, model_group(mesh), model_size(mesh))
            rel = full_columns(rel, model_group(mesh), model_size(mesh))
        self.spec = spec
        self.ent, self.rel = ent, rel
        self.modulus = params.get("modulus")
        if self.modulus is not None:
            self.modulus = self.modulus.detach()
        self.group = data_group(mesh)
        self.e_local = ent.shape[0]
        self.offset = data_index(mesh) * self.e_local
        self.padded = self.e_local * data_size(mesh)
        self.e_real = max(0, min(self.e_local, spec.nentity - self.offset))
        self.dense = spec.model_name in eval_mod.DENSE_MODELS
        if spec.model_name == "pRotatE":
            phase = ent * (scorers.PI / spec.embedding_range)
            self.table = torch.cat([torch.sin(phase), torch.cos(phase)], dim=1)
        else:
            self.table = ent.contiguous()

    @torch.no_grad()
    def rows(self, pos: torch.Tensor, mode: str):
        """(fixed rows, true rows, true ids) of every row of ``pos`` [N, 3],
        the entity rows fetched from their owners in one collective."""
        pos = pos.to(torch.int64)
        fixed_ids = pos[:, 0] if mode == scorers.TAIL_BATCH else pos[:, 2]
        true_ids = pos[:, 0] if mode == scorers.HEAD_BATCH else pos[:, 2]
        rows = gather_rows(self.ent, torch.cat([fixed_ids, true_ids]), self.offset, self.group)
        return rows[:len(pos)], rows[len(pos):], true_ids

    @torch.no_grad()
    def inputs(self, pos: torch.Tensor, fixed, true_rows, mode: str):
        """(left [B, D], true_score [B]) of one batch from its rows: for the
        distance family in the kernel's form (``Ranker.inputs``), for the
        bilinear models phi rows and the true rows' dot products."""
        r = self.rel[pos[:, 1].to(torch.int64)]
        if self.dense:
            left = matmul_scoring.phi_for_mode(self.spec.model_name, fixed, r, mode)
            return left, torch.sum(left * true_rows, dim=-1)
        left = rank_kernel.left_from_rows(fixed, r, self.spec, mode)
        if self.spec.model_name == "pRotatE":
            left = torch.cat([torch.sin(left), torch.cos(left)], dim=-1)
            phase = true_rows * (scorers.PI / self.spec.embedding_range)
            true_rows = torch.cat([torch.sin(phase), torch.cos(phase)], dim=-1)
        left = left.contiguous()
        true_score = rank_kernel.distance_scores(left, true_rows, self.spec.model_name,
                                                 self.spec.gamma, self.modulus)
        return left, true_score.contiguous()

    @torch.no_grad()
    def ranks(self, batches, mode: str, masks=None, window=None) -> torch.Tensor:
        """i32[nb, B] global filtered ranks of the batches ``batches`` [nb, B,
        3], the same on every rank: ``masks(b, pos)`` gives batch b's
        bool[B, >= padded] mask (True = filtered); the bilinear models may
        take ``window`` = (offsets, counts, values, k_max) of the
        device-resident CSR of ``mode`` instead. Two collectives a call: the
        rows' gather before the batches, the counts' sum after them."""
        nb, B = batches.shape[:2]
        fixed, true_rows, true_ids = self.rows(batches.reshape(-1, 3), mode)
        lo, hi = self.offset, self.offset + self.e_local
        counts = []
        for b in range(nb):
            pos, sl = batches[b], slice(b * B, (b + 1) * B)
            left, true_score = self.inputs(pos, fixed[sl], true_rows[sl], mode)
            if self.e_real == 0:
                counts.append(torch.zeros(B, dtype=torch.int32, device=left.device))
            elif not self.dense:
                counts.append(rank_kernel.rank_counts(
                    left, true_score, (true_ids[sl] - lo).to(torch.int32), self.table,
                    masks(b, pos)[:, lo:hi], family=self.spec.model_name, gamma=self.spec.gamma,
                    E=self.e_real, modulus=self.modulus))
            else:
                counts.append(self._dense_counts(left, true_score, true_ids[sl], mode, pos,
                                                 None if window else masks(b, pos), window))
        counts = torch.stack(counts)
        dist.all_reduce(counts, op=dist.ReduceOp.SUM, group=self.group)
        return counts + 1

    @torch.no_grad()
    def warm(self, batches, mode: str, masks=None, window=None) -> None:
        """Every op of ``ranks`` on the first batch of ``batches`` but the
        rank kernel, the collectives included, and the kernel's one-time
        setup (the warm-up before a capture: it sets up the allocator,
        cuBLAS, the communicator and the kernel's library)."""
        pos = batches[0]
        if not self.dense:
            rank_kernel.prepare(pos.device)
        fixed, true_rows, true_ids = self.rows(pos, mode)
        left, true_score = self.inputs(pos, fixed, true_rows, mode)
        if self.dense:
            self._dense_counts(left, true_score, true_ids, mode, pos,
                               None if window else masks(0, pos), window)
        elif masks is not None:
            masks(0, pos)
        dist.all_reduce(torch.zeros_like(true_ids, dtype=torch.int32), op=dist.ReduceOp.SUM,
                        group=self.group)

    def _dense_counts(self, left, true_score, true_ids, mode, pos, mask, window):
        lo = self.offset
        dtype = self.table.dtype
        matmul_scoring.check_full_precision(dtype)
        scores = torch.matmul(left.to(dtype), self.table[:self.e_real].t())  # [B, e_real]
        ids = torch.arange(lo, lo + self.e_real, device=left.device)[None, :]
        beats = (scores > true_score[:, None]) & (ids != true_ids[:, None])
        if window is None:
            beats &= mask[:, lo:lo + self.e_real].logical_not()
            return torch.sum(beats, dim=1, dtype=torch.int32)
        offsets, cnts, values, k_max = window
        E = self.spec.nentity
        if mode == scorers.HEAD_BATCH:
            keys = pos[:, 1] * E + pos[:, 2]
        else:
            keys = pos[:, 0] * self.spec.nrelation + pos[:, 1]
        slot = torch.arange(k_max, device=pos.device)
        win = values[offsets[keys].to(torch.int64)[:, None] + slot[None, :]].to(torch.int64)
        valid = slot[None, :] < cnts[keys][:, None]
        mine = (win >= lo) & (win < lo + self.e_real)
        win_scores = torch.gather(scores, 1, torch.clamp(win - lo, 0, self.e_real - 1))
        beats_f = (win_scores > true_score[:, None]) & valid & mine & (win != true_ids[:, None])
        return (torch.sum(beats, dim=1, dtype=torch.int32)
                - torch.sum(beats_f, dim=1, dtype=torch.int32))


# one _Block per (params at their versions, spec, mesh), under the ranker
# cache's rule (rank_kernel.cached_on_params): every evaluation of the same
# weights (valid, test, train) reuses its table and graphs. Every rank of a
# mesh makes the same lookups, so they build (a collective on a 2-D mesh)
# together
_block_cache: dict = {}


def get_block(params, spec: ModelSpec, mesh) -> _Block:
    return rank_kernel.cached_on_params(_block_cache, params, (spec, id(mesh)),
                                        lambda: _Block(params, spec, mesh))


@torch.no_grad()
def sharded_split_ranks(params, spec: ModelSpec, test_triples: np.ndarray, filters: FilterSets,
                        mesh, test_batch_size: int = 16,
                        modes: Sequence[str] = (scorers.HEAD_BATCH, scorers.TAIL_BATCH),
                        device_filter: bool = None) -> np.ndarray:
    """Filtered ranks of every triple of a split, i64[len(modes), n], the
    same on every rank. ``params`` are this rank's blocks (a mesh trainer's
    ``params``). Batching and filters as ``eval.split_ranks``:
    ``device_filter`` None uses the device-resident CSR when the key space
    fits (an explicit True past int32 warns and paints host masks)."""
    import logging

    n_real = len(test_triples)
    if n_real == 0:
        return np.zeros((len(modes), 0), np.int64)
    block = get_block(params, spec, mesh)
    device = block.ent.device
    key_space = spec.nentity * spec.nrelation
    if device_filter is None:
        device_filter = key_space <= MAX_DENSE_KEYS
    elif device_filter and key_space >= 2**31:
        logging.warning("--eval_filter device: composite key space E*R = %d exceeds int32; "
                        "using host filter masks", key_space)
        device_filter = False
    width = max(block.padded, spec.nentity + 1)
    if device_filter:
        dev_filter = eval_mod.get_device_filter(filters, device)
        eff = eval_mod.eff_eval_batch(spec, test_batch_size)
        # JAX: chunks of min(nb, _SCAN_CHUNK) batches, no log cadence
        SC, n_scan = eval_mod.scan_plan(-(-n_real // eff))
        stack = eval_mod.scan_stack(test_triples, eff, n_scan, device)
        ranks = torch.empty((len(modes), n_scan, eff), dtype=torch.int32, device=device)
        for m, mode in enumerate(modes):
            kw = dict(mode=mode)
            if block.dense:
                kw["window"] = dev_filter._modes[mode]
            else:
                kw["masks"] = lambda b, pos, mode=mode: dev_filter.mask_rows(pos, mode, width)
            key = (mode, SC, eff, dev_filter._modes[mode][3], width, id(dev_filter))
            run = eval_mod.chunk_runner(
                block.graphs, key, lambda chunk, kw=kw: block.ranks(chunk, **kw),
                lambda chunk, kw=kw: block.warm(chunk, **kw), device.type == "cuda",
                reads=(dev_filter,))
            for s in range(0, n_scan, SC):
                ranks[m, s:s + SC].copy_(run(stack[s:s + SC]))
        ranks = ranks.reshape(len(modes), n_scan * eff)[:, :n_real].cpu()  # the one pull
        return ranks.numpy().astype(np.int64)
    tb = test_batch_size
    nb = -(-n_real // tb)
    trip = np.asarray(test_triples, np.int64)
    # each batch padded with copies of its last row, as eval.split_ranks pads
    idx = np.minimum(np.arange(nb * tb).reshape(nb, tb),
                     np.minimum(np.arange(nb)[:, None] * tb + tb, n_real) - 1)
    stack = trip[idx]

    def host_masks(mode):
        def mask(b, pos):
            m = filters.filter_mask_rows(stack[b], mode)
            m = np.pad(m, ((0, 0), (0, max(0, width - m.shape[1]))))
            return torch.from_numpy(m).to(device)
        return mask

    out = []
    for mode in modes:
        ranks = block.ranks(torch.from_numpy(stack).to(device), mode, masks=host_masks(mode))
        out.append(ranks.reshape(-1)[torch.from_numpy(
            (idx == np.arange(nb * tb).reshape(nb, tb)).reshape(-1)).to(device)])
    return torch.stack(out).cpu().numpy().astype(np.int64)


def sharded_test_step(params, spec: ModelSpec, test_triples: np.ndarray, filters: FilterSets,
                      mesh, test_batch_size: int = 16,
                      modes: Sequence[str] = (scorers.HEAD_BATCH, scorers.TAIL_BATCH),
                      device_filter: bool = None) -> Dict[str, float]:
    """Drop-in multi-device ``eval.test_step``: the mean metrics over both
    directions, the same on every rank."""
    logs = []
    for ranks in sharded_split_ranks(params, spec, test_triples, filters, mesh,
                                     test_batch_size, modes, device_filter):
        logs.extend(eval_mod.metrics_from_ranks(ranks))
    if not logs:
        return {}
    return {k: float(np.mean([lg[k] for lg in logs])) for k in logs[0]}
