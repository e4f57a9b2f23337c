"""Filtered link-prediction evaluation.

Counterpart of ``knowledgegraphembedding_tpu/eval.py`` (reference:
codes/model.py §test_step ≈L332-390, codes/dataloader.py §TestDataset
≈L118-162). ``rank = 1 + #{unfiltered candidates with score > true score}``,
which equals the reference's argsort rank without materializing or sorting a
``[B, E]`` score row. Two rankers compute it:

  - ``ops.rank_kernel.Ranker``: the fused CUDA kernel for RotatE and TransE
    (the default on CUDA);
  - ``ranks_batch``: the plain chunked path in PyTorch ops, which scores the
    true entity in the batch layout as the JAX package's ``ranks_batch``.

Filter masks come from the host CSR (``FilterSets.filter_mask_rows``) or are
built on the device from a resident CSR (``DeviceFilter``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .config import ModelSpec
from .data.filterset import MAX_DENSE_KEYS, FilterSets, dense_key_arrays
from .models import kge, scorers
from .ops import rank_kernel

#: bilinear models rank through dense matmul scoring (not ported yet)
DENSE_MODELS = ("DistMult", "ComplEx")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def ranks_batch(params: kge.Params, pos: torch.Tensor, filter_mask: torch.Tensor,
                *, spec: ModelSpec, mode: str, chunk: int) -> torch.Tensor:
    """Filtered ranks (1-based) of the true entity for one eval batch.

    pos i64[B, 3]; filter_mask bool[B, >= ceil(E/chunk)*chunk], True =
    known-true corruption (the positive itself unfiltered)."""
    if spec.model_name in DENSE_MODELS:
        raise rank_kernel.unported(spec.model_name)
    ent = params["entity_embedding"]
    rel = params["relation_embedding"]
    E = spec.nentity
    n_chunks = _cdiv(E, chunk)
    if filter_mask.shape[1] < n_chunks * chunk:
        raise ValueError(f"filter mask width {filter_mask.shape[1]} < "
                         f"{n_chunks * chunk} (pad it with _pad_mask)")
    pos = pos.to(torch.int64)

    # the true entity is scored through the same mode-specific grouped form
    # as the candidates (in the reference it sits inside the [B, E] row being
    # argsorted), and excluded from its own count by id, so float noise
    # between the two reductions cannot make it beat itself
    true_ids = pos[:, 0:1] if mode == scorers.HEAD_BATCH else pos[:, 2:3]
    true_score = kge.forward(params, spec, (pos, true_ids), mode)[:, 0]

    r = rel[pos[:, 1]][:, None, :]
    fixed_col = 2 if mode == scorers.HEAD_BATCH else 0
    fixed = ent[pos[:, fixed_col]][:, None, :]
    kw = dict(gamma=spec.gamma, embedding_range=spec.embedding_range,
              modulus=params.get("modulus"), mode=mode)

    count = torch.zeros(pos.shape[0], dtype=torch.int32, device=ent.device)
    for c in range(n_chunks):
        start = c * chunk
        ids = torch.arange(start, start + chunk, device=ent.device)
        valid = ids < E
        rows = ent[torch.clamp(ids, max=E - 1)][None, :, :]  # [1, chunk, de]
        if mode == scorers.HEAD_BATCH:
            score = scorers.score_fn(spec.model_name, rows, r, fixed, **kw)
        else:
            score = scorers.score_fn(spec.model_name, fixed, r, rows, **kw)
        mask_chunk = filter_mask[:, start:start + chunk]
        beats = (
            (score > true_score[:, None])
            & valid[None, :]
            & mask_chunk.logical_not()
            & (ids[None, :] != true_ids)
        )
        count += torch.sum(beats, dim=1, dtype=torch.int32)
    return count + 1


def _pad_mask(mask: np.ndarray, chunk: int) -> np.ndarray:
    E = mask.shape[1]
    Epad = _cdiv(E, chunk) * chunk
    if Epad == E:
        return mask
    return np.pad(mask, ((0, 0), (0, Epad - E)))


class DeviceFilter:
    """Device-resident eval filter: the all-true CSR lives on the device and
    the [B, W] bool filter mask is built there (a k_max-window gather plus
    one scatter), so no [B, E] host mask crosses to the card per batch. Same
    semantics as ``FilterSets.filter_mask_rows``: True = known-true
    corruption, the positive itself unfiltered (codes/dataloader.py
    ≈L140-148)."""

    def __init__(self, filters: FilterSets, device):
        E, R = filters.nentity, filters.nrelation
        if E * R >= 2**31:
            raise ValueError("composite key space exceeds int32")
        self.nentity, self.nrelation = E, R
        self._modes = {}
        for mode, idx, n_keys in (
            (scorers.HEAD_BATCH, filters.all_true_head, R * E),
            (scorers.TAIL_BATCH, filters.all_true_tail, E * R),
        ):
            offsets, counts, values, k_max = dense_key_arrays(idx, n_keys, pad_value=0)
            self._modes[mode] = (
                torch.from_numpy(offsets).to(device),
                torch.from_numpy(counts).to(device),
                torch.from_numpy(values).to(device),
                k_max,
            )

    def mask_rows(self, pos: torch.Tensor, mode: str, width: int) -> torch.Tensor:
        """bool[B, max(width, E+1)]: the column past E is the scatter sink for
        unused window slots (every rank path guards ids < E)."""
        offsets, counts, values, k_max = self._modes[mode]
        return _device_mask(
            pos, offsets, counts, values, k_max=k_max, mode=mode,
            nentity=self.nentity, nrelation=self.nrelation,
            width=max(width, self.nentity + 1),
        )


def _device_mask(pos, offsets, counts, values, *, k_max, mode, nentity,
                 nrelation, width):
    pos = pos.to(torch.int64)
    B = pos.shape[0]
    if mode == scorers.HEAD_BATCH:
        keys = pos[:, 1] * nentity + pos[:, 2]
        true_ids = pos[:, 0]
    else:
        keys = pos[:, 0] * nrelation + pos[:, 1]
        true_ids = pos[:, 2]
    slot = torch.arange(k_max, device=pos.device)
    windows = values[offsets[keys].to(torch.int64)[:, None] + slot[None, :]]
    valid = slot[None, :] < counts[keys][:, None]
    ids = torch.where(valid, windows.to(torch.int64), width - 1)
    rows = torch.arange(B, device=pos.device)
    mask = torch.zeros((B, width), dtype=torch.bool, device=pos.device)
    mask[rows[:, None].expand(B, k_max), ids] = True
    mask[rows, true_ids] = False  # the positive is never filtered
    return mask


def get_device_filter(filters: FilterSets, device) -> DeviceFilter:
    """One DeviceFilter per (FilterSets, device): every evaluation of a run
    (valid, test, train) reuses the resident CSR."""
    cache = getattr(filters, "_device_filter_cache", None)
    if cache is None:
        cache = filters._device_filter_cache = {}
    key = str(torch.device(device))
    if key not in cache:
        cache[key] = DeviceFilter(filters, device)
    return cache[key]


def eff_eval_batch(spec: ModelSpec, test_batch_size: int) -> int:
    """Rows per device-filter eval batch: at least 16 for the distance
    family, 128 for bilinear models, as in the JAX package (ranks are
    per-triple, so metrics do not depend on it)."""
    floor = 128 if spec.model_name in DENSE_MODELS else 16
    return max(test_batch_size, floor)


def metrics_from_ranks(ranks) -> List[Dict[str, float]]:
    """Per-triple log dicts with the reference's names (codes/model.py ≈L370-380)."""
    out = []
    for rk in ranks:
        rk = float(rk)
        out.append({
            "MRR": 1.0 / rk,
            "MR": rk,
            "HITS@1": 1.0 if rk <= 1 else 0.0,
            "HITS@3": 1.0 if rk <= 3 else 0.0,
            "HITS@10": 1.0 if rk <= 10 else 0.0,
        })
    return out


def split_ranks(
    params: kge.Params,
    spec: ModelSpec,
    test_triples: np.ndarray,
    filters: FilterSets,
    test_batch_size: int = 4,
    eval_chunk_size: int = 4096,
    modes: Sequence[str] = (scorers.HEAD_BATCH, scorers.TAIL_BATCH),
    test_log_steps: int = 1000,
    logger=None,
    use_kernel: Optional[bool] = None,
    device_filter: Optional[bool] = None,
) -> np.ndarray:
    """Filtered ranks of every triple of a split: i64[len(modes), n].

    ``use_kernel``: None ranks through the CUDA kernel when the params are
    on CUDA; False forces the plain chunked path. ``device_filter``: None
    builds masks on the device when the params are on CUDA and the key
    space is small enough; False paints them on the host."""
    device = params["entity_embedding"].device
    on_cuda = device.type == "cuda"
    if on_cuda and spec.model_name not in rank_kernel.FAMILIES:
        raise rank_kernel.unported(spec.model_name)
    if use_kernel is None:
        use_kernel = on_cuda
    key_space = spec.nentity * spec.nrelation
    if device_filter is None:
        device_filter = on_cuda and key_space <= MAX_DENSE_KEYS
    elif device_filter and key_space >= 2**31:
        if logger is not None:
            logger.warning(
                "--eval_filter device: composite key space E*R = %d "
                "exceeds int32; using host filter masks", key_space)
        device_filter = False

    n_real = len(test_triples)
    if n_real == 0:
        return np.zeros((len(modes), 0), np.int64)
    chunk = min(eval_chunk_size, spec.nentity)
    ranker = rank_kernel.get_ranker(params, spec) if use_kernel else None

    def rank(pos, mask, mode):
        if ranker is not None:
            return ranker.ranks(pos, mask, mode)
        return ranks_batch(params, pos, mask, spec=spec, mode=mode, chunk=chunk)

    total = n_real * len(modes)
    out: List[torch.Tensor] = []
    if device_filter:
        dev_filter = get_device_filter(filters, device)
        eff_batch = eff_eval_batch(spec, test_batch_size)
        if eff_batch != test_batch_size and logger is not None:
            logger.info(
                "device eval path: batching %d triples per dispatch "
                "(--test_batch_size %d kept for metrics; ranks are "
                "per-triple so results are identical)",
                eff_batch, test_batch_size,
            )
        n_pad = _cdiv(n_real, eff_batch) * eff_batch
        trip = np.asarray(test_triples, np.int64)
        if n_pad != n_real:
            trip = np.concatenate([trip, np.repeat(trip[-1:], n_pad - n_real, axis=0)])
        trip_stack = torch.from_numpy(trip).to(device).reshape(-1, eff_batch, 3)
        nb = trip_stack.shape[0]
        width = max(_cdiv(spec.nentity, chunk) * chunk, spec.nentity + 1)
        log_every = max(1, test_log_steps)
        for m, mode in enumerate(modes):
            for b in range(nb):
                pos = trip_stack[b]
                out.append(rank(pos, dev_filter.mask_rows(pos, mode, width), mode))
                if logger is not None and ((b + 1) % log_every == 0 or b + 1 == nb):
                    done = min((b + 1) * eff_batch, n_real) + n_real * m
                    logger.info("Evaluating the model... (%d/%d)", done, total)
        ranks = torch.cat(out).cpu().numpy().reshape(len(modes), n_pad)
        return ranks[:, :n_real].astype(np.int64)

    done = 0
    for mode in modes:
        for i in range(0, n_real, test_batch_size):
            pos = np.asarray(test_triples[i:i + test_batch_size], np.int64)
            B = pos.shape[0]
            if B < test_batch_size:  # pad to the batch size, drop pad ranks
                pos = np.concatenate([pos, np.repeat(pos[-1:], test_batch_size - B, axis=0)])
            mask = torch.from_numpy(
                _pad_mask(filters.filter_mask_rows(pos, mode), chunk)).to(device)
            out.append(rank(torch.from_numpy(pos).to(device), mask, mode)[:B])
            done += B
            if logger is not None and (
                    (done // test_batch_size) % max(1, test_log_steps) == 0):
                logger.info("Evaluating the model... (%d/%d)", done, total)
    return torch.cat(out).cpu().numpy().reshape(len(modes), n_real).astype(np.int64)


def test_step(params: kge.Params, spec: ModelSpec, test_triples: np.ndarray,
              filters: FilterSets, **kw) -> Dict[str, float]:
    """Full filtered-ranking evaluation: both corruption directions, mean
    over all (triple, direction) pairs (codes/model.py ≈L340-388). Keyword
    arguments are those of ``split_ranks``."""
    logs: List[Dict[str, float]] = []
    for ranks in split_ranks(params, spec, test_triples, filters, **kw):
        logs.extend(metrics_from_ranks(ranks))
    if not logs:
        return {}
    return {k: float(np.mean([lg[k] for lg in logs])) for k in logs[0]}
