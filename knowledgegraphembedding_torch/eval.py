"""Filtered link-prediction evaluation.

Counterpart of ``knowledgegraphembedding_tpu/eval.py`` (reference:
codes/model.py §test_step ≈L332-390, codes/dataloader.py §TestDataset
≈L118-162). ``rank = 1 + #{unfiltered candidates with score > true score}``,
which equals the reference's argsort rank without materializing or sorting a
``[B, E]`` score row. The rankers:

  - ``ops.rank_kernel.Ranker``: the fused CUDA kernel for RotatE, TransE
    and pRotatE (the default on CUDA);
  - ``ranks_batch``: the plain chunked path in PyTorch ops, which scores the
    true entity in the batch layout as the JAX package's ``ranks_batch``;
    for DistMult and ComplEx one dense matmul scores every candidate;
  - ``dense_ranks_window``: DistMult and ComplEx with the device-resident
    filter CSR, correcting the unfiltered count by the row's CSR window
    instead of building a ``[B, W]`` mask.

Filter masks come from the host CSR (``FilterSets.filter_mask_rows``) or are
built on the device from a resident CSR (``DeviceFilter``). With the resident
CSR a split is ranked in chunks of up to ``_SCAN_CHUNK`` batches, the
counterparts of the JAX package's whole-evaluation scans
(``_eval_scan_pallas``, ``_eval_scan_xla``): on CUDA each chunk body is
captured once as a CUDA graph (``_ChunkGraph``) and every chunk replays it,
so the host does O(1) work a chunk; on the CPU the body runs eagerly. The
countries datasets are scored by AUC-PR instead (``countries_auc_pr``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import ModelSpec
from .cuda_graphs import Capturer
from .data.filterset import MAX_DENSE_KEYS, FilterSets, dense_key_arrays
from .models import kge, scorers
from .ops import matmul_scoring, rank_kernel
from .utils import profiling

#: bilinear models rank through dense matmul scoring
DENSE_MODELS = matmul_scoring.DENSE_MODELS
#: batches one scan chunk ranks (the JAX package's ``_SCAN_CHUNK``): one
#: captured graph shape serves every split size
_SCAN_CHUNK = 32


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def ranks_batch(params: kge.Params, pos: torch.Tensor, filter_mask: torch.Tensor,
                *, spec: ModelSpec, mode: str, chunk: int) -> torch.Tensor:
    """Filtered ranks (1-based) of the true entity for one eval batch.

    pos i64[B, 3]; filter_mask bool[B, >= ceil(E/chunk)*chunk], True =
    known-true corruption (the positive itself unfiltered)."""
    ent = params["entity_embedding"]
    rel = params["relation_embedding"]
    E = spec.nentity
    pos = pos.to(torch.int64)
    if spec.model_name in DENSE_MODELS:
        # one matmul scores every candidate; the true entity's score is an
        # element of the same row, so strict > never counts it
        scores = matmul_scoring.dense_scores_all(spec, params, pos, mode)  # [B, E]
        true_ids = pos[:, 0] if mode == scorers.HEAD_BATCH else pos[:, 2]
        true_score = torch.gather(scores, 1, true_ids[:, None])
        beats = (scores > true_score) & filter_mask[:, :E].logical_not()
        return torch.sum(beats, dim=1, dtype=torch.int32) + 1
    n_chunks = _cdiv(E, chunk)
    if filter_mask.shape[1] < n_chunks * chunk:
        raise ValueError(f"filter mask width {filter_mask.shape[1]} < "
                         f"{n_chunks * chunk} (pad it with _pad_mask)")

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


@torch.no_grad()
def dense_ranks_window(params: kge.Params, pos: torch.Tensor, offsets: torch.Tensor,
                       counts: torch.Tensor, values: torch.Tensor, *, spec: ModelSpec,
                       mode: str, k_max: int) -> torch.Tensor:
    """Filtered ranks for the bilinear models with no [B, W] filter mask:
    rank = 1 + #{candidates beating the true} - #{filtered candidates
    beating it}. A row's filtered candidates are exactly its CSR window
    (at most k_max distinct ids), so the correction is one [B, k_max]
    gather from the score block (the JAX package's ``dense_ranks_window``).
    pos i64[B, 3]; offsets, counts, values: the resident CSR of ``mode``."""
    pos = pos.to(torch.int64)
    scores = matmul_scoring.dense_scores_all(spec, params, pos, mode)  # [B, E]
    E = spec.nentity
    if mode == scorers.HEAD_BATCH:
        keys = pos[:, 1] * E + pos[:, 2]
        true_ids = pos[:, 0]
    else:
        keys = pos[:, 0] * spec.nrelation + pos[:, 1]
        true_ids = pos[:, 2]
    true_score = torch.gather(scores, 1, true_ids[:, None])
    # scores[b, true] is true_score itself, so strict > excludes it exactly
    beats_all = torch.sum(scores > true_score, dim=1, dtype=torch.int32)
    slot = torch.arange(k_max, device=pos.device)
    win = values[offsets[keys].to(torch.int64)[:, None] + slot[None, :]].to(torch.int64)
    valid = slot[None, :] < counts[keys][:, None]
    win_scores = torch.gather(scores, 1, win)
    beats_filtered = torch.sum((win_scores > true_score) & valid & (win != true_ids[:, None]),
                               dim=1, dtype=torch.int32)
    return beats_all - beats_filtered + 1


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
    # the values as device tensors: a Python bool would be copied from the
    # host, which a CUDA graph capture refuses
    true, false = torch.ones((), dtype=torch.bool, device=pos.device), mask.new_zeros(())
    mask.index_put_((rows[:, None].expand(B, k_max), ids), true)
    mask.index_put_((rows, true_ids), false)  # the positive is never filtered
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


def scan_plan(nb: int, log_every: int = _SCAN_CHUNK) -> Tuple[int, int]:
    """(SC, n_scan): batches a scan chunk ranks, and the split's ``nb``
    batches padded to whole chunks, as the JAX package plans them: at most
    ``_SCAN_CHUNK`` batches a chunk and no more than ``log_every`` (the
    single-device driver passes ``--test_log_steps``, 0 counting as 1, so
    that the progress log keeps its cadence)."""
    SC = min(nb, _SCAN_CHUNK, max(1, log_every))
    return SC, _cdiv(nb, SC) * SC


def scan_stack(triples: np.ndarray, eff_batch: int, n_scan: int, device) -> torch.Tensor:
    """i64[n_scan, eff_batch, 3] on ``device``: the triples padded to whole
    batches by repeating the last triple, then to ``n_scan`` batches by
    repeating the last batch (the JAX package's pad rows and pad batches,
    whose ranks are dropped)."""
    trip = np.asarray(triples, np.int64)
    nb = _cdiv(len(trip), eff_batch)
    trip = np.concatenate([trip, np.repeat(trip[-1:], nb * eff_batch - len(trip), axis=0)])
    trip = np.concatenate([trip, np.tile(trip[-eff_batch:], (n_scan - nb, 1))])
    return torch.from_numpy(trip).to(device).reshape(n_scan, eff_batch, 3)


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


def _eval_scan_kernel(ranker: rank_kernel.Ranker, offsets, counts, values,
                      pos_stack: torch.Tensor, *, spec: ModelSpec, mode: str, k_max: int,
                      width: int) -> torch.Tensor:
    """i32[SC, B] ranks of the chunk ``pos_stack`` [SC, B, 3] through the
    rank kernel (JAX ``_eval_scan_pallas``): per batch the device mask,
    ``Ranker.inputs``, ``rank_counts`` and the +1."""
    return torch.stack([
        ranker.ranks(pos, _device_mask(pos, offsets, counts, values, k_max=k_max, mode=mode,
                                       nentity=spec.nentity, nrelation=spec.nrelation,
                                       width=width), mode)
        for pos in pos_stack])


def _eval_scan_plain(params: kge.Params, offsets, counts, values, pos_stack: torch.Tensor, *,
                     spec: ModelSpec, mode: str, chunk: int, k_max: int,
                     width: int) -> torch.Tensor:
    """i32[SC, B] ranks of the chunk ``pos_stack`` [SC, B, 3] in plain
    PyTorch ops (JAX ``_eval_scan_xla``): the bilinear models through
    ``dense_ranks_window``, the distance family through the device mask and
    ``ranks_batch``."""
    def body(pos):
        if spec.model_name in DENSE_MODELS:
            return dense_ranks_window(params, pos, offsets, counts, values, spec=spec,
                                      mode=mode, k_max=k_max)
        mask = _device_mask(pos, offsets, counts, values, k_max=k_max, mode=mode,
                            nentity=spec.nentity, nrelation=spec.nrelation, width=width)
        return ranks_batch(params, pos, mask, spec=spec, mode=mode, chunk=chunk)
    return torch.stack([body(pos) for pos in pos_stack])


# The eval graphs of a device share one capturer: one memory pool (each
# graph's scratch is freed inside its capture, where the next capture reuses
# it; the graphs replay one at a time on the caller's stream) and one side
# stream for warm-up and capture.
_capturers: Dict[int, Capturer] = {}


class _ChunkGraph:
    """One scan chunk body captured as a CUDA graph (``cuda_graphs``, kind
    "eval_chunk"): a static [SC, B, 3] input, a static i32 [SC, B] output,
    the rank-kernel launches the capture recorded, and ``reads``: whatever
    the graph reads that its owner does not hold, kept so that no storage it
    reads is freed and reused while it lives.

    The capture's warm-up is ``warm``, run over the first chunk: every op of
    the body but the rank kernel, whose one-time setup it does instead
    (``rank_kernel.prepare``), so that the allocator, cuBLAS, NCCL and the
    kernel's library are set up and no kernel launch is counted; the capture
    runs nothing. A call copies a chunk in, replays the graph on the current
    stream and adds the recorded launches to ``rank_counts.launches``."""

    def __init__(self, body: Callable, warm: Callable, first: torch.Tensor, reads=()):
        device = first.device
        index = device.index if device.index is not None else torch.cuda.current_device()
        if index not in _capturers:
            _capturers[index] = Capturer(device)
        with profiling.span("eval.capture"):
            self.reads = reads
            self.pos = first.clone()
            before = rank_kernel.rank_counts.captured
            self.graph = _capturers[index].capture("eval_chunk", lambda: body(self.pos),
                                                   warm=lambda: warm(self.pos))
            self.launches = rank_kernel.rank_counts.captured - before

    def __call__(self, chunk: torch.Tensor) -> torch.Tensor:
        """The body's output for ``chunk``, valid until the next call."""
        self.pos.copy_(chunk)
        out = self.graph.replay()
        rank_kernel.rank_counts.launches += self.launches
        return out


def chunk_runner(graphs: dict, key, body: Callable, warm: Callable, on_cuda: bool,
                 reads=()) -> Callable:
    """``body`` itself off CUDA; on CUDA, a callable that replays the graph
    of ``body`` kept in ``graphs`` under ``key``, captured at its first
    call (``_ChunkGraph``)."""
    if not on_cuda:
        return body

    def run(chunk):
        graph = graphs.get(key)
        if graph is None:
            graph = graphs[key] = _ChunkGraph(body, warm, chunk, reads)
        return graph(chunk)
    return run


# Graphs of the plain and dense bodies, which read the params and the
# resident CSR: one entry per (params at their versions, spec, DeviceFilter)
# under the ranker cache's rule (rank_kernel.cached_on_params). An evicted
# entry frees its graphs. The kernel body's graphs live on their Ranker.
_plain_graphs: dict = {}


@torch.no_grad()
def _device_split_ranks(params: kge.Params, spec: ModelSpec, test_triples: np.ndarray,
                        filters: FilterSets, *, test_batch_size: int, chunk: int,
                        modes: Sequence[str], test_log_steps: int, logger, use_kernel: bool,
                        per_batch: bool = False) -> np.ndarray:
    """The device-filter ranks of a split, i64[len(modes), n], as the JAX
    package's ``test_step`` drives its scans: the triples stacked on the
    device in ``eff_eval_batch`` batches padded to whole chunks
    (``scan_plan``, ``scan_stack``), one dispatch a chunk (on CUDA a graph
    replay), the progress logged at JAX's cadence, the pad ranks dropped
    and every rank pulled in one copy. ``per_batch``: one eager body a
    batch, no pad batch and no graph (``_per_batch_ranks``)."""
    device = params["entity_embedding"].device
    n_real = len(test_triples)
    eff_batch = eff_eval_batch(spec, test_batch_size)
    if eff_batch != test_batch_size and logger is not None:
        logger.info(
            "device eval path: batching %d triples per dispatch "
            "(--test_batch_size %d kept for metrics; ranks are "
            "per-triple so results are identical)",
            eff_batch, test_batch_size,
        )
    nb = _cdiv(n_real, eff_batch)
    log_every = max(1, test_log_steps)  # 0 must not zero the chunk or the cadence
    SC, n_scan = (1, nb) if per_batch else scan_plan(nb, log_every)
    with profiling.span("eval.stack"):
        trip_stack = scan_stack(test_triples, eff_batch, n_scan, device)
    width = max(_cdiv(spec.nentity, chunk) * chunk, spec.nentity + 1)
    graphed = device.type == "cuda" and not per_batch
    with profiling.span("eval.lookup"):
        dev_filter = get_device_filter(filters, device)
        if use_kernel:
            ranker = rank_kernel.get_ranker(params, spec)
            graphs, reads = ranker.graphs, (dev_filter,)
        else:
            graphs = rank_kernel.cached_on_params(_plain_graphs, params,
                                                  (spec, id(dev_filter)),
                                                  lambda: (dev_filter, {}))[1]
            reads = ()  # the cache entry holds the params and the DeviceFilter
    total = n_real * len(modes)
    ranks = torch.empty((len(modes), n_scan, eff_batch), dtype=torch.int32, device=device)
    for m, mode in enumerate(modes):
        offsets, counts, values, k_max = dev_filter._modes[mode]
        csr = (offsets, counts, values)
        kw = dict(spec=spec, mode=mode, k_max=k_max, width=width)
        if use_kernel:
            def body(pos_stack, csr=csr, kw=kw):
                return _eval_scan_kernel(ranker, *csr, pos_stack, **kw)

            def warm(pos_stack, csr=csr, mode=mode, k_max=k_max):
                rank_kernel.prepare(device)
                _device_mask(pos_stack[0], *csr, k_max=k_max, mode=mode, nentity=spec.nentity,
                             nrelation=spec.nrelation, width=width)
                ranker.inputs(pos_stack[0], mode)
            key = (mode, SC, eff_batch, k_max, width, id(dev_filter))
        else:
            def body(pos_stack, csr=csr, kw=kw):
                return _eval_scan_plain(params, *csr, pos_stack, chunk=chunk, **kw)

            def warm(pos_stack, body=body):
                body(pos_stack[:1])
            key = (mode, SC, eff_batch, k_max, width, chunk)
        run = chunk_runner(graphs, key, body, warm, graphed, reads)
        last_logged = 0
        with profiling.span("eval.enqueue"):
            for s in range(0, n_scan, SC):
                ranks[m, s:s + SC].copy_(run(trip_stack[s:s + SC]))
                done_b = min(s + SC, nb)
                if logger is not None and (done_b // log_every > last_logged // log_every
                                           or done_b == nb):
                    last_logged = done_b
                    done = min(done_b * eff_batch, n_real) + n_real * m
                    logger.info("Evaluating the model... (%d/%d)", done, total)
    with profiling.span("eval.pull"):
        out = ranks.reshape(len(modes), n_scan * eff_batch)[:, :n_real].cpu()  # the one pull
    return out.numpy().astype(np.int64)


def _per_batch_ranks(params: kge.Params, spec: ModelSpec, test_triples: np.ndarray,
                     filters: FilterSets, test_batch_size: int = 16,
                     eval_chunk_size: int = 4096, use_kernel: Optional[bool] = None,
                     modes: Sequence[str] = (scorers.HEAD_BATCH, scorers.TAIL_BATCH)
                     ) -> np.ndarray:
    """The device-filter ranks of a split with one eager chunk body a batch
    and no graph (the loop that came before the scan), to hold the graphs'
    ranks and pace against on the card. Nothing in the package calls it:
    on CUDA, ``split_ranks`` replays graphs."""
    on_cuda = params["entity_embedding"].device.type == "cuda"
    if use_kernel is None:
        use_kernel = on_cuda and spec.model_name not in DENSE_MODELS
    return _device_split_ranks(params, spec, test_triples, filters,
                               test_batch_size=test_batch_size,
                               chunk=min(eval_chunk_size, spec.nentity), modes=modes,
                               test_log_steps=1000, logger=None, use_kernel=use_kernel,
                               per_batch=True)


@torch.no_grad()
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
    """Filtered ranks of every triple of a split: i64[len(modes), n]. Runs
    without autograd, so params that require grad (training's) build no graph.

    ``use_kernel``: None ranks the distance family through the CUDA kernel
    when the params are on CUDA; False forces the plain chunked path. The
    bilinear models always rank through dense matmuls (True is refused).
    ``device_filter``: None uses the device-resident filter when the params
    are on CUDA and the key space is small enough (bilinear models then
    rank by ``dense_ranks_window``), and ranks the split in scan chunks
    (``_device_split_ranks``; on CUDA replayed from CUDA graphs); False
    paints masks on the host and ranks batch by batch, as JAX does.

    Traced (``utils/profiling``) as the span ``eval.pass``."""
    with profiling.span("eval.pass"):
        device = params["entity_embedding"].device
        on_cuda = device.type == "cuda"
        dense = spec.model_name in DENSE_MODELS
        if dense and use_kernel:
            raise rank_kernel.no_family(spec.model_name)
        if use_kernel is None:
            use_kernel = on_cuda and not dense
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
        if device_filter:
            return _device_split_ranks(params, spec, test_triples, filters,
                                       test_batch_size=test_batch_size, chunk=chunk,
                                       modes=modes, test_log_steps=test_log_steps,
                                       logger=logger, use_kernel=use_kernel)
        with profiling.span("eval.lookup"):
            ranker = rank_kernel.get_ranker(params, spec) if use_kernel else None

        def rank(pos, mask, mode):
            if ranker is not None:
                return ranker.ranks(pos, mask, mode)
            return ranks_batch(params, pos, mask, spec=spec, mode=mode, chunk=chunk)

        total = n_real * len(modes)
        out: List[torch.Tensor] = []
        done = 0
        for mode in modes:
            for i in range(0, n_real, test_batch_size):
                pos = np.asarray(test_triples[i:i + test_batch_size], np.int64)
                B = pos.shape[0]
                if B < test_batch_size:  # pad to the batch size, drop pad ranks
                    pos = np.concatenate([pos, np.repeat(pos[-1:], test_batch_size - B,
                                                         axis=0)])
                with profiling.span("eval.masks"):
                    mask = _pad_mask(filters.filter_mask_rows(pos, mode), chunk)
                mask = torch.from_numpy(mask).to(device)
                out.append(rank(torch.from_numpy(pos).to(device), mask, mode)[:B])
                done += B
                if logger is not None and (
                        (done // test_batch_size) % max(1, test_log_steps) == 0):
                    logger.info("Evaluating the model... (%d/%d)", done, total)
        with profiling.span("eval.pull"):
            ranks = torch.cat(out).cpu()
        return ranks.numpy().reshape(len(modes), n_real).astype(np.int64)


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


# ---- countries: AUC-PR over region candidates (codes/model.py ≈L335-355) ----

def average_precision(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """``sklearn.metrics.average_precision_score`` for binary labels (the
    reference's only sklearn call), in numpy: AP = sum_n (R_n - R_{n-1}) P_n
    over the descending-score sweep, ties counted at the last index of each
    distinct score."""
    order = np.argsort(-y_score, kind="stable")
    y = np.asarray(y_true)[order]
    s = np.asarray(y_score)[order]
    tp = np.cumsum(y)
    n_pos = tp[-1]
    if n_pos == 0:
        return 0.0
    precision = tp / np.arange(1, len(y) + 1)
    recall = tp / n_pos
    distinct = np.r_[s[1:] != s[:-1], True]
    precision, recall = precision[distinct], recall[distinct]
    prev_recall = np.r_[0.0, recall[:-1]]
    return float(np.sum((recall - prev_recall) * precision))


@torch.no_grad()
def countries_auc_pr(params: kge.Params, spec: ModelSpec, test_triples: np.ndarray,
                     regions: Sequence[int], batch_size: int = 1024) -> float:
    """One pooled AP over every (test triple, candidate region): the triple
    (head, relation, region) scored in ``single`` mode on the params' device,
    labelled 1 where the region is the triple's tail."""
    triples = np.asarray(test_triples, np.int64)
    reg = np.asarray(regions, np.int64)
    samples = np.repeat(triples, len(reg), axis=0)
    samples[:, 2] = np.tile(reg, len(triples))
    y_true = (samples[:, 2] == np.repeat(triples[:, 2], len(reg))).astype(np.int64)
    device = params["entity_embedding"].device
    scores = [kge.forward(params, spec, torch.from_numpy(samples[i:i + batch_size]).to(device),
                          scorers.SINGLE)[:, 0].cpu()
              for i in range(0, len(samples), batch_size)]
    return average_precision(y_true, torch.cat(scores).numpy())
