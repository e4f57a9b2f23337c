"""Host-side rejection-sampled negative batches.

Counterpart of ``knowledgegraphembedding_tpu/sampler/negative.py``
(reference: codes/dataloader.py §TrainDataset.__getitem__ ≈L32-60,
§BidirectionalOneShotIterator ≈L165-190). Negatives are uniform entity
draws, rejection-filtered against the TRAIN-split true heads or tails, as
fixed-size ``[B, n]`` int32 arrays. The numpy and native backends draw
exactly as the JAX package's do, so one seed gives the same batches in both
packages.

``PrefetchIterator`` samples on a background thread. Given a CUDA device it
also uploads each batch from that thread, from pinned host memory on a side
stream, so the copy of batch i+1 runs under the device work of step i.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..data.filterset import subsampling_weights
from ..utils import profiling

HEAD_BATCH = "head-batch"
TAIL_BATCH = "tail-batch"

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray, str]  # pos, neg, weight, mode


class TrainSampler:
    """Reference-distribution training batches for one mode.

    Epochs follow ``DataLoader(shuffle=True)`` and the infinite
    ``one_shot_iterator``: a fresh permutation of the train split every
    epoch, the last short batch of an epoch topped up from the next one so
    shapes stay fixed. ``backend``: 'auto' uses the native library when it
    builds and numpy otherwise; 'native' raises when it cannot build.

    ``negative_sharing='batch'``: one uniform, unfiltered ``[1, n]`` draw a
    batch, shared by every positive (PBG-style; the false-negative rate is
    the average true-set size over E), drawn from the same generator after
    the batch's epoch indices, as the JAX package draws it.

    Fleets (JAX ``negative.py:78-122``): ``index_subset`` restricts the epoch
    permutation to this host's rows of the train split (edge partitioning;
    weights and the rejection filter stay over the FULL split), and
    ``shared_negative_seed`` draws the shared rows from a generator of their
    own, seeded alike on every host, because every rank holds the same
    replicated row."""

    def __init__(self, triples: np.ndarray, nentity: int, nrelation: int,
                 batch_size: int, negative_sample_size: int, mode: str,
                 seed: int = 0, backend: str = "auto", negative_sharing: str = "none",
                 index_subset: Optional[np.ndarray] = None,
                 shared_negative_seed: Optional[int] = None):
        if mode not in (HEAD_BATCH, TAIL_BATCH):
            raise ValueError(f"mode must be {HEAD_BATCH!r} or {TAIL_BATCH!r}, got {mode!r}")
        if backend not in ("auto", "native", "numpy"):
            raise ValueError(f"backend must be 'auto', 'native' or 'numpy', got {backend!r}")
        if negative_sharing not in ("none", "batch"):
            raise ValueError(f"negative_sharing must be 'none' or 'batch', "
                             f"got {negative_sharing!r}")
        self.negative_sharing = negative_sharing
        if len(triples) == 0:
            raise ValueError("empty train split — nothing to sample")
        if backend == "numpy":
            self._native = False
        else:
            from .. import native as native_mod

            self._native = native_mod.available()
            if backend == "native" and not self._native:
                raise RuntimeError("native sampler library unavailable")
        self.triples = np.asarray(triples, np.int32)
        self.nentity = nentity
        self.nrelation = nrelation
        self.batch_size = batch_size
        self.n = negative_sample_size
        self.mode = mode
        self.rng = np.random.default_rng(seed)
        self._shared_neg_rng = (np.random.default_rng(shared_negative_seed)
                                if shared_negative_seed is not None else self.rng)
        self.weights = subsampling_weights(self.triples, nrelation)
        self._index_pool = (np.asarray(index_subset, np.int64) if index_subset is not None
                            else np.arange(len(self.triples), dtype=np.int64))
        if len(self._index_pool) == 0:
            raise ValueError("empty train-stream shard — nothing to sample")
        self._order = np.empty(0, np.int64)
        # train-true set, encoded for one sorted membership test:
        # tail-batch key (h, r) -> (h*R + r)*E + t; head-batch (r, t) -> (r*E + t)*E + h
        h = self.triples[:, 0].astype(np.int64)
        r = self.triples[:, 1].astype(np.int64)
        t = self.triples[:, 2].astype(np.int64)
        if mode == TAIL_BATCH:
            enc = (h * nrelation + r) * nentity + t
        else:
            enc = (r * nentity + t) * nentity + h
        self._true_enc = np.unique(enc)
        counts = np.unique(self._true_enc // nentity, return_counts=True)[1]
        if counts.size and counts.max() >= nentity:
            raise ValueError(
                "a positive's TRAIN-true partner set covers every entity — "
                "no valid negatives exist; rejection sampling cannot "
                f"terminate (mode={mode})")

    def _next_indices(self) -> np.ndarray:
        while self._order.size < self.batch_size:
            self._order = np.concatenate(
                [self._order, self.rng.permutation(self._index_pool)])
        idx, self._order = self._order[:self.batch_size], self._order[self.batch_size:]
        return idx

    def next_batch(self) -> Batch:
        with profiling.span("sampler.sample"):
            idx = self._next_indices()
            pos = self.triples[idx]
            if self.negative_sharing == "batch":
                neg = self._shared_neg_rng.integers(0, self.nentity,
                                                    size=(1, self.n)).astype(np.int32)
            else:
                neg = self._sample_negatives_batch(pos)
            profiling.count("sampler.kept", neg.size)
        return pos, neg, self.weights[idx], self.mode

    def _row_keys(self, pos: np.ndarray) -> np.ndarray:
        h = pos[:, 0].astype(np.int64)
        r = pos[:, 1].astype(np.int64)
        t = pos[:, 2].astype(np.int64)
        if self.mode == TAIL_BATCH:
            return h * self.nrelation + r
        return r * self.nentity + t

    def _member(self, keys: np.ndarray, cand: np.ndarray) -> np.ndarray:
        """bool mask of the candidates that are train-true for their row."""
        enc = keys[:, None] * self.nentity + cand
        idx = np.searchsorted(self._true_enc, enc)
        idx_c = np.minimum(idx, len(self._true_enc) - 1)
        return (self._true_enc[idx_c] == enc) & (idx < len(self._true_enc))

    def _sample_negatives_batch(self, pos: np.ndarray) -> np.ndarray:
        """Draw 2n per row, drop collisions, keep the first n survivors in
        draw order; redraw only for rows still short. Per slot: iid uniform
        over the non-true entities, as the reference's loop. Counts the
        train-true draws as ``sampler.rejected``."""
        B, n = pos.shape[0], self.n
        keys = self._row_keys(pos)
        if self._native:
            from .. import native as native_mod

            neg, draws = native_mod.sample_negatives(
                self._true_enc, keys, self.nentity, n,
                seed=int(self.rng.integers(0, 2**63)))
            profiling.count("sampler.rejected", draws - neg.size)
            return neg
        cand = self.rng.integers(0, self.nentity, size=(B, 2 * n))
        ok = ~self._member(keys, cand)
        counting = profiling.enabled()
        rejected = int(ok.size - np.count_nonzero(ok)) if counting else 0
        order = np.argsort(~ok, axis=1, kind="stable")  # survivors first
        neg = np.take_along_axis(cand, order[:, :n], axis=1).astype(np.int32)
        for i in np.nonzero(ok.sum(axis=1) < n)[0]:
            row = cand[i][ok[i]]
            while row.size < n:
                extra = self.rng.integers(0, self.nentity, size=2 * n)
                m = self._member(keys[i:i + 1], extra[None, :])[0]
                if counting:
                    rejected += int(np.count_nonzero(m))
                row = np.concatenate([row, extra[~m]])
            neg[i] = row[:n]
        if counting:
            profiling.count("sampler.rejected", rejected)
        return neg


class BidirectionalIterator:
    """Strict tail/head alternation, tail-batch first: the step counter is
    incremented before the parity check (codes/dataloader.py
    §BidirectionalOneShotIterator)."""

    def __init__(self, head_sampler: TrainSampler, tail_sampler: TrainSampler):
        self.head_sampler = head_sampler
        self.tail_sampler = tail_sampler
        self.step = 0

    def __iter__(self) -> Iterator[Batch]:
        return self

    def __next__(self) -> Batch:
        with profiling.span("sampler.next"):
            self.step += 1
            if self.step % 2 == 0:
                return self.head_sampler.next_batch()
            return self.tail_sampler.next_batch()

    def close(self) -> None:
        """Nothing to release; the same lifecycle as ``PrefetchIterator``."""


def _upload(batch: Batch, device: torch.device, stream: "torch.cuda.Stream"):
    """Pinned host copies, uploaded with non_blocking copies on ``stream``;
    returns the device tensors and an event recorded after the copies. The
    caching host allocator keeps each pinned block until its copy is done."""
    pos, neg, w, mode = batch
    with profiling.span("sampler.upload"), torch.cuda.stream(stream):
        out = tuple(torch.from_numpy(np.ascontiguousarray(x)).pin_memory()
                    .to(device, non_blocking=True) for x in (pos, neg, w))
        ev = torch.cuda.Event()
        ev.record(stream)
    return out, mode, ev


class PrefetchIterator:
    """Background-thread prefetch queue of ``depth`` batches between the
    sampler and the train step, in place of DataLoader workers.

    ``device``: a CUDA device makes the worker upload each batch (see
    ``_upload``); the consumer's stream then waits on the batch's event, and
    each tensor is marked as used on that stream so the allocator does not
    recycle it while the step may still read it. ``None`` yields numpy."""

    def __init__(self, inner, depth: int = 4, device: Optional[torch.device] = None):
        if device is not None and torch.device(device).type != "cuda":
            raise ValueError(f"upload device must be CUDA, got {device}")
        self.inner = inner
        self.device = None if device is None else torch.device(device)
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            stream = torch.cuda.Stream(self.device) if self.device is not None else None
            while not self._stop.is_set():
                item = next(self.inner)
                if stream is not None:
                    item = _upload(item, self.device, stream)
                while not self._stop.is_set():
                    try:
                        self.q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # re-raised on the consumer side
            self._exc = e

    def __iter__(self):
        return self

    def __next__(self):
        with profiling.span("sampler.next"):
            if profiling.enabled():
                profiling.count("sampler.batches")
                profiling.count("sampler.starved", int(self.q.empty()))
            with profiling.span("sampler.queue_get"):
                while True:  # batches queued before a worker failure come first
                    try:
                        item = self.q.get(timeout=0.1)
                        break
                    except queue.Empty:
                        if self._exc is not None:
                            raise self._exc
            if self.device is None:
                return item
            tensors, mode, ev = item
            current = torch.cuda.current_stream(self.device)
            current.wait_event(ev)
            for t in tensors:
                t.record_stream(current)
            return (*tensors, mode)

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


def build_train_iterator(train: np.ndarray, nentity: int, nrelation: int,
                         batch_size: int, negative_sample_size: int, seed: int = 0,
                         prefetch_depth: int = 4, backend: str = "auto",
                         device: Optional[torch.device] = None,
                         negative_sharing: str = "none",
                         index_subset: Optional[np.ndarray] = None,
                         shared_negative_seed: Optional[int] = None):
    """The two samplers of codes/run.py §main (head-batch seeded ``seed``,
    tail-batch ``seed + 1``), alternated, behind a prefetch queue when
    ``prefetch_depth > 0``; ``device`` (CUDA) uploads from that queue.
    ``backend='device'`` builds the device-resident sampler
    (``device_sampler.py``) on ``device`` (the CPU when None), whose
    lookahead queue holds ``prefetch_depth // 2`` batches (at least one).
    ``negative_sharing='batch'`` draws one shared ``[1, n]`` row a batch.
    ``index_subset`` and ``shared_negative_seed``: a fleet host's stream
    (``TrainSampler``)."""
    if backend == "device":
        from .device_sampler import build_device_iterator

        return build_device_iterator(
            train, nentity, nrelation, batch_size, negative_sample_size, seed=seed,
            negative_sharing=negative_sharing, depth=max(1, prefetch_depth // 2),
            index_subset=index_subset,
            device=device if device is not None else torch.device("cpu"))
    kw = dict(backend=backend, negative_sharing=negative_sharing, index_subset=index_subset)
    head = TrainSampler(train, nentity, nrelation, batch_size, negative_sample_size,
                        HEAD_BATCH, seed=seed, shared_negative_seed=shared_negative_seed,
                        **kw)
    tail = TrainSampler(train, nentity, nrelation, batch_size, negative_sample_size,
                        TAIL_BATCH, seed=seed + 1,
                        shared_negative_seed=(None if shared_negative_seed is None
                                              else shared_negative_seed + 1), **kw)
    it = BidirectionalIterator(head, tail)
    if prefetch_depth > 0:
        return PrefetchIterator(it, depth=prefetch_depth, device=device)
    return it
