"""Device-resident negative sampler: the gap sampler over a resident CSR.

Counterpart of the single-device half of
``knowledgegraphembedding_tpu/sampler/device_sampler.py`` (reference:
codes/dataloader.py §TrainDataset.__getitem__ ≈L32-60). The training
triples, the word2vec subsampling weights and the TRAIN-true filter sets
live on the device; a batch is drawn there by plain torch ops. Per step the
host uploads only a ``[B]`` int32 vector of epoch-permutation indices, from
pinned memory without blocking.

Filter sets: a dense CSR over the composite key (tail-batch ``h·R + r`` ->
true tails, head-batch ``r·E + t`` -> true heads), its values sorted and
deduplicated per key. Negatives are gap-sampled: ``u ~ U[0, E - c_b)`` per
slot, shifted past the key's true values by the order-statistic identity
``result = u + |{j < c : v_j - j <= u}|``, which gives the u-th smallest
entity that is not a true partner (``gap_map``). ``torch.searchsorted`` of u
against each row's non-decreasing ``v_j - j`` (sentinel-padded past the
count) computes that count in one call, where the JAX package compares in
chunks of 16.

The draw. JAX draws u with threefry; the port cannot give threefry's bits,
and bit-identical draws are a non-goal in the JAX package too
(distribution parity is the contract). Here u comes from a counter-based
generator written in int64 torch ops, so it

- is a pure function of (seed, mode, draw index, row, slot): the fused
  trainer (``fused_train.py``) takes its draw index from the global step,
  so a block of k steps draws what k single steps or a resumed run draw;
- reads the draw index from a device tensor, so a captured CUDA graph draws
  fresh numbers on every replay with no host work;
- gives the same integers on the CPU and on the card (integer ops only;
  every product is of a 32-bit value and a 16-bit half, below 2^49, so no
  signed overflow);
- is uniform on each row's range: a 64-bit block (element counter, draw
  index) goes through a four-round Feistel network keyed by (seed, mode),
  with the lowbias32 mixer (hash-prospector constants) as its round
  function; its 63 bits are reduced by the modulus ``E - c_b``, a relative
  bias below ``(E - c_b) / 2^63``, under 2^-40 for any E below 2^23.

Shared negatives (``--negative_sharing batch``) build no CSR: a batch draws
one unfiltered ``[1, n]`` row, the same generator's bits for (seed, mode,
draw index, slot) reduced by the modulus E.

On a mesh (``MeshDeviceSampler``) each rank draws its own rows of the
global batch on its device: the host's epoch stream gives the host's
indices, the rank keeps its rows of them, and the rank folds into the
counter the global index of its first element, so its draws are those of
the global batch's rows on one device (distinct per rank, and the same
integers at any mesh size). A shared row keeps the unfolded counter, the
same ``[1, n]`` on every rank.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..data.filterset import TrueIndex, dense_key_arrays, subsampling_weights
from ..utils import profiling
from .negative import HEAD_BATCH, TAIL_BATCH

_M32 = 0xFFFFFFFF
_MEMBER_CHUNK = 16  # window columns compared at once by csr_member


def _mul32(x, c: int):
    """``x * c mod 2^32`` for ``x`` in [0, 2^32) (an int or an int64
    tensor) and a constant ``c`` in [0, 2^32), from c's 16-bit halves: each
    product stays below 2^48."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def _hash32(x):
    """lowbias32 (hash-prospector): a bijective 32-bit mixer, on an int or
    an int64 tensor holding 32-bit values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x21F0AAAD)
    x = x ^ (x >> 15)
    x = _mul32(x, 0xD35A2D97)
    return x ^ (x >> 15)


def round_keys(seed: int, mode: str) -> Tuple[int, ...]:
    """The four Feistel round keys of one sampler, from its seed and mode."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    lo, hi = s & _M32, s >> 32
    tag = 1 if mode == TAIL_BATCH else 2
    return tuple(_hash32(_hash32(lo ^ _hash32(4 * tag + i)) ^ hi) for i in range(4))


def uniform_bits(counter: torch.Tensor, draw: torch.Tensor,
                 keys: Sequence[int]) -> torch.Tensor:
    """int64 in [0, 2^63), one per element of ``counter`` (the element's
    index ``row * n + slot``, below 2^32): the Feistel network over the
    block (counter, draw index) under ``keys``. ``draw`` is a 0-d int64
    tensor (the first round's mix of it is scalar work)."""
    left, right = counter, draw & _M32
    for k in keys:
        left, right = right, left ^ _hash32(right ^ k)
    return ((left & 0x7FFFFFFF) << 32) | right


def _windows(csr, qk: torch.Tensor, k_max: int):
    """Each key's ``k_max``-wide window of the values (contiguous reads; the
    values tail is padded, so every window stays in bounds) and its count."""
    starts = csr["offsets"][qk].long()
    cnts = csr["counts"][qk].long()
    j = torch.arange(k_max, device=qk.device)
    return csr["values"][starts[:, None] + j].long(), cnts, j


def csr_member(offsets: torch.Tensor, counts: torch.Tensor, values: torch.Tensor,
               k_max: int, keys: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """bool[B, m]: cand[b, j] in the true-value set of keys[b]. Window
    positions past a key's count hold the next key's values and are masked."""
    windows, cnts, j = _windows({"offsets": offsets, "counts": counts, "values": values},
                                keys, k_max)
    valid = j < cnts[:, None]
    hit = torch.zeros(cand.shape, dtype=torch.bool, device=cand.device)
    for c0 in range(0, k_max, _MEMBER_CHUNK):
        w = windows[:, None, c0:c0 + _MEMBER_CHUNK]
        v = valid[:, None, c0:c0 + _MEMBER_CHUNK]
        hit |= ((cand[:, :, None].long() == w) & v).any(dim=-1)
    return hit


def gap_map(u: torch.Tensor, qk: torch.Tensor, csr, k_max: int, nentity: int) -> torch.Tensor:
    """The order-statistic shift of ``gap_negatives``: map u[b, j] in
    [0, E - c_b) to the u-th smallest entity NOT in key qk[b]'s true set
    (int64). ``searchsorted`` counts the j < c_b with v_j - j <= u; past the
    count the thresholds are ``nentity``, above any u."""
    windows, cnts, j = _windows(csr, qk, k_max)
    thresh = torch.where(j < cnts[:, None], windows - j, nentity)
    return u + torch.searchsorted(thresh, u.long(), right=True)


def gap_negatives(bits: torch.Tensor, qk: torch.Tensor, csr, k_max: int,
                  nentity: int) -> torch.Tensor:
    """i32[B, n] exact uniform draws over the non-TRAIN-true set: ``bits``
    (``uniform_bits``) reduced to u in [0, E - c_b), then ``gap_map``."""
    cnts = csr["counts"][qk].long()
    u = torch.remainder(bits, (nentity - cnts)[:, None])
    return gap_map(u, qk, csr, k_max, nentity).to(torch.int32)


def sample_batch(triples: torch.Tensor, weights: torch.Tensor, csr, k_max: int,
                 keys: Sequence[int], draw: torch.Tensor, counter: torch.Tensor,
                 idx_row: torch.Tensor, mode: str, *, nentity: int, nrelation: int):
    """THE device-side batch draw: positives and weights by epoch index,
    then gap-sampled negatives ([B, n] with n = counter's width), or, with
    no ``csr`` (shared negatives), one uniform row on [0, E) of the
    counter's shape [1, n]. One implementation shared by ``DeviceSampler``
    and the fused train step."""
    pos = triples.index_select(0, idx_row)  # [B, 3]
    weight = weights.index_select(0, idx_row)  # [B]
    if csr is None:
        neg = torch.remainder(uniform_bits(counter, draw, keys), nentity).to(torch.int32)
        return pos, neg, weight
    if mode == TAIL_BATCH:
        qk = pos[:, 0].long() * nrelation + pos[:, 1]
    else:
        qk = pos[:, 1].long() * nentity + pos[:, 2]
    neg = gap_negatives(uniform_bits(counter, draw, keys), qk, csr, k_max, nentity)
    return pos, neg, weight


def draw_index(step: torch.Tensor, mode: str) -> torch.Tensor:
    """The draw index of global step ``step`` (a 0-d int64 tensor): tail
    draws happen at even steps 0, 2, ... (tail-first alternation), so
    tail's index at step s is s//2 + 1 and head's (s-1)//2 + 1, the same as
    a per-step ``DeviceSampler``'s count of its own draws from step 0."""
    if mode == TAIL_BATCH:
        return torch.div(step, 2, rounding_mode="floor") + 1
    return torch.div(step - 1, 2, rounding_mode="floor") + 1


def validate_key_space(nentity: int, nrelation: int, negative_sharing: str) -> None:
    """Only the filtering CSR needs int32 composite keys; the shared-negative
    mode draws unfiltered. One guard for every device sampler variant."""
    if negative_sharing != "batch" and int(nentity) * int(nrelation) >= 2**31:
        raise ValueError(
            "device sampler pair-key space exceeds int32 "
            f"(E*R = {nentity * nrelation}); use a host sampler backend")


def build_mode_csr(triples: np.ndarray, nentity: int, nrelation: int, mode: str):
    """(offsets, counts, values, k_max) numpy arrays of the TRAIN-true CSR
    for one corruption mode. Guards against a key whose true set covers
    EVERY entity (no negative exists for it)."""
    h, r, t = triples[:, 0], triples[:, 1], triples[:, 2]
    if mode == TAIL_BATCH:
        keys, vals, n_keys = h.astype(np.int64) * nrelation + r, t, nentity * nrelation
    else:
        keys, vals, n_keys = r.astype(np.int64) * nentity + t, h, nrelation * nentity
    uniq_pairs = np.unique(keys.astype(np.int64) * nentity + vals)
    counts = np.unique(uniq_pairs // nentity, return_counts=True)[1]
    if counts.size and counts.max() >= nentity:
        raise ValueError(
            "a positive's TRAIN-true partner set covers every entity "
            f"— no valid negatives exist (mode={mode})")
    # gap sampling needs each key's values unique and sorted (the shift
    # counts strict gaps): built from the deduplicated pairs
    idx = TrueIndex.build(uniq_pairs // nentity, (uniq_pairs % nentity).astype(np.int32))
    return dense_key_arrays(idx, n_keys, pad_value=nentity)


class _EpochIndexStream:
    """Host-side epoch permutation stream (the DataLoader(shuffle=True) and
    infinite-iterator semantics of negative.py): ``count`` row indices per
    call from reshuffled passes over the pool; the JAX package's stream for
    the same seed, bit for bit."""

    def __init__(self, n_train: int, index_subset, seed: int, count: int):
        self._pool = (np.asarray(index_subset, np.int64) if index_subset is not None
                      else np.arange(n_train, dtype=np.int64))
        if len(self._pool) == 0:
            raise ValueError("empty train-stream shard — nothing to sample")
        self._order = np.empty(0, np.int64)
        self._rng = np.random.default_rng(seed)
        self._count = count

    def next(self) -> np.ndarray:
        while self._order.size < self._count:
            self._order = np.concatenate([self._order, self._rng.permutation(self._pool)])
        idx, self._order = self._order[:self._count], self._order[self._count:]
        return idx.astype(np.int32)


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: from pinned memory without blocking on
    CUDA (the caching host allocator keeps the pinned block until the copy
    is done)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class _DeviceCSR:
    """Device-resident CSR over a dense composite-key space: for key k the
    true values are ``values[offsets[k] : offsets[k] + counts[k]]``."""

    def __init__(self, keys: np.ndarray, vals: np.ndarray, n_keys: int, sentinel: int,
                 device="cpu"):
        idx = TrueIndex.build(keys.astype(np.int64), vals)
        self._load(*dense_key_arrays(idx, n_keys, pad_value=sentinel), device)

    @classmethod
    def from_arrays(cls, offsets, counts, values, k_max: int, device="cpu") -> "_DeviceCSR":
        self = cls.__new__(cls)
        self._load(offsets, counts, values, k_max, device)
        return self

    def _load(self, offsets, counts, values, k_max, device):
        self.offsets, self.counts, self.values = (
            torch.from_numpy(np.asarray(a, np.int32)).to(device) for a in (offsets, counts, values))
        self.k_max = int(k_max)

    def arrays(self) -> dict:
        return {"offsets": self.offsets, "counts": self.counts, "values": self.values}

    def member(self, keys: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
        return csr_member(self.offsets, self.counts, self.values, self.k_max, keys, cand)


class DeviceSampler:
    """Device-resident train-batch sampler for one corruption mode.

    The host keeps only the epoch permutation stream; positives, weights and
    negatives are drawn on ``device`` from resident state. ``draws`` counts
    this sampler's draws on the device; the k-th draw uses draw index k.
    With ``negative_sharing='batch'`` it holds no CSR (``csr`` is None) and
    draws one shared ``[1, n]`` row a batch."""

    def __init__(self, triples: np.ndarray, nentity: int, nrelation: int, batch_size: int,
                 negative_sample_size: int, mode: str, seed: int = 0,
                 negative_sharing: str = "none", index_subset=None, shared_state=None,
                 device="cpu", counter_offset: int = 0):
        if mode not in (HEAD_BATCH, TAIL_BATCH):
            raise ValueError(f"mode must be {HEAD_BATCH!r} or {TAIL_BATCH!r}, got {mode!r}")
        if negative_sharing not in ("none", "batch"):
            raise ValueError(f"negative_sharing must be 'none' or 'batch', "
                             f"got {negative_sharing!r}")
        triples = np.asarray(triples, np.int32)
        if len(triples) == 0:
            raise ValueError("empty train split — nothing to sample")
        validate_key_space(nentity, nrelation, negative_sharing)
        if counter_offset + batch_size * negative_sample_size > 2**32:
            raise ValueError("a batch's B*n draws must have 32-bit element counters")
        self.device = torch.device(device)
        self.mode = mode
        self.nentity = nentity
        self.nrelation = nrelation
        self.batch_size = batch_size
        self.n = negative_sample_size
        self.negative_sharing = negative_sharing
        self.n_train = len(triples)
        # triples and weights are mode-independent: one copy for both samplers
        if shared_state is not None:
            self.triples, self.weights = shared_state
        else:
            self.triples = torch.from_numpy(triples).to(self.device)
            self.weights = torch.from_numpy(subsampling_weights(triples, nrelation)).to(self.device)
        shared = negative_sharing == "batch"
        self.csr = None if shared else _DeviceCSR.from_arrays(
            *build_mode_csr(triples, nentity, nrelation, mode), device=self.device)
        self.keys = round_keys(seed, mode)
        rows = 1 if shared else batch_size
        self.counter = torch.arange(counter_offset, counter_offset + rows * self.n,
                                    dtype=torch.int64, device=self.device).view(rows, self.n)
        self.draws = torch.zeros((), dtype=torch.int64, device=self.device)
        self._stream = _EpochIndexStream(self.n_train, index_subset, seed, batch_size)

    def _next_indices(self) -> np.ndarray:
        return self._stream.next()

    def sample(self, idx_row: torch.Tensor, draw: torch.Tensor):
        """(pos, neg, weight) for epoch indices ``idx_row`` [B] at draw index
        ``draw`` (0-d int64), both on the device."""
        csr, k_max = (None, 0) if self.csr is None else (self.csr.arrays(), self.csr.k_max)
        return sample_batch(self.triples, self.weights, csr, k_max, self.keys, draw,
                            self.counter, idx_row, self.mode, nentity=self.nentity,
                            nrelation=self.nrelation)

    def next_batch(self):
        """The host half of a draw: the epoch indices, their upload (the
        only per-step upload) and the enqueue of the draw on the device."""
        with profiling.span("sampler.indices"):
            idx = self._next_indices()
        with profiling.span("sampler.upload"):
            idx = upload(idx, self.device)
        with profiling.span("sampler.draw"):
            self.draws.add_(1)
            pos, neg, weight = self.sample(idx, self.draws)
        if profiling.enabled():
            profiling.count("sampler.kept", neg.numel())
        return pos, neg, weight, self.mode


class DeviceBidirectionalIterator:
    """Tail-first strict alternation (the contract of negative.py
    §BidirectionalIterator) with a lookahead queue: batch k+depth is
    enqueued on the device before batch k is returned."""

    def __init__(self, head: DeviceSampler, tail: DeviceSampler, depth: int = 2):
        self._samplers = (head, tail)  # odd counter -> tail: the first batch is tail-batch
        self.step = 0
        self._queue: list = []
        self._depth = max(1, depth)
        for _ in range(self._depth):
            self._enqueue()

    def _enqueue(self):
        self.step += 1
        self._queue.append(self._samplers[self.step % 2].next_batch())

    def __iter__(self):
        return self

    def __next__(self):
        with profiling.span("sampler.next"):
            profiling.count("sampler.batches")
            self._enqueue()
            return self._queue.pop(0)

    def close(self):
        self._queue.clear()


def build_device_iterator(train: np.ndarray, nentity: int, nrelation: int, batch_size: int,
                          negative_sample_size: int, seed: int = 0,
                          negative_sharing: str = "none", depth: int = 2,
                          index_subset=None, device="cpu") -> DeviceBidirectionalIterator:
    """The head (seed) and tail (seed + 1) device samplers, alternated."""
    head = DeviceSampler(train, nentity, nrelation, batch_size, negative_sample_size,
                         HEAD_BATCH, seed=seed, negative_sharing=negative_sharing,
                         index_subset=index_subset, device=device)
    tail = DeviceSampler(train, nentity, nrelation, batch_size, negative_sample_size,
                         TAIL_BATCH, seed=seed + 1, negative_sharing=negative_sharing,
                         index_subset=index_subset, shared_state=(head.triples, head.weights),
                         device=device)
    return DeviceBidirectionalIterator(head, tail, depth=depth)



class MeshDeviceSampler(DeviceSampler):
    """A rank's device sampler on a 1-D mesh (JAX ``MeshDeviceSampler``):
    it draws rows ``multihost.local_rows`` of each global batch on the
    rank's device. The host stream is the host's epoch permutation over its
    edge-partition shard (``index_subset``) at the host batch size, seeded
    ``seed + 7919 * host``, as the JAX sampler's; the draws are keyed by
    ``seed`` alone, the rank folded into the counter."""

    def __init__(self, triples: np.ndarray, nentity: int, nrelation: int, batch_size: int,
                 negative_sample_size: int, mode: str, mesh, seed: int = 0,
                 negative_sharing: str = "none", index_subset=None, shared_state=None):
        from ..parallel import multihost, sharding

        n_data, n_proc = sharding.data_size(mesh), multihost.process_count()
        if batch_size % n_data:
            raise ValueError(f"global batch {batch_size} not divisible by the "
                             f"{n_data}-device mesh")
        if batch_size % n_proc:
            raise ValueError(f"global batch {batch_size} not divisible by {n_proc} hosts")
        if batch_size * negative_sample_size > 2**32:
            raise ValueError("a batch's B*n draws must have 32-bit element counters")
        local_b = batch_size // n_data
        self._rows = multihost.local_rows(mesh, batch_size)
        offset = 0 if negative_sharing == "batch" else (
            sharding.data_index(mesh) * local_b * negative_sample_size)
        super().__init__(triples, nentity, nrelation, local_b, negative_sample_size, mode,
                         seed=seed, negative_sharing=negative_sharing, shared_state=shared_state,
                         device=sharding.mesh_device(mesh), counter_offset=offset)
        self._stream = _EpochIndexStream(self.n_train, index_subset,
                                         seed + 7919 * multihost.process_index(),
                                         batch_size // n_proc)

    def _next_indices(self) -> np.ndarray:
        return self._stream.next()[self._rows]


def build_mesh_device_iterator(mesh, train: np.ndarray, nentity: int, nrelation: int,
                               batch_size: int, negative_sample_size: int, seed: int = 0,
                               negative_sharing: str = "none", depth: int = 2,
                               index_subset=None) -> DeviceBidirectionalIterator:
    """The tail-first pair of mesh samplers (head ``seed``, tail
    ``seed + 1``), each rank's batches its own rows on its device."""
    head = MeshDeviceSampler(train, nentity, nrelation, batch_size, negative_sample_size,
                             HEAD_BATCH, mesh, seed=seed, negative_sharing=negative_sharing,
                             index_subset=index_subset)
    tail = MeshDeviceSampler(train, nentity, nrelation, batch_size, negative_sample_size,
                             TAIL_BATCH, mesh, seed=seed + 1, negative_sharing=negative_sharing,
                             index_subset=index_subset,
                             shared_state=(head.triples, head.weights))
    return DeviceBidirectionalIterator(head, tail, depth=depth)
