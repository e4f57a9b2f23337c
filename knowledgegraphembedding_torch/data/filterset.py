"""CSR filter-set structures for negative sampling and filtered evaluation.

The reference builds Python dicts ``true_head[(r, t)]`` / ``true_tail[(h, r)]``
for the sampler (reference: codes/dataloader.py §get_true_head_and_tail
≈L92-115) and does an O(nentity) *Python* set-membership loop per eval triple
(codes/dataloader.py §TestDataset.__getitem__ ≈L132-150) — a real bottleneck
on YAGO3-10.  Here both become vectorized numpy CSR structures:

  - ``TrueIndex``: (key -> sorted array of true partners) built once with a
    lexsort, used by the rejection sampler (np.isin against a per-key slice)
    and by the evaluator to paint filter masks row-by-row with fancy
    indexing instead of a per-candidate Python loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np


#: Auto-enable ceiling for the DEVICE-resident filter/sampler structures,
#: which allocate dense per-key arrays over the composite key space E*R
#: (8-16 bytes/key in device memory). 2^26 keys ≈ 0.5-1 GB — comfortably
#: inside one card's memory next to the tables; every reference dataset is
#: ≤ 20M keys.
#: Beyond this the auto paths fall back to host-built filters (explicitly
#: requesting 'device' is still honored up to the int32 key limit).
MAX_DENSE_KEYS = 1 << 26


@dataclass
class TrueIndex:
    """CSR map from a composite key to the sorted array of true partners.

    ``keys`` are encoded as ``a * stride + b`` (e.g. ``h * nrelation + r``).
    ``lookup(key)`` returns a *view* into ``values`` — no copies.
    """

    sorted_keys: np.ndarray  # i64[nnz_keys] unique encoded keys, sorted
    offsets: np.ndarray  # i64[nnz_keys + 1] CSR row pointers
    values: np.ndarray  # i32[nnz] partner entity ids, grouped by key

    @classmethod
    def build(cls, keys: np.ndarray, values: np.ndarray) -> "TrueIndex":
        order = np.lexsort((values, keys))
        k = keys[order]
        v = values[order].astype(np.int32)
        # dedupe (key, value) pairs: the reference's true sets are deduped
        # (codes/dataloader.py §get_true_head_and_tail uses np.unique per
        # key), every membership consumer is idempotent, and the dense
        # eval path's window-CORRECTION rank (eval.dense_ranks_window)
        # subtracts window entries and therefore REQUIRES uniqueness
        keep = np.ones(len(k), bool)
        keep[1:] = (k[1:] != k[:-1]) | (v[1:] != v[:-1])
        k, v = k[keep], v[keep]
        uniq, starts = np.unique(k, return_index=True)
        offsets = np.empty(len(uniq) + 1, np.int64)
        offsets[:-1] = starts
        offsets[-1] = len(k)
        return cls(sorted_keys=uniq, offsets=offsets, values=v)

    def lookup(self, key: int) -> np.ndarray:
        i = np.searchsorted(self.sorted_keys, key)
        if i >= len(self.sorted_keys) or self.sorted_keys[i] != key:
            return self.values[:0]
        return self.values[self.offsets[i] : self.offsets[i + 1]]


def dense_key_arrays(idx: TrueIndex, n_keys: int, pad_value: int):
    """Densify a TrueIndex over the full composite-key space for
    device-resident use: (offsets i32[n_keys], counts i32[n_keys],
    values i32[nnz + k_max], k_max). The values tail is padded with
    ``pad_value`` so every k_max-wide window slice stays in bounds; callers
    mask window positions >= counts[key] (shared by the device sampler's
    membership test and the device eval filter — one CSR layout, one
    builder)."""
    counts = np.zeros(n_keys, np.int64)
    counts[idx.sorted_keys] = np.diff(idx.offsets)
    offsets = np.zeros(n_keys, np.int64)
    np.cumsum(counts[:-1], out=offsets[1:])
    k_max = max(int(counts.max(initial=0)), 1)
    values = np.concatenate(
        [idx.values, np.full(k_max, pad_value, np.int32)]
    )
    return (
        offsets.astype(np.int32),
        counts.astype(np.int32),
        values.astype(np.int32),
        k_max,
    )


@dataclass
class FilterSets:
    """Everything the sampler + evaluator need, built from triple arrays."""

    nentity: int
    nrelation: int
    # sampler-side (TRAIN split only — codes/dataloader.py ≈L25):
    true_head: TrueIndex  # key = r * nentity + t  -> heads
    true_tail: TrueIndex  # key = h * nrelation + r -> tails
    # eval-side (train ∪ valid ∪ test — codes/run.py §main ≈L230):
    all_true_head: TrueIndex
    all_true_tail: TrueIndex

    @classmethod
    def build(cls, train: np.ndarray, all_true: np.ndarray, nentity: int, nrelation: int) -> "FilterSets":
        def hk(arr):  # key for head lookup: (r, t)
            return arr[:, 1].astype(np.int64) * nentity + arr[:, 2]

        def tk(arr):  # key for tail lookup: (h, r)
            return arr[:, 0].astype(np.int64) * nrelation + arr[:, 1]

        return cls(
            nentity=nentity,
            nrelation=nrelation,
            true_head=TrueIndex.build(hk(train), train[:, 0]),
            true_tail=TrueIndex.build(tk(train), train[:, 2]),
            all_true_head=TrueIndex.build(hk(all_true), all_true[:, 0]),
            all_true_tail=TrueIndex.build(tk(all_true), all_true[:, 2]),
        )

    # --- sampler-side lookups (train-only filter) ---
    def train_true_heads(self, r: int, t: int) -> np.ndarray:
        return self.true_head.lookup(int(r) * self.nentity + int(t))

    def train_true_tails(self, h: int, r: int) -> np.ndarray:
        return self.true_tail.lookup(int(h) * self.nrelation + int(r))

    # --- eval-side filter masks (all-true filter) ---
    def filter_mask_rows(self, pos: np.ndarray, mode: str) -> np.ndarray:
        """bool[B, nentity] — True where the corrupted triple is a known true
        triple, with the positive itself UN-filtered (the reference's
        ``tmp[true] = (0, true)`` trick, codes/dataloader.py ≈L140-148)."""
        B = pos.shape[0]
        mask = np.zeros((B, self.nentity), np.bool_)
        for i in range(B):
            h, r, t = (int(x) for x in pos[i])
            if mode == "head-batch":
                true = self.all_true_head.lookup(r * self.nentity + t)
                mask[i, true] = True
                mask[i, h] = False
            else:
                true = self.all_true_tail.lookup(h * self.nrelation + r)
                mask[i, true] = True
                mask[i, t] = False
        return mask


def count_frequency(triples: np.ndarray, start: int = 4) -> Dict[Tuple[int, int], int]:
    """Word2vec-style co-occurrence counts with start=4 smoothing
    (codes/dataloader.py §count_frequency ≈L72-90): counts for (h, r) and
    (t, -r-1) pooled into one dict."""
    count: Dict[Tuple[int, int], int] = {}
    for h, r, t in triples:
        k1 = (int(h), int(r))
        k2 = (int(t), -int(r) - 1)
        count[k1] = count.get(k1, start) + 1
        count[k2] = count.get(k2, start) + 1
    return count


def subsampling_weights(triples: np.ndarray, nrelation: int, start: int = 4) -> np.ndarray:
    """Per-triple ``sqrt(1 / (count[(h,r)] + count[(t,-r-1)]))``
    (codes/dataloader.py §TrainDataset.__getitem__ ≈L36-40), f32, for the
    whole train split in one vectorized pass."""
    h = triples[:, 0].astype(np.int64)
    r = triples[:, 1].astype(np.int64)
    t = triples[:, 2].astype(np.int64)
    # (h, r) and (t, -r-1) encoded into disjoint int64 key spaces
    keys = np.concatenate([h * nrelation + r, -(t * nrelation + r) - 1])
    _, inv, counts = np.unique(keys, return_inverse=True, return_counts=True)
    freq = counts[inv] + start  # each key starts at `start`, +1 per occurrence
    n = len(triples)
    return np.sqrt(1.0 / (freq[:n] + freq[n:])).astype(np.float32)

