"""The reference's filtered ranking, and how far a rank is from it.

Filtered link prediction as ``codes/model.py`` §test_step of the RotatE
codebase defines it: a query (h, r, ?) or (?, r, t) ranks its true entity
among all E entities, leaving out every other entity that makes a known
triple (train, valid or test) with it. A rank of c + 1 says that c of the
remaining candidates score above the true entity. The reference builds its
own filter from the generated triples.

``gaps`` holds a rank against the reference's scores: in score units, how
far the reference's c-th best candidate lies below the true score, or its
(c + 1)-th above it. Rounding moves near ties and reads a small gap; a rank
that is wrong by one reads the spacing of the scores there.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

HEAD, TAIL = "head-batch", "tail-batch"
#: what a rank that no ordering of the candidates can give reads
IMPOSSIBLE = 1e30


def _keys(triples: np.ndarray, mode: str, nentity: int, nrelation: int) -> np.ndarray:
    h, r, t = (triples[:, i].astype(np.int64) for i in range(3))
    return h * nrelation + r if mode == TAIL else r * nentity + t


def _ids(triples: np.ndarray, mode: str) -> np.ndarray:
    return triples[:, 2 if mode == TAIL else 0].astype(np.int64)


def true_sets(all_triples: np.ndarray, nentity: int, nrelation: int) -> Dict[str, np.ndarray]:
    """Per mode, the sorted ``key * E + id`` of every known triple."""
    return {m: np.unique(_keys(all_triples, m, nentity, nrelation) * nentity
                         + _ids(all_triples, m)) for m in (HEAD, TAIL)}


def filter_mask(sets: Dict[str, np.ndarray], triples: np.ndarray, mode: str,
                nentity: int, nrelation: int) -> np.ndarray:
    """bool [B, E]: True for the entities left out of each query, its true
    entity among them."""
    enc = sets[mode]
    keys = _keys(triples, mode, nentity, nrelation)
    lo = np.searchsorted(enc, keys * nentity)
    hi = np.searchsorted(enc, (keys + 1) * nentity)
    mask = np.zeros((len(triples), nentity), bool)
    for i, (a, b) in enumerate(zip(lo, hi)):
        mask[i, enc[a:b] - keys[i] * nentity] = True
    mask[np.arange(len(triples)), _ids(triples, mode)] = True
    return mask


def _blocks(queries: Sequence[Tuple[str, int]], block: int):
    for mode in (HEAD, TAIL):
        sel = [i for i, (m, _) in enumerate(queries) if m == mode]
        for s in range(0, len(sel), block):
            yield mode, sel[s:s + block]


def _scores(model, cfg, weights, triples, mode, rows, sets, dtype, precision):
    """(scores [b, E], true scores [b, 1], left-out mask [b, E]) of a block."""
    device = weights["entity_embedding"].device
    E, R = cfg["graph"]["nentity"], cfg["graph"]["nrelation"]
    ent = weights["entity_embedding"].to(dtype)
    rel = weights["relation_embedding"].to(dtype)
    pos = torch.from_numpy(triples[rows].astype(np.int64)).to(device)
    s = model.scores_all(model.query(ent, rel, pos, mode, cfg), ent, cfg, precision)
    true = torch.from_numpy(_ids(triples[rows], mode)).to(device)[:, None]
    mask = torch.from_numpy(filter_mask(sets, triples[rows], mode, E, R)).to(device)
    return s, torch.gather(s, 1, true), mask


@torch.no_grad()
def gaps(model, cfg: dict, weights: Dict[str, torch.Tensor], triples: np.ndarray,
         queries: Sequence[Tuple[str, int]], ranks: np.ndarray, sets,
         block: int = 8) -> np.ndarray:
    """The gap of each query's rank, in float64 from the float32 weights."""
    out = np.zeros(len(queries))
    for mode, sel in _blocks(queries, block):
        rows = np.array([queries[i][1] for i in sel])
        s, t, mask = _scores(model, cfg, weights, triples, mode, rows, sets, torch.float64,
                             "exact")
        vals = torch.where(mask, -torch.inf, s).sort(dim=1, descending=True).values
        n_cand = (~mask).sum(dim=1)
        c = torch.from_numpy(np.asarray(ranks)[sel].astype(np.int64) - 1).to(s.device)
        ok = (c >= 0) & (c <= n_cand)
        ci = c.clamp(0, s.shape[1] - 1)[:, None]
        above = torch.gather(vals, 1, (ci - 1).clamp(min=0))[:, 0]  # the c-th best
        below = torch.gather(vals, 1, ci)[:, 0]  # the (c + 1)-th
        t = t[:, 0]
        low = torch.where(c >= 1, t - above, torch.zeros_like(t))
        high = torch.where(c < n_cand, below - t, torch.zeros_like(t))
        gap = torch.clamp(torch.maximum(low, high), min=0)
        gap = torch.where(ok, gap, torch.full_like(gap, IMPOSSIBLE))
        out[sel] = gap.cpu().numpy()
    return out


@torch.no_grad()
def ranks_in(model, cfg: dict, weights: Dict[str, torch.Tensor], triples: np.ndarray,
             queries: Sequence[Tuple[str, int]], sets, precision: str,
             block: int = 8) -> np.ndarray:
    """The reference's own ranks, from float32 weights scored at
    ``precision`` (the control's lower precision)."""
    out = np.zeros(len(queries), np.int64)
    for mode, sel in _blocks(queries, block):
        rows = np.array([queries[i][1] for i in sel])
        s, t, mask = _scores(model, cfg, weights, triples, mode, rows, sets, torch.float32,
                             precision)
        out[sel] = (1 + ((s > t) & ~mask).sum(dim=1)).cpu().numpy()
    return out
