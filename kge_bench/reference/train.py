"""The reference training steps, and the check of the sampler's draws.

``follow`` trains from the benchmark's initial weights on the batches the
program drew, as ``codes/model.py`` §train_step of the RotatE codebase does:
the self-adversarial loss (softmax weights detached), word2vec subsampling
weights, the L3 term over the whole tables, dense gradients and
``torch.optim.Adam`` with its defaults. It follows the program from its own
draws (they are random, and the reference does not copy the program's
generator); ``draw_faults`` checks those draws by themselves.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

HEAD, TAIL = "head-batch", "tail-batch"


class tf32:
    """TF32 for matmuls and convolutions inside (``on``) or not, restored on
    exit."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.on
        torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


def subsampling_weights(triples: np.ndarray, nrelation: int, start: int = 4) -> np.ndarray:
    """``sqrt(1 / (count(h, r) + count(t, -r-1)))``, word2vec's subsampling
    (codes/dataloader.py §count_frequency and §TrainDataset.__getitem__):
    each count starts at ``start`` and every occurrence adds one, as the
    repository reads the codebase (SURVEY.md, ``tests/oracle_torch.py``)."""
    h, r, t = (triples[:, i].astype(np.int64) for i in range(3))

    def count(keys):
        _, inverse, n = np.unique(keys, return_inverse=True, return_counts=True)
        return start + n[inverse]

    return np.sqrt(1.0 / (count(h * nrelation + r) + count(t * nrelation + r)))


def _encode(keys: np.ndarray, ids: np.ndarray, nentity: int) -> np.ndarray:
    return keys.astype(np.int64) * nentity + ids.astype(np.int64)


def row_keys(pos: np.ndarray, mode: str, nentity: int, nrelation: int) -> np.ndarray:
    h, r, t = (pos[:, i].astype(np.int64) for i in range(3))
    return h * nrelation + r if mode == TAIL else r * nentity + t


def _find(sorted_enc: np.ndarray, enc: np.ndarray):
    """(index, found) of ``enc`` in the sorted ``sorted_enc``."""
    idx = np.minimum(np.searchsorted(sorted_enc, enc), len(sorted_enc) - 1)
    return idx, sorted_enc[idx] == enc


class TrainIndex:
    """The train split's triples, sorted by code, with their reference
    subsampling weights."""

    def __init__(self, train: np.ndarray, nrelation: int):
        train = np.asarray(train, np.int64)
        self.nrelation = nrelation
        codes = self.codes(train)
        order = np.argsort(codes)
        self.sorted = codes[order]
        self.weights = subsampling_weights(train, nrelation)[order]

    def codes(self, triples: np.ndarray) -> np.ndarray:
        t = np.asarray(triples, np.int64)
        return (t[:, 0] * self.nrelation + t[:, 1]) * (1 << 31) + t[:, 2]

    def lookup(self, triples: np.ndarray):
        """(weight, found) of each triple: 0 where it is no train triple."""
        idx, found = _find(self.sorted, self.codes(triples))
        return np.where(found, self.weights[idx], 0.0), found


def draw_faults(train: np.ndarray, nentity: int, nrelation: int,
                batches: Sequence[tuple]) -> Dict[str, int]:
    """Faults of the program's first batches, each counted: the mode not
    tail-first alternating; a positive not a train triple, or twice in one
    batch; a negative out of range or a train-true partner of its row; a
    subsampling weight off the reference's by more than f32 rounding."""
    index = TrainIndex(train, nrelation)
    train = np.asarray(train, np.int64)
    true = {m: np.unique(_encode(row_keys(train, m, nentity, nrelation),
                                 train[:, 2] if m == TAIL else train[:, 0], nentity))
            for m in (HEAD, TAIL)}
    out = {"mode": 0, "positive": 0, "repeated": 0, "negative": 0, "weight": 0}
    for k, (pos, neg, w, mode) in enumerate(batches):
        out["mode"] += int(mode != (TAIL if k % 2 == 0 else HEAD))
        pos, neg, w = (np.asarray(x) for x in (pos, neg, w))
        ref_w, found = index.lookup(pos)
        out["positive"] += int(np.sum(~found))
        out["repeated"] += len(pos) - len(np.unique(index.codes(pos)))
        out["weight"] += int(np.sum(found & (np.abs(w - ref_w) > 2.0 ** -20 * ref_w)))
        out["negative"] += int(np.sum((neg < 0) | (neg >= nentity)))
        enc = _encode(row_keys(pos, mode, nentity, nrelation)[:, None], neg, nentity)
        out["negative"] += int(np.sum(_find(true[mode], enc)[1]))
    return out


def follow(model, cfg: dict, init: Dict[str, torch.Tensor], batches: Sequence[tuple],
           train: np.ndarray, dtype=torch.float64, precision: str = "exact",
           block: int = 64) -> dict:
    """Train ``len(batches)`` steps from ``init`` on the program's draws
    (positives, negatives, mode), with subsampling weights worked out again
    from ``train``: the loss of each step, the first step's gradients, and
    the weights after the last step. Rows are scored in blocks of ``block``
    (the loss is a sum over rows), so the reference fits at the cell's
    widths."""
    index = TrainIndex(train, cfg["graph"]["nrelation"])
    leaves = {k: torch.nn.Parameter(v.detach().to(dtype).clone()) for k, v in init.items()}
    opt = torch.optim.Adam(list(leaves.values()), lr=cfg["learning_rate"])
    adv = cfg["negative_adversarial_sampling"]
    losses: List[float] = []
    grad1 = None
    with tf32(precision == "tf32"):  # the TF32 control: forward and backward
        for pos, neg, _, mode in batches:
            pos, neg = pos.to(torch.int64), neg.to(torch.int64)
            w = torch.from_numpy(index.lookup(pos.cpu().numpy())[0]).to(pos.device, dtype)
            if cfg.get("uni_weight"):
                w = torch.ones_like(w)
            opt.zero_grad(set_to_none=False)
            total = 0.0
            wsum = w.sum()
            for s in range(0, pos.shape[0], block):
                p, n, wb = pos[s:s + block], neg[s:s + block], w[s:s + block]
                ps, ns = model.train_scores(leaves["entity_embedding"],
                                            leaves["relation_embedding"], p, n, mode, cfg,
                                            precision)
                ps, ns = ps.to(dtype), ns.to(dtype)
                if adv:
                    soft = torch.softmax(ns * cfg["adversarial_temperature"], dim=1).detach()
                    neg_term = (soft * F.logsigmoid(-ns)).sum(dim=1)
                else:
                    neg_term = F.logsigmoid(-ns).mean(dim=1)
                loss = -((wb * F.logsigmoid(ps)).sum() + (wb * neg_term).sum()) / (2 * wsum)
                loss.backward()
                total += float(loss.detach())
            if cfg.get("regularization", 0.0):
                reg = cfg["regularization"] * sum(
                    (leaves[k].abs() ** 3).sum() for k in ("entity_embedding",
                                                           "relation_embedding"))
                reg.backward()
                total += float(reg.detach())
            losses.append(total)
            if grad1 is None:
                grad1 = {k: v.grad.detach().clone() for k, v in leaves.items()}
            opt.step()
    return {"loss": losses, "grad1": grad1,
            "params": {k: v.detach() for k, v in leaves.items()}}
