"""Faults planted under the timed path, to show that the output check sees
them: the benchmark's own runs never import this module. The output check's
tests plant them at a small size on the CPU, and ``readings.py`` on the card
at the cell's size.

- ``unchanged_state``: a training step computes its loss and returns with
  the weights and Adam's state as they were;
- ``half_batch``: a training step's loss is the mean over the first half of
  the batch; an evaluation batch's second half is answered with the first
  half's ranks;
- ``altered_draw``: each training batch's first negative is its positive's
  own true entity;
- ``altered_answer``: the first rank of each evaluation batch is one too
  many, as a count that took in the true entity itself.
"""

from __future__ import annotations

import contextlib

import torch

#: the faults a traffic kind can have (the exchange between chips: no cell
#: spans chips)
FAULTS = {"train": ("unchanged_state", "half_batch", "altered_draw"),
          "eval": ("half_batch", "altered_answer")}


def _half_loss(orig):
    def kge_loss(positive_score, negative_score, weight, spec):
        h = positive_score.shape[0] // 2
        neg = negative_score if negative_score.shape[0] == 1 else negative_score[:h]
        return orig(positive_score[:h], neg, weight[:h], spec)
    return kge_loss


class _AlteredDraws:
    def __init__(self, inner):
        self.inner = inner

    def __iter__(self):
        return self

    def __next__(self):
        pos, neg, w, mode = next(self.inner)
        own = 2 if mode == "tail-batch" else 0
        neg = neg.clone() if isinstance(neg, torch.Tensor) else neg.copy()
        neg[0, 0] = pos[0, own]
        return pos, neg, w, mode

    def close(self):
        self.inner.close()


def _altered_iterator(orig):
    def train_iterator(*args, **kwargs):
        return _AlteredDraws(orig(*args, **kwargs))
    return train_iterator


def _ranks(orig, how: str):
    def ranks(*args, **kwargs):
        out = orig(*args, **kwargs).clone()  # i32 [B]: one batch's ranks
        if how == "half_batch":
            h = out.shape[0] // 2
            out[out.shape[0] - h:] = out[:h]
        else:
            out[0] += 1
        return out
    return ranks


@contextlib.contextmanager
def planted(name, kind: str):
    """The program with fault ``name`` of traffic ``kind`` planted, while
    the block runs; ``None`` plants nothing."""
    if name is None:
        yield
        return
    if name not in FAULTS[kind]:
        raise ValueError(f"no fault {name!r} for {kind} traffic (known: {FAULTS[kind]})")
    from knowledgegraphembedding_torch import eval as eval_mod
    from knowledgegraphembedding_torch import optim
    from knowledgegraphembedding_torch.ops import loss, rank_kernel

    from kge_bench.harness import program

    if kind == "train":
        patches = {"unchanged_state": [(optim, "apply_update", lambda *a, **k: None)],
                   "half_batch": [(loss, "kge_loss", _half_loss(loss.kge_loss))],
                   "altered_draw": [(program, "train_iterator",
                                     _altered_iterator(program.train_iterator))]}[name]
    else:
        # every way a batch is ranked: the rank kernel, the plain chunked
        # path and the dense window
        patches = [(mod, f, _ranks(getattr(mod, f), name))
                   for mod, f in ((rank_kernel.Ranker, "ranks"), (eval_mod, "ranks_batch"),
                                  (eval_mod, "dense_ranks_window"))]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    try:
        for mod, attr, new in patches:
            setattr(mod, attr, new)
        yield
    finally:
        for mod, attr, old in saved:
            setattr(mod, attr, old)
