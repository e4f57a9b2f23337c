"""The benchmark's graph, generated from the seed.

A frozen copy of ``make_random_kg`` (``knowledgegraphembedding_torch/data/
synthetic.py``), kept here so that a change to the measured package cannot
change the graph the benchmark measures it on: entities drawn with a Zipf
popularity ``1 / rank ** zipf`` for heads and tails, relations uniform,
duplicates and self-loops dropped, a random subset of the size asked for,
then split into valid, test and train in that order.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

#: the graph's own random stream of the seed (the program's sampler takes the seed itself)
GRAPH_STREAM = 1


def make_graph(nentity: int, nrelation: int, ntrain: int, nvalid: int, ntest: int,
               zipf: float, seed: int) -> Dict[str, np.ndarray]:
    """{'train', 'valid', 'test'}: int32 [n, 3] (head, relation, tail)."""
    total = ntrain + nvalid + ntest
    rng = np.random.default_rng([seed, GRAPH_STREAM])
    pop = 1.0 / np.arange(1, nentity + 1) ** zipf
    pop /= pop.sum()
    h = rng.choice(nentity, size=total * 2, p=pop)
    t = rng.choice(nentity, size=total * 2, p=pop)
    r = rng.integers(0, nrelation, size=total * 2)
    triples = np.unique(np.stack([h, r, t], axis=1).astype(np.int32), axis=0)
    triples = triples[triples[:, 0] != triples[:, 2]]
    if len(triples) < total:
        raise ValueError(f"{len(triples)} distinct triples drawn, {total} asked for")
    # np.unique sorts the rows: permute before cutting, so the kept subset
    # keeps the popularity law
    triples = triples[rng.permutation(len(triples))[:total]]
    triples = triples[rng.permutation(total)]
    return {
        "valid": triples[:nvalid],
        "test": triples[nvalid:nvalid + ntest],
        "train": triples[nvalid + ntest:],
    }


def from_config(cfg: dict, seed: int) -> Dict[str, np.ndarray]:
    g = cfg["graph"]
    return make_graph(g["nentity"], g["nrelation"], g["ntrain"], g["nvalid"], g["ntest"],
                      g["zipf"], seed)
