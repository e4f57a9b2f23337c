"""The plain reference against brute force at a tiny size: its scores, its
filtered ranks and their gaps, its subsampling weights, and the check of the
sampler's draws."""

import math

import numpy as np
import pytest
import torch

from kge_bench.harness import graph, spec, weights
from kge_bench.reference import rank, train

E, R = 60, 4


@pytest.fixture(scope="module")
def kg():
    return graph.make_graph(E, R, 500, 20, 30, 0.7, seed=11)


def _cfg(root, name, d=6):
    bench = spec.load_benchmark(root)
    return spec.load_config(root, bench, name, {
        "hidden_dim": d, "graph": {"nentity": E, "nrelation": R}})


def test_graph_is_a_function_of_the_seed(kg):
    again = graph.make_graph(E, R, 500, 20, 30, 0.7, seed=11)
    for split in ("train", "valid", "test"):
        assert np.array_equal(kg[split], again[split])
    allt = np.concatenate([kg["train"], kg["valid"], kg["test"]])
    assert len(np.unique(allt, axis=0)) == len(allt) == 550
    assert not np.any(allt[:, 0] == allt[:, 2])


def test_rotate_scores_are_complex_rotations(root):
    cfg = _cfg(root, "rotate_fb15k237")
    model = spec.reference_model(root, "RotatE")
    w = weights.make(cfg, model.shapes(cfg), 3, torch.device("cpu"))
    ent, rel = w["entity_embedding"].double(), w["relation_embedding"].double()
    pos = torch.tensor([[1, 2, 3], [5, 0, 7]])
    cplx = torch.complex(*ent.chunk(2, dim=1))
    rot = torch.exp(1j * rel.to(torch.complex128).real * (math.pi / model.embedding_range(cfg)))
    h, r, t = cplx[pos[:, 0]], rot[pos[:, 1]], cplx[pos[:, 2]]
    tail = model.score(model.query(ent, rel, pos, "tail-batch", cfg), ent[pos[:, 2]], cfg)
    head = model.score(model.query(ent, rel, pos, "head-batch", cfg), ent[pos[:, 0]], cfg)
    want_tail = cfg["gamma"] - (h * r - t).abs().sum(dim=1)
    want_head = cfg["gamma"] - (r.conj() * t - h).abs().sum(dim=1)
    torch.testing.assert_close(tail, want_tail)
    torch.testing.assert_close(head, want_head)


def _brute_ranks(model, cfg, w, triples, queries, allt):
    known = {tuple(x) for x in allt.tolist()}
    ent, rel = w["entity_embedding"].double(), w["relation_embedding"].double()
    out = []
    for mode, i in queries:
        h, r, t = (int(x) for x in triples[i])
        pos = torch.tensor([[h, r, t]])
        s = model.scores_all(model.query(ent, rel, pos, mode, cfg), ent, cfg)[0]
        true = t if mode == "tail-batch" else h
        beats = 0
        for e in range(E):
            trip = (h, r, e) if mode == "tail-batch" else (e, r, t)
            if e != true and trip not in known and s[e] > s[true]:
                beats += 1
        out.append(beats + 1)
    return np.array(out)


@pytest.mark.parametrize("name", ["rotate_fb15k237", "distmult_fb15k237"])
def test_ranks_and_gaps_against_brute_force(root, kg, name):
    cfg = _cfg(root, name)
    model = spec.reference_model(root, cfg["model"])
    w = weights.make(cfg, model.shapes(cfg), 5, torch.device("cpu"))
    allt = np.concatenate([kg["train"], kg["valid"], kg["test"]])
    sets = rank.true_sets(allt, E, R)
    test = kg["test"]
    queries = [(m, i) for m in ("head-batch", "tail-batch") for i in range(len(test))]
    brute = _brute_ranks(model, cfg, w, test, queries, allt)
    assert np.array_equal(rank.ranks_in(model, cfg, w, test, queries, sets, "exact"), brute)
    assert np.all(rank.gaps(model, cfg, w, test, queries, brute, sets) == 0)
    off = brute + 1  # one too many: the gap is the spacing to the next candidate
    gaps = rank.gaps(model, cfg, w, test, queries, off, sets)
    assert np.all(gaps[off <= E] > 0)
    impossible = brute.copy()
    impossible[0] = E + 5
    assert rank.gaps(model, cfg, w, test, queries, impossible, sets)[0] == rank.IMPOSSIBLE


def test_subsampling_weights_count_from_four(kg):
    counts = {}
    for h, r, t in kg["train"].tolist():
        counts[(h, r)] = counts.get((h, r), 4) + 1
        counts[(t, -r - 1)] = counts.get((t, -r - 1), 4) + 1
    want = [math.sqrt(1 / (counts[(h, r)] + counts[(t, -r - 1)]))
            for h, r, t in kg["train"].tolist()]
    np.testing.assert_allclose(train.subsampling_weights(kg["train"], R), want, rtol=1e-12)


def test_draw_faults_counts_each_kind(kg):
    tr = kg["train"]
    w = train.subsampling_weights(tr, R)
    known_tails = {(h, r): set() for h, r, _ in tr.tolist()}
    for h, r, t in tr.tolist():
        known_tails[(h, r)].add(t)
    pos = tr[:8]
    neg = np.array([[e for e in range(E) if e not in known_tails[(h, r)]][:5]
                    for h, r, _ in pos.tolist()])
    good = (pos, neg, w[:8].astype(np.float32), "tail-batch")
    assert sum(train.draw_faults(tr, E, R, [good]).values()) == 0
    bad_neg = neg.copy()
    bad_neg[0, 0] = pos[0, 2]
    bad_w = w[:8].copy()
    bad_w[1] *= 1.01
    rep, rep_w = pos.copy(), w[:8].copy()
    rep[2], rep_w[2] = rep[3], rep_w[3]
    faults = train.draw_faults(tr, E, R, [(pos, bad_neg, bad_w, "tail-batch"),
                                          (rep, neg, rep_w, "tail-batch")])
    assert faults == {"mode": 1, "positive": 0, "repeated": 1, "negative": 1, "weight": 1}
