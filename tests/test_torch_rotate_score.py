"""RotatE's negative-score kernels (knowledgegraphembedding_torch/ops/
rotate_score.py) on the CPU: the plain twin and the query against the chain
of models/scorers.py, and the train step's route to the kernels.

The twin with ``query`` is the chain's arithmetic in the chain's order, so
scores and both gradients (entity and relation tables) equal the chain's
bit for bit, in f64 and f32, in both modes, with negatives repeated within
and across rows and a negative at distance 0 from its query (every element
clamped: gradient 0). On the CPU ``rotate_score.takes`` keeps the chain,
so the route is tested with a stand-in for it that answers as it does on
the card (RotatE f32 per-row batches take the kernels; f64, bf16, shared
negatives, TransE and pRotatE keep the chain): the twin then stands in for
the kernels, and the counters count as the benchmark reads them. The
kernels against the twin, and ``takes`` itself, on the card:
tests/test_torch_cuda.py."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from knowledgegraphembedding_torch import train as t_train
from knowledgegraphembedding_torch.config import ModelSpec, TrainSpec
from knowledgegraphembedding_torch.models import kge, scorers
from knowledgegraphembedding_torch.ops import rotate_score
from knowledgegraphembedding_torch.utils import profiling

MODES = [scorers.HEAD_BATCH, scorers.TAIL_BATCH]
DTYPES = {"f64": torch.float64, "f32": torch.float32}
E, NREL, B, N = 40, 5, 6, 9


def _spec(model="RotatE", dim=7):
    return ModelSpec(model_name=model, nentity=E, nrelation=NREL, hidden_dim=dim, gamma=6.0,
                     double_entity_embedding=model == "RotatE")


def _batch(seed=0, shared=False):
    """Positives on entities 0..19, negatives on 20..38 (39 is left for the
    zero-distance row), one repeated within row 0 and across rows 0 and 1."""
    g = torch.Generator().manual_seed(seed)
    pos = torch.stack([torch.randint(0, 20, (B,), generator=g),
                       torch.randint(0, NREL, (B,), generator=g),
                       torch.randint(0, 20, (B,), generator=g)], dim=1)
    neg = torch.randint(20, 39, (1 if shared else B, N), generator=g, dtype=torch.int32)
    if not shared:
        neg[0, 1] = neg[0, 2]
        neg[1, 5] = neg[0, 2]
    return pos, neg


def _params(spec, dtype, seed=0):
    return kge.init_params(spec, torch.Generator().manual_seed(seed), device="cpu",
                           dtype=dtype)


def _grads(params, fn):
    """(scores, d/d each table) of a fixed weighting of the scores."""
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    s = fn(leaves)
    w = torch.linspace(-1.0, 1.0, s.numel(), dtype=s.dtype).reshape(s.shape)
    return s.detach(), torch.autograd.grad((s * w).sum(), list(leaves.values()))


def _twin(spec, pos, neg, mode):
    def fn(p):
        ent = p["entity_embedding"]
        fixed = ent[pos[:, 2] if mode == scorers.HEAD_BATCH else pos[:, 0]]
        q = rotate_score.query(fixed, p["relation_embedding"][pos[:, 1]], spec.embedding_range,
                               mode)
        return rotate_score.negative_scores(q, ent, neg, spec.gamma)
    return fn


def _chain(spec, pos, neg, mode):
    return lambda p: kge.forward(p, spec, (pos, neg), mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_twin_equals_the_chain_forward_and_both_gradients(dtype, mode):
    spec = _spec()
    params = _params(spec, DTYPES[dtype])
    pos, neg = _batch()
    want_s, want_g = _grads(params, _chain(spec, pos, neg, mode))
    got_s, got_g = _grads(params, _twin(spec, pos, neg, mode))
    assert got_s.dtype == DTYPES[dtype] and got_s.shape == (B, N)
    assert torch.equal(got_s, want_s)
    for g, w in zip(got_g, want_g):
        assert torch.equal(g, w)
    assert got_g[0][20:39].abs().sum() > 0  # the negatives' rows take gradient


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_zero_distance_scores_the_floor_and_takes_no_gradient(dtype, mode):
    """Entity 39 set to row 2's query and scored once, as (2, 4): every
    element sits under the clamp, so the score is gamma - d sqrt(1e-30), the
    chain's and the twin's gradients agree, and 39's gradient row is 0."""
    spec = _spec()
    params = _params(spec, DTYPES[dtype])
    pos, neg = _batch(seed=1)
    ent = params["entity_embedding"]
    fixed = ent[pos[:, 2] if mode == scorers.HEAD_BATCH else pos[:, 0]]
    q = rotate_score.query(fixed, params["relation_embedding"][pos[:, 1]],
                           spec.embedding_range, mode)
    ent[39] = q[2]
    neg[2, 4] = 39
    want_s, want_g = _grads(params, _chain(spec, pos, neg, mode))
    got_s, got_g = _grads(params, _twin(spec, pos, neg, mode))
    assert torch.equal(got_s, want_s)
    floor = torch.sqrt(torch.tensor(rotate_score.FLOOR, dtype=DTYPES[dtype]))
    assert torch.equal(got_s[2, 4], spec.gamma - torch.sum(floor.expand(spec.hidden_dim)))
    for g, w in zip(got_g, want_g):
        assert torch.equal(g, w) and torch.isfinite(g).all()
    assert torch.equal(got_g[0][39], torch.zeros_like(got_g[0][39]))


def test_negative_scores_on_cpu_is_the_twin_for_both_index_types():
    spec = _spec()
    params = _params(spec, torch.float32)
    pos, neg = _batch(seed=2)
    q = rotate_score.query(params["entity_embedding"][pos[:, 0]],
                           params["relation_embedding"][pos[:, 1]], spec.embedding_range,
                           scorers.TAIL_BATCH)
    before = (rotate_score.negative_scores.launches, rotate_score.negative_scores.captured)
    a = rotate_score.negative_scores(q, params["entity_embedding"], neg, spec.gamma)
    b = rotate_score.negative_scores(q, params["entity_embedding"], neg.long(), spec.gamma)
    want = rotate_score.negative_scores_ref(q, params["entity_embedding"], neg, spec.gamma)
    assert torch.equal(a, want) and torch.equal(b, want)
    assert (rotate_score.negative_scores.launches,
            rotate_score.negative_scores.captured) == before  # no kernel on the CPU
    with pytest.raises(ValueError, match="is on meta"):
        rotate_score.negative_scores(q, params["entity_embedding"].to("meta"), neg, spec.gamma)


def test_query_refuses_the_single_mode():
    with pytest.raises(ValueError, match="no negatives"):
        rotate_score.query(torch.zeros(2, 4), torch.zeros(2, 2), 1.0, scorers.SINGLE)


# (model, params dtype, --precision, shared negatives) -> takes the kernels
ROUTES = {
    "rotate_f32": ("RotatE", torch.float32, "f32", False, True),
    "rotate_f64": ("RotatE", torch.float64, "f32", False, False),
    "rotate_bf16": ("RotatE", torch.float32, "bf16", False, False),
    "rotate_shared": ("RotatE", torch.float32, "f32", True, False),
    "transe": ("TransE", torch.float32, "f32", False, False),
    "protate": ("pRotatE", torch.float32, "f32", False, False),
}


def _counts(fn):
    profiling.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            out = fn()
        counts = {}
        for c in profiling.records()[1]:
            counts[c.name] = counts.get(c.name, 0) + c.n
        return out, counts
    finally:
        profiling.clear()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(ROUTES))
def test_route_takes_the_kernels_for_rotate_f32_per_row_only(case, mode, monkeypatch):
    """With ``takes`` answering as on the card, ``batch_scores`` routes as
    there: the kernel path (the twin here) for RotatE f32 per-row
    negatives, the chain otherwise; each gather-path negative score counts
    ``train_step.gather_scored`` and each through the kernels
    ``train_step.score_kernel``. Scores equal the chain's either way."""
    model, dtype, precision, shared, kernel = ROUTES[case]
    spec = _spec(model)
    tspec = TrainSpec(negative_sample_size=N, batch_size=B, precision=precision)
    params = _params(spec, dtype)
    pos, neg = _batch(seed=3, shared=shared)
    assert not rotate_score.takes(spec, params, pos, neg,
                                  torch.bfloat16 if precision == "bf16" else None)
    want = t_train.batch_scores(params, spec, tspec, pos, neg, mode)  # the CPU: the chain
    monkeypatch.setattr(rotate_score, "takes", lambda *a: kernel)
    taken = []
    real = rotate_score.rotate_negative_scores
    monkeypatch.setattr(rotate_score, "rotate_negative_scores",
                        lambda *a: taken.append(1) or real(*a))
    got, counts = _counts(lambda: t_train.batch_scores(params, spec, tspec, pos, neg, mode))
    assert len(taken) == int(kernel)
    assert counts.get("train_step.gather_scored") == 1
    assert counts.get("train_step.score_kernel", 0) == int(kernel)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_route_keeps_the_chain_on_the_cpu_and_dense_scoring_counts_nothing():
    spec = _spec()
    tspec = TrainSpec(negative_sample_size=N, batch_size=B)
    params = _params(spec, torch.float32)
    pos, neg = _batch(seed=4)
    assert not rotate_score.takes(spec, params, pos, neg, None)
    _, counts = _counts(lambda: t_train.batch_scores(params, spec, tspec, pos, neg,
                                                     scorers.TAIL_BATCH))
    assert counts == {"train_step.gather_scored": 1}
    dspec = ModelSpec(model_name="DistMult", nentity=E, nrelation=NREL, hidden_dim=8,
                      gamma=6.0)
    _, counts = _counts(lambda: t_train.batch_scores(
        _params(dspec, torch.float32), dspec, TrainSpec(negative_sample_size=N, batch_size=B,
                                                        scoring="dense"),
        pos, neg.long(), scorers.TAIL_BATCH))
    assert counts == {}


def test_trainer_steps_through_the_route_equal_the_chain(monkeypatch):
    """Three Trainer steps across the decay with the route taken (the twin
    in the kernels' place) equal three on the chain: params and moments bit
    for bit."""
    spec = _spec()
    tspec = TrainSpec(negative_sample_size=N, batch_size=B, negative_adversarial_sampling=True)
    params = _params(spec, torch.float32)
    batches = [_batch(seed=s) + (m,) for s, m in zip(range(5, 8), MODES + MODES[:1])]
    chain = t_train.Trainer(spec, tspec, params, lr=0.01, warm_up_steps=1)
    for pos, neg, m in batches:
        chain.one_step((pos, neg, torch.ones(B), m))
    monkeypatch.setattr(rotate_score, "takes", lambda *a: True)
    routed = t_train.Trainer(spec, tspec, params, lr=0.01, warm_up_steps=1)
    _, counts = _counts(lambda: [routed.one_step((pos, neg, torch.ones(B), m))
                                 for pos, neg, m in batches])
    assert counts["train_step.score_kernel"] == counts["train_step.gather_scored"] == 3
    for k in params:
        assert torch.equal(routed.params[k], chain.params[k])
        assert torch.equal(routed.opt_state.m[k], chain.opt_state.m[k])
