"""``--precision bf16`` in the port (bf16 casts of the f32 tables before the
gather, bf16 score math, f32 sums and scores, gradients into the f32
masters) against the JAX package's on the same numpy inputs.

Tolerances:
- scores, port against JAX: atol 0.025, half of the JAX test's own bar for
  bf16 against f32 (tests/test_precision.py, 0.05). Both run the same bf16
  ops; they differ where XLA keeps an intermediate (a sin, a product) in
  f32 instead of rounding it to bf16, a bf16 ulp (2^-8 relative) in some
  of the d terms of a score. TransE, DistMult and ComplEx measure equal,
  RotatE and pRotatE 0.008-0.012 at d=16 on scores of about 5;
- each package's bf16 scores within 0.05 of its f32 scores (JAX's bar);
- gradients: the port's bf16 gradients are f32 and lie within JAX's bf16
  gradients at JAX's own bar for bf16 against f32 (rtol 0.2, atol 0.02);
- dense bf16 scores: sums of products of bf16-rounded operands in f32, so
  port and JAX agree to f32 summation noise (rtol 1e-6, atol 1e-6), far
  closer than a bf16-rounded output would be."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from knowledgegraphembedding_torch import eval as t_eval
from knowledgegraphembedding_torch import train as t_train
from knowledgegraphembedding_torch.config import ModelSpec as TSpec
from knowledgegraphembedding_torch.config import TrainSpec as TTrainSpec
from knowledgegraphembedding_torch.data.filterset import FilterSets as TFilterSets
from knowledgegraphembedding_torch.models import kge as t_kge
from knowledgegraphembedding_torch.ops import matmul_scoring as t_ms
from knowledgegraphembedding_torch.sampler import build_train_iterator as t_iterator
from knowledgegraphembedding_tpu import train as j_train
from knowledgegraphembedding_tpu.config import ModelSpec as JSpec
from knowledgegraphembedding_tpu.config import TrainSpec as JTrainSpec
from knowledgegraphembedding_tpu.data.synthetic import make_clustered_kg
from knowledgegraphembedding_tpu.models import kge as j_kge
from knowledgegraphembedding_tpu.ops import matmul_scoring as j_ms

MODELS = [("TransE", False, False), ("DistMult", False, False), ("ComplEx", True, True),
          ("RotatE", True, False), ("pRotatE", False, False)]
IDS = [m[0] for m in MODELS]
MODES = ["head-batch", "tail-batch"]
SCORE_ATOL = 0.025
BF16_VS_F32 = 0.05
GRAD_TOL = dict(rtol=0.2, atol=0.02)


def _setup(model, de, dr, E=60, R=5, dim=16, B=8, n=12, seed=0):
    kw = dict(model_name=model, nentity=E, nrelation=R, hidden_dim=dim, gamma=6.0,
              double_entity_embedding=de, double_relation_embedding=dr)
    jspec, tspec = JSpec(**kw), TSpec(**kw)
    rng = np.random.default_rng(seed)
    r = jspec.embedding_range
    p = {"entity_embedding": rng.uniform(-r, r, (E, jspec.entity_dim)).astype(np.float32),
         "relation_embedding": rng.uniform(-r, r, (R, jspec.relation_dim)).astype(np.float32)}
    if jspec.has_modulus:
        p["modulus"] = np.float32(0.5 * r)
    pos = np.stack([rng.integers(0, E, B), rng.integers(0, R, B), rng.integers(0, E, B)],
                   1).astype(np.int32)
    neg = rng.integers(0, E, (B, n)).astype(np.int32)
    w = rng.uniform(0.1, 1, B).astype(np.float32)
    return jspec, tspec, p, pos, neg, w


def _j(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def _t(p):
    return t_kge.params_from_numpy(p, "cpu")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("model,de,dr", MODELS, ids=IDS)
def test_bf16_forward_matches_jax(model, de, dr, mode):
    jspec, tspec, p, pos, neg, _ = _setup(model, de, dr)
    sample_j = (jnp.asarray(pos), jnp.asarray(neg))
    want = np.asarray(j_kge.forward(_j(p), jspec, sample_j, mode, jnp.bfloat16))
    want32 = np.asarray(j_kge.forward(_j(p), jspec, sample_j, mode))
    sample_t = (torch.from_numpy(pos).long(), torch.from_numpy(neg).long())
    got = t_kge.forward(_t(p), tspec, sample_t, mode, torch.bfloat16)
    got32 = t_kge.forward(_t(p), tspec, sample_t, mode)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SCORE_ATOL)
    np.testing.assert_allclose(want, want32, rtol=BF16_VS_F32, atol=BF16_VS_F32)
    np.testing.assert_allclose(got.numpy(), got32.numpy(), rtol=BF16_VS_F32, atol=BF16_VS_F32)


@pytest.mark.parametrize("model,de,dr", MODELS, ids=IDS)
def test_bf16_grads_reach_f32_masters_as_in_jax(model, de, dr):
    """loss_and_logs under bf16, tail-batch: the port's gradients are f32
    and within JAX's bf16 gradients at JAX's bar (rtol 0.2, atol 0.02)."""
    jspec, tspec, p, pos, neg, w = _setup(model, de, dr, seed=1)
    kw = dict(negative_sample_size=12, negative_adversarial_sampling=True, scoring="gather")
    want = jax.grad(lambda q: j_train.loss_and_logs(
        q, jspec, JTrainSpec(precision="bf16", **kw), jnp.asarray(pos), jnp.asarray(neg),
        jnp.asarray(w), "tail-batch")[0])(_j(p))

    tp = {k: v.requires_grad_(True) for k, v in _t(p).items()}
    loss, _ = t_train.loss_and_logs(tp, tspec, TTrainSpec(precision="bf16", **kw),
                                    torch.from_numpy(pos).long(), torch.from_numpy(neg).long(),
                                    torch.from_numpy(w), "tail-batch")
    for k, g in zip(tp, torch.autograd.grad(loss, list(tp.values()))):
        assert g.dtype == torch.float32, k
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), **GRAD_TOL, err_msg=k)


def test_rotate_zero_guard_in_bf16():
    """The magnitude's guard in bf16: 1e-30 is a bf16 value (f32's exponent),
    so the value is unchanged and the gradient at an exact zero is 0, not
    NaN."""
    spec = TSpec(model_name="RotatE", nentity=2, nrelation=1, hidden_dim=2, gamma=1.0,
                 double_entity_embedding=True)
    assert float(torch.tensor(1e-30, dtype=torch.bfloat16)) > 0
    params = {"entity_embedding": torch.tensor([[0.5, -0.25, 0.0, 0.5]] * 2,
                                               requires_grad=True),
              "relation_embedding": torch.zeros(1, 2, requires_grad=True)}
    # h == t and r == 0: every element of h o r - t is exactly 0
    score = t_kge.forward(params, spec, torch.tensor([[0, 0, 1]]), "single", torch.bfloat16)
    assert float(score.detach()) == 1.0
    grads = torch.autograd.grad(score.sum(), list(params.values()))
    assert all(bool(torch.isfinite(g).all()) and not g.any() for g in grads)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("model,de,dr", MODELS[1:3], ids=IDS[1:3])
def test_bf16_dense_scores_match_jax(model, de, dr, mode):
    """DistMult and ComplEx dense scores with bf16 operands: f32 results
    that equal JAX's to f32 summation noise, where rounding them to bf16
    would move them by far more."""
    jspec, tspec, p, pos, _, _ = _setup(model, de, dr, E=50, R=7, B=6)
    want = np.asarray(j_ms.dense_scores_all(jspec, _j(p), jnp.asarray(pos), mode,
                                            compute_dtype=jnp.bfloat16))
    got = t_ms.dense_scores_all(tspec, _t(p), torch.from_numpy(pos), mode, torch.bfloat16)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    err = np.abs(got.numpy() - want).max()
    rounded = np.abs(torch.tensor(want).bfloat16().float().numpy() - want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert err < rounded / 100, (err, rounded)


@pytest.mark.parametrize("model,de,dr", MODELS[1:3], ids=IDS[1:3])
def test_bf16_dense_loss_and_grads_match_jax(model, de, dr):
    """The dense branch of loss_and_logs under bf16: loss and gradients
    against JAX's (rtol 1e-5: the f32 sums of exact products)."""
    jspec, tspec, p, pos, neg, w = _setup(model, de, dr, E=50, R=7, B=6, n=9, seed=3)
    kw = dict(negative_sample_size=9, negative_adversarial_sampling=True, regularization=1e-5,
              scoring="dense", precision="bf16")
    want_loss, want = jax.value_and_grad(lambda q: j_train.loss_and_logs(
        q, jspec, JTrainSpec(**kw), jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(w),
        "head-batch")[0])(_j(p))
    tp = {k: v.requires_grad_(True) for k, v in _t(p).items()}
    loss, _ = t_train.loss_and_logs(tp, tspec, TTrainSpec(**kw), torch.from_numpy(pos).long(),
                                    torch.from_numpy(neg).long(), torch.from_numpy(w),
                                    "head-batch")
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for k, g in zip(tp, torch.autograd.grad(loss, list(tp.values()))):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


@pytest.mark.parametrize("model,de,dr", [MODELS[0], MODELS[3]], ids=["TransE", "RotatE"])
def test_bf16_train_step_matches_jax(model, de, dr):
    """Two Trainer steps (one per mode) under bf16 against JAX's train_step
    from the same params and batches: losses within the score tolerance;
    99 % of the param elements within 1e-3 (a tenth of lr = 0.01: Adam's
    second step weighs two gradients that differ by bf16 roundings) and
    every one within 0.04 (Adam's first steps move an element by about lr
    times the sign of its gradient, so a near-zero gradient whose sign the
    two bf16 computations round apart moves it by up to 2 lr a step)."""
    from knowledgegraphembedding_tpu import optim as j_optim

    jspec, tspec, p, pos, neg, w = _setup(model, de, dr, seed=4)
    kw = dict(negative_sample_size=12, batch_size=8, negative_adversarial_sampling=True,
              precision="bf16")
    jts, tts = JTrainSpec(**kw), TTrainSpec(**kw)
    jp, state = _j(p), j_optim.init_state(_j(p))
    trainer = t_train.Trainer(tspec, tts, _t(p), lr=0.01, warm_up_steps=10)
    for mode in MODES:
        jp, state, logs = j_train.train_step(jp, state, jnp.asarray(pos), jnp.asarray(neg),
                                             jnp.asarray(w), jnp.asarray(0.01, jnp.float32),
                                             spec=jspec, tspec=jts, mode=mode)
        got = trainer.one_step((torch.from_numpy(pos), torch.from_numpy(neg),
                                torch.from_numpy(w), mode))
        np.testing.assert_allclose(float(got["loss"]), float(logs["loss"]), rtol=0,
                                   atol=SCORE_ATOL)
    for k, v in trainer.params.items():
        assert v.dtype == torch.float32
        diff = np.abs(v.detach().numpy() - np.asarray(jp[k]))
        assert diff.max() <= 0.04 and np.mean(diff <= 1e-3) >= 0.99, (k, diff.max())


def test_bf16_training_learns():
    """tests/test_precision.py::test_bf16_training_learns on the port's
    Trainer: the loss falls and HITS@10 > 0.3."""
    ds = make_clustered_kg(n_clusters=5, entities_per_cluster=8, nrelation=2, seed=7)
    spec = TSpec(model_name="RotatE", nentity=ds.nentity, nrelation=ds.nrelation,
                 hidden_dim=24, gamma=5.0, double_entity_embedding=True)
    tspec = TTrainSpec(negative_sample_size=16, batch_size=64,
                       negative_adversarial_sampling=True, precision="bf16")
    params = t_kge.init_params(spec, torch.Generator().manual_seed(0), device="cpu")
    trainer = t_train.Trainer(spec, tspec, params, lr=5e-3, warm_up_steps=10**9)
    it = t_iterator(ds.train, ds.nentity, ds.nrelation, 64, 16, prefetch_depth=0,
                    backend="numpy")
    losses = []
    for _ in range(250):
        pos, neg, w, mode = next(it)
        logs = trainer.one_step((torch.from_numpy(pos), torch.from_numpy(neg),
                                 torch.from_numpy(w), mode))
        losses.append(float(logs["loss"]))
    assert losses[-1] < losses[0]
    filters = TFilterSets.build(ds.train, ds.all_true_triples, ds.nentity, ds.nrelation)
    metrics = t_eval.test_step(trainer.params, spec, ds.test, filters, test_batch_size=8,
                               eval_chunk_size=16)
    assert metrics["HITS@10"] > 0.3, metrics

