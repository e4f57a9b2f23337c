"""The port's train step and Trainer against the JAX package's on the same
numpy params and recorded batches.

Tolerances: one step (loss, gradients, Adam) at f32 rtol 1e-5 / atol 1e-7
(sin/cos and reductions round differently in the last bits) and at f64
rtol 1e-12; a trajectory of 200 steps across the LR decay at f64 keeps the
params within 1e-9 (op-order noise grows from ~1e-16 per step), and at f32
its loss windows agree to 1e-3."""

import contextlib
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from knowledgegraphembedding_torch import train as t_train
from knowledgegraphembedding_torch.config import ModelSpec as TSpec
from knowledgegraphembedding_torch.config import TrainSpec as TTrainSpec
from knowledgegraphembedding_torch.models import kge as t_kge
from knowledgegraphembedding_tpu import optim as j_optim
from knowledgegraphembedding_tpu import train as j_train
from knowledgegraphembedding_tpu.config import ModelSpec as JSpec
from knowledgegraphembedding_tpu.config import TrainSpec as JTrainSpec
from knowledgegraphembedding_tpu.data.filterset import FilterSets
from knowledgegraphembedding_tpu.data.synthetic import make_clustered_kg
from knowledgegraphembedding_tpu.sampler import build_train_iterator

MODELS = [("TransE", False, False, False, False, 0.0),
          ("DistMult", False, False, False, True, 1e-4),
          ("ComplEx", True, True, True, False, 1e-5),
          ("RotatE", True, False, True, False, 0.0),
          ("pRotatE", False, False, True, False, 0.0)]
IDS = [m[0] for m in MODELS]


@contextlib.contextmanager
def jax_precision(dtype):
    jax.config.update("jax_enable_x64", dtype == np.float64)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def stream():
    ds = make_clustered_kg(n_clusters=4, entities_per_cluster=12, nrelation=3, seed=7)
    filters = FilterSets.build(ds.train, ds.all_true_triples, ds.nentity, ds.nrelation)
    it = build_train_iterator(ds.train, ds.nentity, ds.nrelation, 16, 8, filters,
                              seed=0, prefetch_depth=0, backend="numpy")
    return ds, [next(it) for _ in range(200)]


def _specs(ds, model, de, dr, adv, uni, reg, d=8):
    kw = dict(model_name=model, nentity=ds.nentity, nrelation=ds.nrelation, hidden_dim=d,
              gamma=6.0, double_entity_embedding=de, double_relation_embedding=dr)
    tkw = dict(negative_sample_size=8, batch_size=16, negative_adversarial_sampling=adv,
               adversarial_temperature=1.0, uni_weight=uni, regularization=reg)
    return (JSpec(**kw), TSpec(**kw), JTrainSpec(scoring="gather", **tkw),
            TTrainSpec(scoring="gather", **tkw))


def _params(spec, dtype, seed=0):
    rng = np.random.default_rng(seed)
    r = spec.embedding_range
    p = {"entity_embedding": rng.uniform(-r, r, (spec.nentity, spec.entity_dim)),
         "relation_embedding": rng.uniform(-r, r, (spec.nrelation, spec.relation_dim))}
    if spec.has_modulus:
        p["modulus"] = np.asarray(0.5 * r)
    return {k: np.asarray(v, dtype) for k, v in p.items()}


def _t_batch(batch, dtype):
    pos, neg, w, mode = batch
    return (torch.from_numpy(pos), torch.from_numpy(neg),
            torch.from_numpy(np.asarray(w, dtype)), mode)


def _j_batch(batch, dtype):
    pos, neg, w, mode = batch
    return jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(np.asarray(w, dtype)), mode


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("model,de,dr,adv,uni,reg", MODELS, ids=IDS)
def test_train_step_matches_jax(stream, model, de, dr, adv, uni, reg, dtype):
    ds, batches = stream
    jspec, tspec, jts, tts = _specs(ds, model, de, dr, adv, uni, reg)
    p = _params(jspec, dtype)
    tol = (dict(rtol=1e-5, atol=1e-7) if dtype == np.float32
           else dict(rtol=1e-12, atol=1e-15))
    lr = 0.01
    with jax_precision(dtype):
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        state = j_optim.init_state(jp)
        want_logs = []
        for batch in batches[:2]:  # one tail-batch and one head-batch step
            pos, neg, w, mode = _j_batch(batch, dtype)
            jp, state, logs = j_train.train_step(jp, state, pos, neg, w, jnp.asarray(lr, dtype),
                                                 spec=jspec, tspec=jts, mode=mode)
            want_logs.append({k: float(v) for k, v in logs.items()})
        want = {k: np.asarray(v) for k, v in jp.items()}

    trainer = t_train.Trainer(tspec, tts, t_kge.params_from_numpy(p, "cpu"), lr=lr,
                              warm_up_steps=10)
    for batch, wl in zip(batches[:2], want_logs):
        logs = trainer.one_step(_t_batch(batch, dtype))
        assert set(logs) == set(wl)
        for k in wl:
            np.testing.assert_allclose(float(logs[k]), wl[k], **tol, err_msg=k)
    for k in want:
        got = trainer.params[k].detach().numpy()
        assert got.dtype == want[k].dtype
        np.testing.assert_allclose(got, want[k], **tol, err_msg=k)


def test_trainer_decay_matches_jax(stream, caplog):
    ds, batches = stream
    jspec, tspec, jts, tts = _specs(ds, *MODELS[3])
    p = _params(jspec, np.float32)
    jt = j_train.Trainer(jspec, jts, {k: jnp.asarray(v) for k, v in p.items()},
                         lr=0.01, warm_up_steps=3)
    tt = t_train.Trainer(tspec, tts, t_kge.params_from_numpy(p, "cpu"), lr=0.01,
                         warm_up_steps=3)
    seen = []
    with caplog.at_level(logging.INFO):
        for batch in batches[:12]:
            jt.one_step(_j_batch(batch, np.float32))
            tt.one_step(_t_batch(batch, np.float32))
            want = (jt.step, jt.current_learning_rate, jt.warm_up_steps, int(jt.opt_state.count))
            got = (tt.step, tt.current_learning_rate, tt.warm_up_steps, tt.opt_state.count)
            assert got == want
            seen.append(got)
    # the step with index 3 still trains at 0.01, then lr/10, a fresh Adam, warm_up x3;
    # the step with index 9 decays again
    assert seen[3] == (4, 0.001, 9, 0) and seen[9] == (10, 0.0001, 27, 0)
    assert seen[4][3] == 1
    lines = [r.getMessage() for r in caplog.records
             if "Change learning_rate" in r.getMessage()
             and "knowledgegraphembedding_torch" in r.pathname]
    assert lines == ["Change learning_rate to 0.001000 at step 3",
                     "Change learning_rate to 0.000100 at step 9"]


def _trajectory(jspec, tspec, jts, tts, p, batches, dtype, warm_up, log_every):
    with jax_precision(dtype):
        jt = j_train.Trainer(jspec, jts, {k: jnp.asarray(v) for k, v in p.items()},
                             lr=0.01, warm_up_steps=warm_up)
        j_losses = [float(jt.one_step(_j_batch(b, dtype))["loss"]) for b in batches]
        jp = {k: np.asarray(v) for k, v in jt.params.items()}
    tt = t_train.Trainer(tspec, tts, t_kge.params_from_numpy(p, "cpu"), lr=0.01,
                         warm_up_steps=warm_up)
    t_losses = [float(tt.one_step(_t_batch(b, dtype))["loss"]) for b in batches]
    windows = [np.reshape(x, (-1, log_every)).mean(1) for x in (j_losses, t_losses)]
    tp = {k: v.detach().numpy() for k, v in tt.params.items()}
    return windows, jp, tp


@pytest.mark.parametrize("model", ["RotatE", "pRotatE"])
def test_f64_trajectory_across_decay(stream, model):
    ds, batches = stream
    spec_args = next(m for m in MODELS if m[0] == model)
    jspec, tspec, jts, tts = _specs(ds, *spec_args)
    p = _params(jspec, np.float64)
    (jw, tw), jp, tp = _trajectory(jspec, tspec, jts, tts, p, batches, np.float64,
                                   warm_up=100, log_every=50)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-9)
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("model", ["RotatE", "pRotatE"])
def test_f32_loss_windows_across_decay(stream, model):
    ds, batches = stream
    spec_args = next(m for m in MODELS if m[0] == model)
    jspec, tspec, jts, tts = _specs(ds, *spec_args)
    p = _params(jspec, np.float32)
    (jw, tw), _, _ = _trajectory(jspec, tspec, jts, tts, p, batches, np.float32,
                                 warm_up=100, log_every=50)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-3)


def test_trainer_seeded_from_jax_state_continues_identically(stream):
    ds, batches = stream
    jspec, tspec, jts, tts = _specs(ds, *MODELS[4])
    p = _params(jspec, np.float64)
    with jax_precision(np.float64):
        jt = j_train.Trainer(jspec, jts, {k: jnp.asarray(v) for k, v in p.items()},
                             lr=0.01, warm_up_steps=4)
        for b in batches[:6]:
            jt.one_step(_j_batch(b, np.float64))
        tt = t_train.Trainer.from_jax_state(
            tspec, tts, {k: np.asarray(v) for k, v in jt.params.items()}, jt.opt_state,
            jt.step, jt.current_learning_rate, jt.warm_up_steps, "cpu")
        assert (tt.step, tt.warm_up_steps, tt.opt_state.count) == (6, 12, 1)
        for b in batches[6:10]:
            jt.one_step(_j_batch(b, np.float64))
            tt.one_step(_t_batch(b, np.float64))
        want = {k: np.asarray(v) for k, v in jt.params.items()}
    for k in want:
        np.testing.assert_allclose(tt.params[k].detach().numpy(), want[k], rtol=1e-12,
                                   atol=1e-15, err_msg=k)


def test_trainer_owns_its_params_and_refuses_unported_modes(stream):
    ds, batches = stream
    jspec, tspec, _, tts = _specs(ds, *MODELS[0])
    p = t_kge.params_from_numpy(_params(jspec, np.float32), "cpu")
    tt = t_train.Trainer(tspec, tts, p, lr=0.01, warm_up_steps=5)
    assert tt.params["entity_embedding"] is not p["entity_embedding"]
    assert all(v.requires_grad and v.is_leaf for v in tt.params.values())
    # TransE has no bilinear form, as the JAX package's use_dense_scoring says
    with pytest.raises(ValueError, match="TransE has no dense bilinear form"):
        t_train.Trainer(tspec, TTrainSpec(scoring="dense"), p, lr=0.01, warm_up_steps=5)
    with pytest.raises(ValueError, match="TransE has no dense bilinear form"):
        j_train.use_dense_scoring(jspec, JTrainSpec(scoring="dense"))
    # bf16 (once refused) builds and steps, the params staying f32 masters
    bf16 = t_train.Trainer(tspec, TTrainSpec(precision="bf16", negative_sample_size=8,
                                             batch_size=16), p, lr=0.01, warm_up_steps=5)
    pos, neg, w, mode = _t_batch(batches[0], np.float32)
    assert np.isfinite(float(bf16.one_step((pos, neg, w, mode))["loss"]))
    assert all(v.dtype == torch.float32 for v in bf16.params.values())
