"""The port's loss, Adam update and scorer gradients against the JAX
package's on the same numpy inputs.

Tolerances: f32 rtol 1e-6 for the loss and the Adam step (one reduction over
a few dozen terms, summed in another order), rtol 1e-5 / atol 1e-6 for the
scorer gradients (torch and XLA evaluate sin/cos differently in the last
bits); f64 rtol 1e-12 throughout (the JAX side runs with jax_enable_x64)."""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from knowledgegraphembedding_torch import optim as t_optim
from knowledgegraphembedding_torch.config import ModelSpec as TSpec
from knowledgegraphembedding_torch.config import TrainSpec as TTrainSpec
from knowledgegraphembedding_torch.models import kge as t_kge
from knowledgegraphembedding_torch.ops import loss as t_loss
from knowledgegraphembedding_tpu import optim as j_optim
from knowledgegraphembedding_tpu.config import ModelSpec as JSpec
from knowledgegraphembedding_tpu.config import TrainSpec as JTrainSpec
from knowledgegraphembedding_tpu.models import kge as j_kge
from knowledgegraphembedding_tpu.ops import loss as j_loss

DTYPES = {"f32": (np.float32, dict(rtol=1e-6, atol=0)),
          "f64": (np.float64, dict(rtol=1e-12, atol=0))}
MODELS = [("TransE", False, False), ("DistMult", False, False),
          ("ComplEx", True, True), ("RotatE", True, False),
          ("pRotatE", False, False)]


@contextlib.contextmanager
def jax_precision(dtype):
    """f64 on the JAX side needs jax_enable_x64 (restored afterwards)."""
    jax.config.update("jax_enable_x64", dtype == np.float64)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("reg", [0.0, 1e-3])
@pytest.mark.parametrize("uni", [False, True], ids=["subsampling", "uni_weight"])
@pytest.mark.parametrize("adv", [True, False], ids=["adv", "mean"])
def test_kge_loss_matches_jax(adv, uni, reg, dtype):
    np_dt, tol = DTYPES[dtype]
    rng = np.random.default_rng(0)
    B, n = 12, 9
    pos = (rng.normal(size=(B, 1)) * 3).astype(np_dt)
    neg = (rng.normal(size=(B, n)) * 3).astype(np_dt)
    w = rng.uniform(0.1, 1.0, B).astype(np_dt)
    tables = {"entity_embedding": rng.uniform(-1, 1, (20, 6)).astype(np_dt),
              "relation_embedding": rng.uniform(-1, 1, (3, 6)).astype(np_dt)}
    kw = dict(negative_adversarial_sampling=adv, adversarial_temperature=0.7,
              uni_weight=uni, regularization=reg)
    with jax_precision(np_dt):
        loss, want = j_loss.kge_loss(jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(w),
                                     JTrainSpec(**kw))
        want = {k: float(v) for k, v in want.items()}
        want_reg = float(j_loss.l3_regularization(
            {k: jnp.asarray(v) for k, v in tables.items()}, reg))
    got_loss, got = t_loss.kge_loss(torch.from_numpy(pos), torch.from_numpy(neg),
                                    torch.from_numpy(w), TTrainSpec(**kw))
    assert got_loss.dtype == torch.from_numpy(pos).dtype
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], **tol, err_msg=k)
    got_reg = t_loss.l3_regularization({k: torch.from_numpy(v) for k, v in tables.items()}, reg)
    np.testing.assert_allclose(float(got_reg), want_reg, **tol)


def test_adversarial_weights_carry_no_gradient():
    neg = torch.randn(4, 5, dtype=torch.float64, requires_grad=True)
    pos = torch.randn(4, 1, dtype=torch.float64)
    spec = TTrainSpec(negative_adversarial_sampling=True, uni_weight=True)
    loss, _ = t_loss.kge_loss(pos, neg, torch.ones(4, dtype=torch.float64), spec)
    g, = torch.autograd.grad(loss, neg)
    # d/dx of -sum(softmax(x).detach() * logsigmoid(-x)) / (2B)
    w = torch.softmax(neg.detach(), dim=1)
    want = w * torch.sigmoid(neg.detach()) / (2 * 4)
    torch.testing.assert_close(g, want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_adam_steps_match_jax(dtype):
    np_dt, tol = DTYPES[dtype]
    rng = np.random.default_rng(1)
    p = {"entity_embedding": rng.uniform(-1, 1, (9, 4)).astype(np_dt),
         "relation_embedding": rng.uniform(-1, 1, (3, 4)).astype(np_dt),
         "modulus": np.asarray(0.4, np_dt)}
    grads = [{k: np.asarray(rng.normal(size=np.shape(v)) * 1e-2, np_dt) for k, v in p.items()}
             for _ in range(3)]
    lr = 0.01
    with jax_precision(np_dt):
        jp = {k: jnp.asarray(v) for k, v in p.items()}
        state = j_optim.init_state(jp)
        for g in grads:
            jp, state = j_optim.apply_update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                                             state, jnp.asarray(lr, np_dt))
        want = ({k: np.asarray(v) for k, v in jp.items()},
                {k: np.asarray(v) for k, v in state.m.items()},
                {k: np.asarray(v) for k, v in state.v.items()}, int(state.count))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    tstate = t_optim.init_state(tp)
    for g in grads:
        t_optim.apply_update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, tstate,
                             torch.tensor(lr, dtype=tp["entity_embedding"].dtype))
    assert tstate.count == want[3] == 3
    for got_d, want_d in zip((tp, tstate.m, tstate.v), want[:3]):
        for k in p:
            assert got_d[k].numpy().dtype == want_d[k].dtype
            np.testing.assert_allclose(got_d[k].numpy(), want_d[k], **tol, err_msg=k)


def test_adam_state_from_jax_numpy():
    params = {"entity_embedding": jnp.ones((3, 2)), "relation_embedding": jnp.zeros((2, 2))}
    state = j_optim.init_state(params)
    state = j_optim.AdamState(count=state.count + 5,
                              m={k: v + 1 for k, v in state.m.items()}, v=state.v)
    got = t_optim.state_from_numpy(state.count, state.m, state.v, "cpu")
    assert got.count == 5
    for k in params:
        np.testing.assert_array_equal(got.m[k].numpy(), np.asarray(state.m[k]))
        np.testing.assert_array_equal(got.v[k].numpy(), np.asarray(state.v[k]))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["single", "head-batch", "tail-batch"])
@pytest.mark.parametrize("model,de,dr", MODELS, ids=[m[0] for m in MODELS])
def test_scorer_grads_match_jax(model, de, dr, mode, dtype):
    np_dt, _ = DTYPES[dtype]
    tol = dict(rtol=1e-5, atol=1e-6) if np_dt == np.float32 else dict(rtol=1e-12, atol=1e-14)
    kw = dict(model_name=model, nentity=30, nrelation=4, hidden_dim=8, gamma=6.0,
              double_entity_embedding=de, double_relation_embedding=dr)
    jspec, tspec = JSpec(**kw), TSpec(**kw)
    rng = np.random.default_rng(2)
    r = jspec.embedding_range
    p = {"entity_embedding": rng.uniform(-r, r, (30, jspec.entity_dim)).astype(np_dt),
         "relation_embedding": rng.uniform(-r, r, (4, jspec.relation_dim)).astype(np_dt)}
    if jspec.has_modulus:
        p["modulus"] = np.asarray(0.5 * r, np_dt)
    pos = np.stack([rng.integers(0, 30, 6), rng.integers(0, 4, 6), rng.integers(0, 30, 6)], 1)
    neg = rng.integers(0, 30, (6, 5))
    width = 1 if mode == "single" else 5
    cot = rng.normal(size=(6, width)).astype(np_dt)  # a random cotangent of the scores

    with jax_precision(np_dt):
        j_sample = jnp.asarray(pos) if mode == "single" else (jnp.asarray(pos), jnp.asarray(neg))

        def j_obj(params):
            return jnp.sum(j_kge.forward(params, jspec, j_sample, mode) * jnp.asarray(cot))

        want = jax.grad(j_obj)({k: jnp.asarray(v) for k, v in p.items()})
        want = {k: np.asarray(v) for k, v in want.items()}

    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True) for k, v in p.items()}
    t_sample = (torch.from_numpy(pos) if mode == "single"
                else (torch.from_numpy(pos), torch.from_numpy(neg)))
    obj = torch.sum(t_kge.forward(tp, tspec, t_sample, mode) * torch.from_numpy(cot))
    got = dict(zip(tp, torch.autograd.grad(obj, list(tp.values()))))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k], **tol, err_msg=k)
