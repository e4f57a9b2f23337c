"""The port's scorers and forward pass against the JAX package's on the same
numpy inputs: five models x three layouts, f32, rtol = atol = 1e-5 (the two
frameworks' sin/cos and reduction orders differ in the last bits)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from knowledgegraphembedding_torch.config import ModelSpec as TSpec
from knowledgegraphembedding_torch.models import kge as t_kge
from knowledgegraphembedding_torch.models import scorers as t_scorers
from knowledgegraphembedding_tpu.config import ModelSpec as JSpec
from knowledgegraphembedding_tpu.models import kge as j_kge
from knowledgegraphembedding_tpu.models import scorers as j_scorers

MODELS = [("TransE", False, False), ("DistMult", False, False),
          ("ComplEx", True, True), ("RotatE", True, False),
          ("pRotatE", False, False)]
MODES = ["single", "head-batch", "tail-batch"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _spec_kw(model, de, dr, E=30, R=4, d=8, gamma=6.0):
    return dict(model_name=model, nentity=E, nrelation=R, hidden_dim=d, gamma=gamma,
                double_entity_embedding=de, double_relation_embedding=dr)


def _params(spec, seed=0):
    rng = np.random.default_rng(seed)
    r = spec.embedding_range
    p = {
        "entity_embedding": rng.uniform(-r, r, (spec.nentity, spec.entity_dim)).astype(np.float32),
        "relation_embedding": rng.uniform(-r, r, (spec.nrelation, spec.relation_dim)).astype(np.float32),
    }
    if spec.has_modulus:
        p["modulus"] = np.float32(0.5 * r)
    return p


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("model,de,dr", MODELS, ids=[m[0] for m in MODELS])
def test_score_fn_matches_jax(model, de, dr, mode):
    spec = JSpec(**_spec_kw(model, de, dr))
    rng = np.random.default_rng(1)
    r = spec.embedding_range
    B, n = 5, 7
    wide = n if mode != "single" else 1
    h = rng.uniform(-r, r, (B, wide if mode == "head-batch" else 1, spec.entity_dim))
    rel = rng.uniform(-r, r, (B, 1, spec.relation_dim))
    t = rng.uniform(-r, r, (B, wide if mode == "tail-batch" else 1, spec.entity_dim))
    h, rel, t = (x.astype(np.float32) for x in (h, rel, t))
    modulus = np.float32(0.5 * r)
    kw = dict(gamma=spec.gamma, embedding_range=spec.embedding_range, mode=mode)
    want = np.asarray(j_scorers.score_fn(model, jnp.asarray(h), jnp.asarray(rel),
                                         jnp.asarray(t), modulus=jnp.asarray(modulus), **kw))
    got = t_scorers.score_fn(model, torch.from_numpy(h), torch.from_numpy(rel),
                             torch.from_numpy(t), modulus=torch.tensor(modulus), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("model,de,dr", MODELS, ids=[m[0] for m in MODELS])
def test_forward_matches_jax(model, de, dr, mode):
    kw = _spec_kw(model, de, dr)
    jspec, tspec = JSpec(**kw), TSpec(**kw)
    p = _params(jspec)
    rng = np.random.default_rng(2)
    pos = np.stack([rng.integers(0, 30, 6), rng.integers(0, 4, 6), rng.integers(0, 30, 6)], 1)
    neg = rng.integers(0, 30, (6, 9))
    if mode == "single":
        j_sample, t_sample = jnp.asarray(pos), torch.from_numpy(pos)
    else:
        j_sample = (jnp.asarray(pos), jnp.asarray(neg))
        t_sample = (torch.from_numpy(pos), torch.from_numpy(neg))
    want = np.asarray(j_kge.forward({k: jnp.asarray(v) for k, v in p.items()},
                                    jspec, j_sample, mode))
    got = t_kge.forward(t_kge.params_from_numpy(p, "cpu"), tspec, t_sample, mode)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_rotate_guard_keeps_zero_distance_finite_in_grad():
    """sqrt(max(sq, 1e-30)): an exact zero distance has a finite gradient."""
    h = torch.zeros(1, 1, 4, requires_grad=True)
    r = torch.zeros(1, 1, 2)
    t = torch.zeros(1, 1, 4)
    s = t_scorers.rotate(h, r, t, 6.0, 1.0, "single")
    s.sum().backward()
    assert torch.isfinite(h.grad).all()
    assert float(s.detach()) == pytest.approx(6.0)


def test_accumulator_never_downcasts():
    x = torch.ones(2, 3, 4, dtype=torch.float64)
    assert t_scorers.transe(x, x, x, 1.0, "single").dtype == torch.float64
    y = x.to(torch.bfloat16)
    assert t_scorers.distmult(y, y, y, "single").dtype == torch.float32


def test_model_spec_asserts_match_jax():
    for kw in (_spec_kw("RotatE", False, False), _spec_kw("ComplEx", True, False)):
        with pytest.raises(ValueError):
            JSpec(**kw)
        with pytest.raises(ValueError):
            TSpec(**kw)
    kw = _spec_kw("pRotatE", False, False, gamma=9.0, d=1000)
    assert TSpec(**kw).embedding_range == JSpec(**kw).embedding_range
    assert TSpec(**kw).has_modulus


def test_init_params_range_and_modulus():
    spec = TSpec(**_spec_kw("pRotatE", False, False))
    gen = torch.Generator().manual_seed(0)
    p = t_kge.init_params(spec, gen, device="cpu")
    r = spec.embedding_range
    assert p["entity_embedding"].shape == (30, 8)
    assert p["relation_embedding"].shape == (4, 8)
    assert float(p["entity_embedding"].abs().max()) <= r
    assert float(p["modulus"]) == pytest.approx(0.5 * r)
    again = t_kge.init_params(spec, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again["entity_embedding"], p["entity_embedding"])
