"""Checkpoints move between the two packages bit for bit: a port save
restores into a JAX trainer and a JAX save into a port trainer with every
array and scalar equal, and a port run saved and resumed equals the same run
without the break."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from knowledgegraphembedding_torch import checkpoint as t_ckpt
from knowledgegraphembedding_torch import train as t_train
from knowledgegraphembedding_torch.config import RunConfig as TRunConfig
from knowledgegraphembedding_torch.models import kge as t_kge
from knowledgegraphembedding_tpu import checkpoint as j_ckpt
from knowledgegraphembedding_tpu import train as j_train
from knowledgegraphembedding_tpu.config import RunConfig as JRunConfig
from knowledgegraphembedding_tpu.data.filterset import FilterSets
from knowledgegraphembedding_tpu.data.synthetic import make_clustered_kg
from knowledgegraphembedding_tpu.sampler import build_train_iterator

CFG = dict(model="pRotatE", hidden_dim=6, gamma=5.0, negative_sample_size=4, batch_size=8,
           negative_adversarial_sampling=True, learning_rate=0.01,
           data_path="synthetic:clustered")
ARTIFACTS = {"config.json", "checkpoint.npz", "entity_embedding.npy", "relation_embedding.npy"}


@pytest.fixture(scope="module")
def setup():
    ds = make_clustered_kg(n_clusters=3, entities_per_cluster=8, nrelation=2, seed=4)
    filters = FilterSets.build(ds.train, ds.all_true_triples, ds.nentity, ds.nrelation)
    it = build_train_iterator(ds.train, ds.nentity, ds.nrelation, 8, 4, filters,
                              seed=0, prefetch_depth=0, backend="numpy")
    batches = [next(it) for _ in range(12)]
    cfgs = []
    for cls in (JRunConfig, TRunConfig):
        cfg = cls(**CFG)
        cfg.nentity, cfg.nrelation = ds.nentity, ds.nrelation
        cfgs.append(cfg)
    jcfg, tcfg = cfgs
    rng = np.random.default_rng(0)
    spec = jcfg.model_spec()
    r = spec.embedding_range
    p0 = {"entity_embedding": rng.uniform(-r, r, (ds.nentity, 6)).astype(np.float32),
          "relation_embedding": rng.uniform(-r, r, (ds.nrelation, 6)).astype(np.float32),
          "modulus": np.asarray(0.5 * r, np.float32)}
    return batches, jcfg, tcfg, p0


def _t_batch(b):
    pos, neg, w, mode = b
    return torch.from_numpy(pos), torch.from_numpy(neg), torch.from_numpy(w), mode


def _j_batch(b):
    pos, neg, w, mode = b
    return jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(w), mode


def _port_trainer(tcfg, p0, warm_up=3):
    return t_train.Trainer(tcfg.model_spec(), tcfg.train_spec(),
                           t_kge.params_from_numpy(p0, "cpu"), lr=tcfg.learning_rate,
                           warm_up_steps=warm_up)


def _assert_npz_equal(a_dir, b_dir):
    with np.load(os.path.join(a_dir, "checkpoint.npz")) as a, \
            np.load(os.path.join(b_dir, "checkpoint.npz")) as b:
        assert list(a.files) == list(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_port_save_restores_in_jax(setup, tmp_path):
    batches, jcfg, tcfg, p0 = setup
    tt = _port_trainer(tcfg, p0)
    for b in batches[:5]:  # across the decay: fresh Adam at step 3, count 1 after
        tt.one_step(_t_batch(b))
    t_ckpt.save_model(tt, tcfg, str(tmp_path))
    assert set(os.listdir(tmp_path)) == ARTIFACTS

    jt = j_train.Trainer(jcfg.model_spec(), jcfg.train_spec(),
                         {k: jnp.zeros_like(jnp.asarray(v)) for k, v in p0.items()},
                         lr=1.0, warm_up_steps=0)
    j_ckpt.restore_trainer(jt, str(tmp_path))
    assert (jt.step, jt.current_learning_rate, jt.warm_up_steps, int(jt.opt_state.count)) == (
        tt.step, tt.current_learning_rate, tt.warm_up_steps, tt.opt_state.count) == (
        5, 0.001, 9, 1)
    for k, v in tt.params.items():
        np.testing.assert_array_equal(np.asarray(jt.params[k]), v.detach().numpy())
        np.testing.assert_array_equal(np.asarray(jt.opt_state.m[k]), tt.opt_state.m[k].numpy())
        np.testing.assert_array_equal(np.asarray(jt.opt_state.v[k]), tt.opt_state.v[k].numpy())
    np.testing.assert_array_equal(np.load(tmp_path / "entity_embedding.npy"),
                                  tt.params["entity_embedding"].detach().numpy())

    # the JAX package writing the same state gives the same arrays, key for key
    j_ckpt.save_model(jt, jcfg, str(tmp_path / "jax"))
    _assert_npz_equal(str(tmp_path), str(tmp_path / "jax"))


def test_jax_save_restores_in_port(setup, tmp_path):
    batches, jcfg, tcfg, p0 = setup
    jt = j_train.Trainer(jcfg.model_spec(), jcfg.train_spec(),
                         {k: jnp.asarray(v) for k, v in p0.items()}, lr=0.01, warm_up_steps=3)
    for b in batches[:6]:
        jt.one_step(_j_batch(b))
    j_ckpt.save_model(jt, jcfg, str(tmp_path))
    tt = _port_trainer(tcfg, {k: np.zeros_like(v) for k, v in p0.items()}, warm_up=0)
    t_ckpt.restore_trainer(tt, str(tmp_path))
    assert (tt.step, tt.current_learning_rate, tt.warm_up_steps, tt.opt_state.count) == (
        jt.step, jt.current_learning_rate, jt.warm_up_steps, int(jt.opt_state.count))
    for k in p0:
        assert tt.params[k].requires_grad and tt.params[k].dtype == torch.float32
        np.testing.assert_array_equal(tt.params[k].detach().numpy(), np.asarray(jt.params[k]))
        np.testing.assert_array_equal(tt.opt_state.m[k].numpy(), np.asarray(jt.opt_state.m[k]))
        np.testing.assert_array_equal(tt.opt_state.v[k].numpy(), np.asarray(jt.opt_state.v[k]))
    t_ckpt.save_model(tt, tcfg, str(tmp_path / "port"))
    _assert_npz_equal(str(tmp_path), str(tmp_path / "port"))


@pytest.mark.parametrize("n_first", [2, 4], ids=["before-decay", "after-decay"])
def test_save_resume_equals_straight_run(setup, tmp_path, n_first):
    batches, _, tcfg, p0 = setup
    straight = _port_trainer(tcfg, p0)
    for b in batches[:10]:
        straight.one_step(_t_batch(b))

    first = _port_trainer(tcfg, p0)
    for b in batches[:n_first]:
        first.one_step(_t_batch(b))
    t_ckpt.save_model(first, tcfg, str(tmp_path))
    resumed = _port_trainer(tcfg, {k: np.zeros_like(v) for k, v in p0.items()}, warm_up=0)
    t_ckpt.restore_trainer(resumed, str(tmp_path))
    for b in batches[n_first:10]:
        resumed.one_step(_t_batch(b))

    assert (resumed.step, resumed.current_learning_rate, resumed.warm_up_steps,
            resumed.opt_state.count) == (straight.step, straight.current_learning_rate,
                                         straight.warm_up_steps, straight.opt_state.count)
    for k in p0:
        assert torch.equal(resumed.params[k], straight.params[k]), k
        assert torch.equal(resumed.opt_state.m[k], straight.opt_state.m[k]), k
