"""The port's evaluation against the JAX package's on the same weights: the
device-built filter mask, the plain chunked ranker, and whole test_step
metrics with host and device filters (CPU; the rank kernel's plain version).
Metrics follow from the ranks, so they are compared exactly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from knowledgegraphembedding_torch import eval as t_eval
from knowledgegraphembedding_torch.config import ModelSpec as TSpec
from knowledgegraphembedding_torch.data.filterset import FilterSets as TFilterSets
from knowledgegraphembedding_torch.models import kge as t_kge
from knowledgegraphembedding_tpu import eval as j_eval
from knowledgegraphembedding_tpu.config import ModelSpec as JSpec
from knowledgegraphembedding_tpu.data.filterset import FilterSets as JFilterSets
from knowledgegraphembedding_tpu.data.synthetic import make_random_kg
from knowledgegraphembedding_tpu.models import kge as j_kge

MODES = ["head-batch", "tail-batch"]


def _setup(model="RotatE", E=73, R=5, seed=0, n_test=40):
    ds = make_random_kg(nentity=E, nrelation=R, ntriples=400, n_valid=40,
                        n_test=n_test, seed=seed)
    kw = dict(model_name=model, nentity=E, nrelation=R, hidden_dim=16, gamma=6.0,
              double_entity_embedding=model in ("RotatE", "ComplEx"),
              double_relation_embedding=model == "ComplEx")
    jspec, tspec = JSpec(**kw), TSpec(**kw)
    jparams = j_kge.init_params(jspec, jax.random.PRNGKey(1))
    tparams = t_kge.params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    jf = JFilterSets.build(ds.train, ds.all_true_triples, E, R)
    tf = TFilterSets.build(ds.train, ds.all_true_triples, E, R)
    return ds, jspec, tspec, jparams, tparams, jf, tf


@pytest.mark.parametrize("mode", MODES)
def test_device_mask_matches_jax(mode):
    ds, jspec, tspec, jparams, tparams, jf, tf = _setup()
    pos = np.asarray(ds.test[:16], np.int32)
    width = -(-tspec.nentity // 16) * 16
    want = np.asarray(j_eval.DeviceFilter(jf).mask_rows(jnp.asarray(pos), mode, width=width))
    got = t_eval.DeviceFilter(tf, "cpu").mask_rows(torch.from_numpy(pos), mode, width=width)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:, :tspec.nentity], tf.filter_mask_rows(pos, mode))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("model", ["RotatE", "TransE", "pRotatE"])
def test_ranks_batch_matches_jax(model, mode):
    ds, jspec, tspec, jparams, tparams, jf, tf = _setup(model)
    pos = np.asarray(ds.test[:8], np.int32)
    mask = t_eval._pad_mask(tf.filter_mask_rows(pos, mode), 16)
    want = np.asarray(j_eval.ranks_batch(jparams, jnp.asarray(pos), jnp.asarray(mask),
                                         spec=jspec, mode=mode, chunk=16))
    got = t_eval.ranks_batch(tparams, torch.from_numpy(pos), torch.from_numpy(mask),
                             spec=tspec, mode=mode, chunk=16)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("device_filter", [False, True])
@pytest.mark.parametrize("model", ["RotatE", "TransE", "pRotatE"])
def test_test_step_matches_jax(model, device_filter):
    ds, jspec, tspec, jparams, tparams, jf, tf = _setup(model)
    kw = dict(test_batch_size=8, eval_chunk_size=32, device_filter=device_filter)
    want = j_eval.test_step(jparams, jspec, ds.test, jf, use_pallas=False, **kw)
    got_plain = t_eval.test_step(tparams, tspec, ds.test, tf, use_kernel=False, **kw)
    assert got_plain == want
    if model != "pRotatE":  # the rank kernel's path (its plain version on CPU)
        assert t_eval.test_step(tparams, tspec, ds.test, tf, use_kernel=True, **kw) == want


@pytest.mark.parametrize("E,chunk,n_test,tb", [
    (64, 16, 7, 4),    # chunk_pad == E, width = E + 1
    (33, 16, 5, 4),    # ragged E and batches
    (48, 16, 97, 4),   # many batches, ragged tail batch
])
def test_device_and_host_filters_agree_on_edge_shapes(E, chunk, n_test, tb):
    ds, jspec, tspec, jparams, tparams, jf, tf = _setup(E=E, R=3, seed=E + n_test,
                                                         n_test=n_test)
    kw = dict(test_batch_size=tb, eval_chunk_size=chunk)
    host = t_eval.split_ranks(tparams, tspec, ds.test, tf, device_filter=False, **kw)
    dev = t_eval.split_ranks(tparams, tspec, ds.test, tf, device_filter=True, **kw)
    assert host.shape == (2, n_test)
    np.testing.assert_array_equal(host, dev)
    want = j_eval.test_step(jparams, jspec, ds.test, jf, use_pallas=False,
                            device_filter=False, **kw)
    assert t_eval.test_step(tparams, tspec, ds.test, tf, device_filter=True, **kw) == want


def test_test_step_on_empty_split_and_bilinear_refusal():
    ds, jspec, tspec, jparams, tparams, jf, tf = _setup()
    assert t_eval.test_step(tparams, tspec, ds.test[:0], tf) == {}
    ds, jspec, tspec, jparams, tparams, jf, tf = _setup("DistMult")
    with pytest.raises(NotImplementedError, match="item 9"):
        t_eval.test_step(tparams, tspec, ds.test, tf, device_filter=False)


def test_eff_eval_batch_and_metrics_match_jax():
    for model in ("RotatE", "DistMult"):
        kw = dict(model_name=model, nentity=10, nrelation=2, hidden_dim=4, gamma=1.0,
                  double_entity_embedding=model == "RotatE")
        for tb in (4, 16, 200):
            assert t_eval.eff_eval_batch(TSpec(**kw), tb) == j_eval.eff_eval_batch(JSpec(**kw), tb)
    ranks = np.array([1, 2, 3, 4, 10, 11, 500])
    assert t_eval.metrics_from_ranks(ranks) == j_eval.metrics_from_ranks(ranks)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_params_from_numpy_round_trips(dtype):
    rng = np.random.default_rng(5)
    arrays = {"entity_embedding": rng.standard_normal((7, 6)).astype(dtype),
              "relation_embedding": rng.standard_normal((3, 6)).astype(dtype),
              "modulus": np.asarray(0.25, dtype)}
    params = t_kge.params_from_numpy(arrays, "cpu")
    for k, v in arrays.items():
        assert params[k].dtype == torch.from_numpy(v).dtype
        assert params[k].shape == v.shape
        np.testing.assert_array_equal(params[k].numpy(), v)
    arrays["entity_embedding"][0, 0] = 99.0  # the port holds its own copy
    assert params["entity_embedding"][0, 0] != 99.0
