"""The port's host sampler against the JAX package's: for one seed the
numpy and native backends give bit-identical batches in both packages, the
iterators keep the reference's order, and the subsampling weights are the
same arrays. The native cases skip only where g++ is missing."""

import shutil

import numpy as np
import pytest

from knowledgegraphembedding_torch import native as t_native
from knowledgegraphembedding_torch.data import filterset as t_filterset
from knowledgegraphembedding_torch.sampler import negative as t_neg
from knowledgegraphembedding_tpu.data import filterset as j_filterset
from knowledgegraphembedding_tpu.data.filterset import FilterSets
from knowledgegraphembedding_tpu.data.synthetic import make_random_kg
from knowledgegraphembedding_tpu.sampler import negative as j_neg

MODES = ["head-batch", "tail-batch"]


@pytest.fixture(scope="module")
def kg():
    ds = make_random_kg(nentity=60, nrelation=4, ntriples=500, n_valid=20, n_test=20, seed=1)
    filters = FilterSets.build(ds.train, ds.all_true_triples, ds.nentity, ds.nrelation)
    return ds, filters


def _backend(name):
    if name == "native" and shutil.which("g++") is None:
        pytest.skip("g++ is missing: the native sampler cannot be built")
    return name


def _assert_same_batches(got, want, n):
    for i in range(n):
        g, w = next(got), next(want)
        assert g[3] == w[3], i
        for a, b in zip(g[:3], w[:3]):
            assert a.dtype == b.dtype and a.shape == b.shape, i
            np.testing.assert_array_equal(a, b, err_msg=f"batch {i}")


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("mode", MODES)
def test_train_sampler_bit_identical(kg, mode, backend):
    ds, filters = kg
    backend = _backend(backend)
    # 9 batches of 64 cross an epoch boundary of the 500 train triples
    want = j_neg.TrainSampler(ds.train, ds.nentity, ds.nrelation, 64, 17, mode, filters,
                              seed=3, backend=backend)
    got = t_neg.TrainSampler(ds.train, ds.nentity, ds.nrelation, 64, 17, mode, seed=3,
                             backend=backend)
    assert got._native == (backend == "native")
    _assert_same_batches(iter(got.next_batch, None), iter(want.next_batch, None), 9)


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("depth", [0, 3], ids=["no-prefetch", "prefetch"])
def test_train_iterator_stream_identical(kg, depth, backend):
    ds, filters = kg
    backend = _backend(backend)
    want = j_neg.build_train_iterator(ds.train, ds.nentity, ds.nrelation, 32, 8, filters,
                                      seed=5, prefetch_depth=depth, backend=backend)
    got = t_neg.build_train_iterator(ds.train, ds.nentity, ds.nrelation, 32, 8, seed=5,
                                     prefetch_depth=depth, backend=backend)
    assert isinstance(got, t_neg.PrefetchIterator if depth else t_neg.BidirectionalIterator)
    try:
        _assert_same_batches(got, want, 12)
    finally:
        got.close()
        want.close()


def test_bidirectional_order_starts_with_tail_batch(kg):
    ds, _ = kg
    it = t_neg.build_train_iterator(ds.train, ds.nentity, ds.nrelation, 8, 4,
                                    prefetch_depth=0, backend="numpy")
    assert [next(it)[3] for _ in range(5)] == [
        "tail-batch", "head-batch", "tail-batch", "head-batch", "tail-batch"]


def test_prefetch_surfaces_sampler_errors():
    def broken():
        yield ("pos", "neg", "w", "tail-batch")
        raise ValueError("sampler failed")

    it = t_neg.PrefetchIterator(broken(), depth=2)
    try:
        assert next(it)[3] == "tail-batch"
        with pytest.raises(ValueError, match="sampler failed"):
            next(it)
    finally:
        it.close()
    assert not it._thread.is_alive()


def test_prefetch_upload_needs_a_cuda_device(kg):
    with pytest.raises(ValueError, match="CUDA"):
        t_neg.PrefetchIterator(iter(()), depth=1, device="cpu")


def test_device_backend_is_refused(kg):
    """Once refused, ``backend='device'`` now builds the device-resident
    iterator, as the JAX package's does: the same tail-first positives and
    weights from the same index streams (its draws are tested in
    tests/test_torch_device_sampler.py)."""
    from knowledgegraphembedding_torch.sampler.device_sampler import (
        DeviceBidirectionalIterator)

    ds, filters = kg
    got = t_neg.build_train_iterator(ds.train, ds.nentity, ds.nrelation, 8, 4, seed=2,
                                     backend="device")
    want = j_neg.build_train_iterator(ds.train, ds.nentity, ds.nrelation, 8, 4, filters,
                                      seed=2, backend="device")
    assert isinstance(got, DeviceBidirectionalIterator)
    for _ in range(4):
        g, w = next(got), next(want)
        assert g[3] == w[3]
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w[0]))
        np.testing.assert_array_equal(g[2].numpy(), np.asarray(w[2]))
        assert g[1].shape == (8, 4) and g[1].device.type == "cpu"


def test_subsampling_weights_and_counts_equal(kg):
    ds, _ = kg
    got = t_filterset.subsampling_weights(ds.train, ds.nrelation)
    want = j_filterset.subsampling_weights(ds.train, ds.nrelation)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert t_filterset.count_frequency(ds.train) == j_filterset.count_frequency(ds.train)
    # the vectorized weights are the reference's dict formula
    freq = t_filterset.count_frequency(ds.train)
    ref = [np.sqrt(1 / (freq[(h, r)] + freq[(t, -r - 1)])) for h, r, t in ds.train.tolist()]
    np.testing.assert_allclose(got, np.asarray(ref, np.float32), rtol=1e-7)


def test_native_negatives_avoid_the_true_set():
    _backend("native")
    assert t_native.available() and t_native.openmp_threads() >= 1
    assert t_native._lib_path().startswith(t_native.BUILD_DIR)
    rng = np.random.default_rng(0)
    nentity = 50
    keys = np.arange(8, dtype=np.int64)
    true_enc = np.unique(keys[:, None] * nentity + rng.integers(0, nentity, (8, 30)))
    neg, draws = t_native.sample_negatives(true_enc, keys, nentity, 40, seed=1)
    assert neg.shape == (8, 40) and neg.dtype == np.int32
    assert neg.min() >= 0 and neg.max() < nentity
    assert not np.isin(keys[:, None] * nentity + neg, true_enc).any()
