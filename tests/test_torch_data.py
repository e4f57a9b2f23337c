"""The port's copies of the JAX-free data layer give the JAX package's
arrays: synthetic generators, TSV IO, CSR filter sets, the registry."""

import os

import numpy as np
import pytest

from knowledgegraphembedding_torch.data import filterset as t_fs
from knowledgegraphembedding_torch.data import registry as t_registry
from knowledgegraphembedding_torch.data import synthetic as t_syn
from knowledgegraphembedding_torch.data import vocab as t_vocab
from knowledgegraphembedding_tpu.data import filterset as j_fs
from knowledgegraphembedding_tpu.data import registry as j_registry
from knowledgegraphembedding_tpu.data import synthetic as j_syn
from knowledgegraphembedding_tpu.data import vocab as j_vocab

GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures", "golden_upstream")


def _assert_same_dataset(a, b):
    assert (a.nentity, a.nrelation, a.name) == (b.nentity, b.nrelation, b.name)
    for split in ("train", "valid", "test"):
        got, want = getattr(a, split), getattr(b, split)
        assert got.dtype == want.dtype, split
        np.testing.assert_array_equal(got, want, err_msg=split)
    assert a.regions == b.regions
    assert a.entity2id == b.entity2id and a.relation2id == b.relation2id


GENERATORS = [
    ("random", dict(nentity=60, nrelation=5, ntriples=500, n_valid=20, n_test=20)),
    ("clustered", dict(n_clusters=4, entities_per_cluster=6, nrelation=3)),
    ("countries_S1", {}),
    ("countries_S3", {}),
]


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("name,kw", GENERATORS, ids=[g[0] for g in GENERATORS])
def test_synthetic_generators_match(name, kw, seed):
    def make(mod):
        if name == "random":
            return mod.make_random_kg(seed=seed, **kw)
        if name == "clustered":
            return mod.make_clustered_kg(seed=seed, **kw)
        return mod.make_countries_like(seed=seed, level=name.split("_")[1])

    _assert_same_dataset(make(t_syn), make(j_syn))


def test_load_dataset_golden_fixture_matches():
    _assert_same_dataset(t_vocab.load_dataset(GOLDEN), j_vocab.load_dataset(GOLDEN))


def test_save_dataset_round_trips_through_jax_loader(tmp_path):
    ds = t_syn.make_clustered_kg(n_clusters=3, entities_per_cluster=5, nrelation=2,
                                 seed=4, n_valid=5, n_test=5)
    t_vocab.save_dataset(ds, str(tmp_path))
    back = j_vocab.load_dataset(str(tmp_path))
    for split in ("train", "valid", "test"):
        np.testing.assert_array_equal(getattr(back, split), getattr(ds, split))


def test_read_dict_rejects_gapped_ids(tmp_path):
    p = tmp_path / "entities.dict"
    p.write_text("0\ta\n2\tb\n")
    with pytest.raises(ValueError, match="ids must be exactly"):
        t_vocab.read_dict(str(p))


@pytest.mark.parametrize("key", ["clustered", "countries_S2"])
def test_registry_synthetic_matches(key):
    _assert_same_dataset(t_registry.load(f"synthetic:{key}"),
                         j_registry.load(f"synthetic:{key}"))


def test_registry_unknown_key_raises():
    with pytest.raises(ValueError, match="unknown synthetic dataset"):
        t_registry.load("synthetic:nope")


def _filters(mod, seed=2):
    ds = j_syn.make_random_kg(nentity=50, nrelation=4, ntriples=400, n_valid=30,
                              n_test=30, seed=seed)
    return ds, mod.FilterSets.build(ds.train, ds.all_true_triples, ds.nentity, ds.nrelation)


@pytest.mark.parametrize("which", ["all_true_head", "all_true_tail", "true_head", "true_tail"])
def test_dense_key_arrays_match(which):
    ds, tf = _filters(t_fs)
    _, jf = _filters(j_fs)
    n_keys = ds.nentity * ds.nrelation
    got = t_fs.dense_key_arrays(getattr(tf, which), n_keys, pad_value=0)
    want = j_fs.dense_key_arrays(getattr(jf, which), n_keys, pad_value=0)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]


@pytest.mark.parametrize("mode", ["head-batch", "tail-batch"])
def test_filter_mask_rows_match(mode):
    ds, tf = _filters(t_fs)
    _, jf = _filters(j_fs)
    pos = ds.test[:16]
    np.testing.assert_array_equal(tf.filter_mask_rows(pos, mode),
                                  jf.filter_mask_rows(pos, mode))
