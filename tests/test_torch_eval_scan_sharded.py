"""The port's sharded scan (``parallel/eval_sharded.sharded_split_ranks``
with the device-resident filter: a mode's batches in chunks of up to
``_SCAN_CHUNK``, each chunk one call of the rows' gather, its batches and
the counts' all-reduce; eager on gloo, replayed from CUDA graphs on NCCL)
on a gloo world of 2 ranks, against the JAX package's ``sharded_test_step``
(``get_sharded_scan_fn``) on a 2-device CPU mesh, for all five models and
split sizes of nb in {1, 31, 32, 33, 65} batches: the metrics are equal
exactly, and the ranks equal the port's single-device scan's. E is 37, so
the second rank's block holds a padding row, which must never count."""

import functools

import numpy as np
import pytest

import jax.numpy as jnp

from knowledgegraphembedding_torch import eval as t_eval
from knowledgegraphembedding_torch.config import ModelSpec as TSpec
from knowledgegraphembedding_torch.data.filterset import FilterSets as TFilterSets
from knowledgegraphembedding_torch.models import kge as t_kge
from knowledgegraphembedding_tpu.config import ModelSpec as JSpec
from knowledgegraphembedding_tpu.data.filterset import FilterSets as JFilterSets
from knowledgegraphembedding_tpu.data.synthetic import make_random_kg
from knowledgegraphembedding_tpu.eval import metrics_from_ranks
from knowledgegraphembedding_tpu.parallel import eval_sharded as j_eval_sharded
from knowledgegraphembedding_tpu.parallel import sharding as j_sharding

import torch_mesh

MODELS = ["RotatE", "TransE", "pRotatE", "DistMult", "ComplEx"]
NBS = [1, 31, 32, 33, 65]
W, E, R, TEST_BATCH = 2, 37, 4, 8


@functools.lru_cache(maxsize=None)
def _data(eff: int):
    """Train and all-true triples, and ``max(NBS) * eff - 3`` test triples
    from a seed; the split of nb batches is their first ``nb * eff - 3``."""
    ds = make_random_kg(nentity=E, nrelation=R, ntriples=300, n_valid=5, n_test=5, seed=eff)
    rng = np.random.default_rng(eff + 1)
    n = max(NBS) * eff - 3
    test = np.stack([rng.integers(0, E, n), rng.integers(0, R, n),
                     rng.integers(0, E, n)], 1).astype(np.int64)
    return ds.train, test, np.concatenate([ds.all_true_triples, test])


def _case(model, nb):
    skw = torch_mesh.spec_kw(model, E, nrelation=R, hidden_dim=8)
    eff = t_eval.eff_eval_batch(TSpec(**skw), TEST_BATCH)
    train, test, all_true = _data(eff)
    return skw, torch_mesh.init_params(skw, seed=len(model)), test[:nb * eff - 3], train, all_true


KEYS = [(m, nb) for m in MODELS for nb in NBS]


@pytest.fixture(scope="module")
def runs():
    """{(model, nb): (port sharded ranks, port single-device ranks, JAX
    sharded metrics)}."""
    cases = [_case(*k) for k in KEYS]
    got = torch_mesh.world(torch_mesh.eval_worker, W, [
        (skw, p0, test, train, all_true, 1, True, TEST_BATCH)
        for skw, p0, test, train, all_true in cases])
    for a, b in zip(got[0], got[1]):
        np.testing.assert_array_equal(a, b)  # both ranks hold the global ranks
    jmesh = j_sharding.build_mesh(W)
    out = {}
    for key, (skw, p0, test, train, all_true), sharded in zip(KEYS, cases, got[0]):
        single = t_eval.split_ranks(t_kge.params_from_numpy(p0, "cpu"), TSpec(**skw), test,
                                    TFilterSets.build(train, all_true, E, R),
                                    test_batch_size=TEST_BATCH, device_filter=True)
        jspec = JSpec(**skw)
        jp = j_sharding.shard_params(
            j_sharding.pad_params({k: jnp.asarray(v) for k, v in p0.items()}, W), jspec, jmesh)
        want = j_eval_sharded.sharded_test_step(
            jp, jspec, test, JFilterSets.build(train, all_true, E, R), jmesh,
            test_batch_size=TEST_BATCH)
        out[key] = (sharded, single, want)
    return out


@pytest.mark.parametrize("key", KEYS, ids=[f"{m}-nb{nb}" for m, nb in KEYS])
def test_sharded_scan_matches_jax_and_one_device(runs, key):
    sharded, single, jax_metrics = runs[key]
    assert sharded.shape == single.shape
    np.testing.assert_array_equal(sharded, single)
    logs = [lg for ranks in sharded for lg in metrics_from_ranks(ranks)]
    assert {k: float(np.mean([lg[k] for lg in logs])) for k in logs[0]} == jax_metrics
