"""The sharded evaluation of the port (knowledgegraphembedding_torch/parallel/
eval_sharded.py: each rank counts the beats among its own row block, one
all_reduce of the int32 counts) on gloo worlds of 2 and 4 ranks and on the
2 x 2 (data, model) mesh, for all five models: the ranks equal the port's
single-device ``eval.split_ranks`` exactly, with the device-resident filter
and with host masks, and the metrics equal the JAX package's
``sharded_test_step`` on as many of the 8 forced CPU devices exactly. E is
37 or 41, so neither 2 nor 4 divides it: the last block holds padding rows,
which must never count. On the CPU the distance family counts through
``rank_kernel.rank_counts``'s plain version, over the block and the mask's
column window."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from knowledgegraphembedding_torch import eval as t_eval
from knowledgegraphembedding_torch.config import ModelSpec as TSpec
from knowledgegraphembedding_torch.data.filterset import FilterSets as TFilterSets
from knowledgegraphembedding_torch.data.synthetic import make_random_kg
from knowledgegraphembedding_torch.models import kge as t_kge
from knowledgegraphembedding_tpu.config import ModelSpec as JSpec
from knowledgegraphembedding_tpu.data.filterset import FilterSets as JFilterSets
from knowledgegraphembedding_tpu.eval import metrics_from_ranks
from knowledgegraphembedding_tpu.parallel import eval_sharded as j_eval_sharded
from knowledgegraphembedding_tpu.parallel import sharding as j_sharding

import torch_mesh

MODELS = ["RotatE", "TransE", "pRotatE", "DistMult", "ComplEx"]
# (W data ranks, model shards, E)
MESHES = {"w2": (2, 1, 37), "w4": (4, 1, 41), "2x2": (2, 2, 37)}
TEST_BATCH = 8


def _data(E):
    ds = make_random_kg(nentity=E, nrelation=4, ntriples=300, n_valid=10, n_test=24, seed=E)
    return ds


def _cases(mesh_name):
    W, M, E = MESHES[mesh_name]
    ds = _data(E)
    out = []
    for model in MODELS:
        skw = torch_mesh.spec_kw(model, ds.nentity, nrelation=ds.nrelation, hidden_dim=8)
        p0 = torch_mesh.init_params(skw, seed=len(model))
        for device_filter in (True, False):
            out.append(((model, device_filter),
                        (skw, p0, ds.test, ds.train, ds.all_true_triples, M, device_filter,
                         TEST_BATCH)))
    return ds, out


@pytest.fixture(scope="module")
def runs():
    """{(mesh, model, device_filter): (port sharded ranks, port single-device
    ranks, JAX sharded metrics)}."""
    out = {}
    for ranks, names in ((2, ["w2"]), (4, ["w4", "2x2"])):
        cases = {n: _cases(n) for n in names}
        flat = [c for n in names for _, c in cases[n][1]]
        got = torch_mesh.world(torch_mesh.eval_worker, ranks, flat)
        for r in range(1, ranks):
            for a, b in zip(got[0], got[r]):
                np.testing.assert_array_equal(a, b)  # every rank has the global ranks
        i = 0
        for n in names:
            W, M, E = MESHES[n]
            ds, cs = cases[n]
            jmesh = j_sharding.build_mesh(W, model_shards=M)
            for (model, device_filter), (skw, p0, *_rest) in cs:
                spec = TSpec(**skw)
                tfilters = TFilterSets.build(ds.train, ds.all_true_triples, ds.nentity,
                                             ds.nrelation)
                single = t_eval.split_ranks(t_kge.params_from_numpy(p0, "cpu"), spec, ds.test,
                                            tfilters, test_batch_size=TEST_BATCH,
                                            eval_chunk_size=16)
                jax_metrics = None
                if device_filter:  # the JAX run once per model and mesh
                    jspec = JSpec(**skw)
                    jp = j_sharding.shard_params(
                        j_sharding.pad_params({k: jnp.asarray(v) for k, v in p0.items()}, W),
                        jspec, jmesh)
                    jfilters = JFilterSets.build(ds.train, ds.all_true_triples, ds.nentity,
                                                 ds.nrelation)
                    jax_metrics = j_eval_sharded.sharded_test_step(
                        jp, jspec, ds.test, jfilters, jmesh, test_batch_size=TEST_BATCH)
                out[(n, model, device_filter)] = (got[0][i], single, jax_metrics)
                i += 1
    return out


KEYS = [(n, m, f) for n in MESHES for m in MODELS for f in (True, False)]


@pytest.mark.parametrize("key", KEYS, ids=[f"{n}-{m}-{'device' if f else 'host'}"
                                           for n, m, f in KEYS])
def test_sharded_ranks_equal_single_device(runs, key):
    sharded, single, _ = runs[key]
    assert sharded.shape == single.shape == (2, 24)
    np.testing.assert_array_equal(sharded, single)


@pytest.mark.parametrize("key", [k for k in KEYS if k[2]],
                         ids=[f"{n}-{m}" for n, m, f in KEYS if f])
def test_sharded_metrics_equal_jax(runs, key):
    sharded, _, jax_metrics = runs[key]
    logs = [lg for ranks in sharded for lg in metrics_from_ranks(ranks)]
    port = {k: float(np.mean([lg[k] for lg in logs])) for k in logs[0]}
    assert port == jax_metrics
