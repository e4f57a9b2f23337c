"""The row-routing mesh step of the port (knowledgegraphembedding_torch/
parallel/routed_step.py: ids and rows exchanged by all_to_all_single, the
gradient rows routed back by the reverse exchange) on gloo worlds, against
the JAX package: ``_capacity`` equal; ``fetch_rows`` returns table[ids]
exactly, as JAX's does, for ids of every shard in any order with
duplicates; 3 routed steps equal JAX's routed ShardedTrainer and the
port's single-device Trainer within f32 rtol 1e-5, atol 1e-6, the overflow
flag 0; dense scoring is refused with JAX's message; and a forced overflow
(every bucket's capacity cut to 4 rows) makes the CLI raise JAX's message
at the poll, before a periodic save and before the final save, with no
checkpoint written."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from knowledgegraphembedding_torch import cli as t_cli
from knowledgegraphembedding_torch.config import ModelSpec as TSpec
from knowledgegraphembedding_torch.config import TrainSpec as TTrainSpec
from knowledgegraphembedding_torch.parallel import routed_step as t_routed
from knowledgegraphembedding_torch.parallel import sharding as t_sharding
from knowledgegraphembedding_tpu.config import ModelSpec as JSpec
from knowledgegraphembedding_tpu.config import TrainSpec as JTrainSpec
from knowledgegraphembedding_tpu.parallel import routed_step as j_routed
from knowledgegraphembedding_tpu.parallel import sharding as j_sharding

import torch_mesh

RTOL, ATOL = 1e-5, 1e-6
B, N = 8, 4
CASES = {
    "rotate-adv-w2": ("RotatE", 37, dict(negative_adversarial_sampling=True,
                                         adversarial_temperature=0.7), 2, False),
    "transe-uni-reg-w4": ("TransE", 41, dict(uni_weight=True, regularization=1e-4), 4, False),
    "protate-shared-w2": ("pRotatE", 37, dict(negative_adversarial_sampling=True), 2, True),
}


@pytest.mark.parametrize("n_uniform,n_shards,n_skewed",
                         [(200, 2, 0), (32, 4, 16), (262144, 8, 2048), (1, 1, 0)])
def test_capacity_matches_jax(n_uniform, n_shards, n_skewed):
    assert t_routed._capacity(n_uniform, n_shards, n_skewed) == j_routed._capacity(
        n_uniform, n_shards, n_skewed)


def _jax_fetch(table, ids, W):
    mesh = j_sharding.build_mesh(W)
    P = jax.sharding.PartitionSpec

    def body(table_local, ids):
        return j_routed.fetch_rows(table_local, ids, n_shards=W,
                                   capacity=j_routed._capacity(len(ids), W))[0]

    return np.asarray(jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P("data", None), P()), out_specs=P(), check_vma=False,
    ))(jnp.asarray(table), jnp.asarray(ids)))


@pytest.mark.parametrize("W", [2, 4])
def test_fetch_rows_routes_exactly(W):
    E, d = 16 * W, 8
    table = np.arange(E * d, dtype=np.float32).reshape(E, d)
    ids = np.random.default_rng(W).integers(0, E, 200).astype(np.int32)
    want = _jax_fetch(table, ids, W)
    np.testing.assert_array_equal(want, table[ids])
    for rows, fill in torch_mesh.world(torch_mesh.fetch_rows_worker, W, table, ids):
        np.testing.assert_array_equal(rows, want)
        assert fill <= t_routed._capacity(len(ids), W)


@pytest.fixture(scope="module")
def runs():
    out = {}
    for ranks in (2, 4):
        names = [n for n in CASES if CASES[n][3] == ranks]
        cases = []
        for n in names:
            model, E, tkw, W, shared = CASES[n]
            skw = torch_mesh.spec_kw(model, E)
            tkw = dict(tkw, negative_sample_size=N, batch_size=B)
            cases.append((skw, tkw, torch_mesh.init_params(skw),
                          torch_mesh.batches(E, 5, B, N, 3, shared), "routed", 1, shared))
        got = torch_mesh.world(torch_mesh.train_worker, ranks, cases)[0]
        for n, (skw, tkw, p0, steps, _, _, shared), port in zip(names, cases, got):
            out[n] = (port, torch_mesh.jax_train(skw, tkw, p0, steps, "routed", ranks, 1, shared),
                      torch_mesh.single_train(skw, tkw, p0, steps))
    return out


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("against", ["jax", "single"])
def test_routed_state_matches(runs, name, against):
    port, other = runs[name][0], runs[name][1 if against == "jax" else 2]
    for i, what in enumerate(("params", "adam_m", "adam_v")):
        for k in other[i]:
            np.testing.assert_allclose(port[i][k], other[i][k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what}/{k}")


@pytest.mark.parametrize("name", CASES)
def test_routed_logs_match_jax(runs, name):
    port, jax_, single = runs[name]
    for got, want, one in zip(port[3], jax_[3], single[3]):
        assert got.pop("routed_overflow") == want.pop("routed_overflow") == 0
        assert set(got) == set(want) == set(one)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=RTOL, abs=ATOL), k
            assert got[k] == pytest.approx(one[k], rel=RTOL, abs=ATOL), k


def test_routed_refuses_dense_scoring():
    kw = torch_mesh.spec_kw("DistMult", 37)
    with pytest.raises(ValueError) as want:
        j_routed.make_routed_train_step(JSpec(**kw), JTrainSpec(scoring="dense"),
                                        j_sharding.build_mesh(2), "tail-batch")

    class _Mesh:
        mesh_dim_names = ("data",)

    with pytest.raises(ValueError) as got:
        t_sharding.ShardedTrainer(TSpec(**kw), TTrainSpec(scoring="dense"), {}, lr=1e-2,
                                  warm_up_steps=1, mesh=_Mesh(), spmd_mode="routed")
    assert str(got.value) == str(want.value)


@pytest.fixture(scope="module")
def overflow(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("overflow"))
    return torch_mesh.world(torch_mesh.overflow_worker, 2, root)


@pytest.mark.parametrize("run,message", [("poll", t_cli._OVERFLOW),
                                         ("save", t_cli._OVERFLOW_SAVE),
                                         ("final", t_cli._OVERFLOW_SAVE)])
def test_forced_overflow_raises_before_any_checkpoint(overflow, run, message):
    for rank_out in overflow:
        err, files = rank_out[run]
        assert err == message
        assert not [f for f in files if f.startswith("checkpoint") or f.endswith(".npy")], files


def test_overflow_messages_are_the_jax_clis():
    import ast
    import inspect

    from knowledgegraphembedding_tpu import cli as j_cli

    strings = {n.value for n in ast.walk(ast.parse(inspect.getsource(j_cli)))
               if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    assert {t_cli._OVERFLOW, t_cli._OVERFLOW_SAVE} <= strings
