"""The gspmd schedule of the port (knowledgegraphembedding_torch/parallel/
sharding.py: DTensor over a DeviceMesh, one gloo rank per device) against
the JAX package's ShardedTrainer on the same number of the 8 forced CPU
devices: after 3 steps from one init on the same batches, params, Adam
moments and the logs agree within f32 rtol 1e-5, atol 1e-6 on 1-D meshes of
2 and 4 ranks and on the 2 x 2 (data, model) mesh, padding rows stay zero;
and pad_params, the straddle guard and the model-sharding check equal
JAX's. E is 37 or 41, so neither 2 nor 4 divides it and padding is on."""

import numpy as np
import pytest
import torch

from knowledgegraphembedding_torch.config import ModelSpec as TSpec
from knowledgegraphembedding_torch.parallel import sharding as t_sharding
from knowledgegraphembedding_tpu.config import ModelSpec as JSpec
from knowledgegraphembedding_tpu.parallel import sharding as j_sharding

import torch_mesh

RTOL, ATOL = 1e-5, 1e-6
B, N = 8, 4

# name: (model, E, tspec kwargs, W data ranks, model shards, shared negatives)
CASES = {
    "rotate-adv-w2": ("RotatE", 37, dict(negative_adversarial_sampling=True), 2, 1, False),
    "protate-reg-w4": ("pRotatE", 41, dict(regularization=1e-3), 4, 1, False),
    "distmult-dense-reg-w2": ("DistMult", 37, dict(scoring="dense", regularization=1e-3), 2, 1,
                              False),
    "rotate-shared-w4": ("RotatE", 41, dict(negative_adversarial_sampling=True), 4, 1, True),
    "complex-2x2": ("ComplEx", 37, dict(negative_adversarial_sampling=True), 2, 2, False),
    "transe-uni-2x2": ("TransE", 41, dict(uni_weight=True, regularization=1e-3), 2, 2, False),
}


def _inputs(name):
    model, E, tkw, W, M, shared = CASES[name]
    skw = torch_mesh.spec_kw(model, E)
    tkw = dict(tkw, negative_sample_size=N, batch_size=B)
    steps = torch_mesh.batches(E, 5, B, N, 3, shared=shared)
    return skw, tkw, torch_mesh.init_params(skw), steps, W, M, shared


@pytest.fixture(scope="module")
def runs():
    """{case: (port (params, m, v, logs, padded rows), JAX (params, m, v,
    logs))}: one gloo world per rank count."""
    out = {}
    for ranks in (2, 4):
        names = [n for n in CASES if CASES[n][3] * CASES[n][4] == ranks]
        cases = []
        for n in names:
            skw, tkw, p0, steps, W, M, shared = _inputs(n)
            cases.append((skw, tkw, p0, steps, "gspmd", M, shared))
        got = torch_mesh.world(torch_mesh.train_worker, ranks, cases)
        for r in range(1, ranks):  # every rank gathered the same state
            for a, b in zip(got[0], got[r]):
                for k in a[0]:
                    np.testing.assert_array_equal(a[0][k], b[0][k])
        for n, port in zip(names, got[0]):
            skw, tkw, p0, steps, W, M, shared = _inputs(n)
            out[n] = (port, torch_mesh.jax_train(skw, tkw, p0, steps, "gspmd", W, M, shared))
    return out


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("what", ["params", "adam_m", "adam_v"])
def test_gspmd_state_matches_jax(runs, name, what):
    port, jax_ = runs[name]
    i = ("params", "adam_m", "adam_v").index(what)
    for k in jax_[i]:
        assert port[i][k].shape == jax_[i][k].shape, k  # padding stripped
        np.testing.assert_allclose(port[i][k], jax_[i][k], rtol=RTOL, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("name", CASES)
def test_gspmd_logs_match_jax(runs, name):
    port, jax_ = runs[name]
    for got, want in zip(port[3], jax_[3]):
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=RTOL, abs=ATOL), k


@pytest.mark.parametrize("name", CASES)
def test_padded_rows(runs, name):
    """The padded table spans a multiple of the data ranks."""
    port, _ = runs[name]
    E, W = CASES[name][1], CASES[name][3]
    assert port[4] == -(-E // W) * W > E


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_pad_params_matches_jax(n_shards):
    p = torch_mesh.init_params(torch_mesh.spec_kw("RotatE", 37))
    want = j_sharding.pad_params(p, n_shards)
    as_tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in p.items()}
    for got in (t_sharding.pad_params(p, n_shards),
                {k: v.numpy() for k, v in t_sharding.pad_params(as_tensors, n_shards).items()}):
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("rows", [[[0, 0], [1, 1]], [[0, 1], [1, 1]], [[3, 3, 3]]])
def test_straddle_guard_matches_jax(rows):
    def outcome(fn):
        try:
            fn(rows)
        except ValueError as e:
            return str(e)
        return None

    assert outcome(t_sharding.check_rows_single_process) == outcome(
        j_sharding.check_rows_single_process)


def test_model_sharding_check_matches_jax():
    """--model_shards must divide both widths; the same message."""
    kw = torch_mesh.spec_kw("ComplEx", 37, hidden_dim=5)  # widths 10, 10: 4 divides neither

    class _Mesh:  # the two packages read the model axis size only
        shape = {"data": 1, "model": 4}
        axis_names = ("data", "model")
        mesh_dim_names = ("data", "model")

        def size(self, i):
            return (1, 4)[i]

    with pytest.raises(ValueError) as jax_err:
        j_sharding.validate_model_sharding(JSpec(**kw), _Mesh())
    with pytest.raises(ValueError) as port_err:
        t_sharding.validate_model_sharding(TSpec(**kw), _Mesh())
    assert str(port_err.value) == str(jax_err.value)
