"""The mesh device sampler and fused mesh blocks of the port
(knowledgegraphembedding_torch/sampler/device_sampler.py
``MeshDeviceSampler``, fused_train.py ``FusedMeshTrainer``) on a gloo world
of 2 ranks, eager on the CPU as on one device:

  - the draws are equal across runs, the ranks' rows together are the
    single-device sampler's global batch bit for bit (each rank folds its
    first element's global index into the Feistel counter), no negative is
    train-true, and one key's draws pass the chi-square of
    tests/test_torch_device_sampler.py;
  - a block of k equals k blocks of 1 and the per-step shardmap trainer fed
    its batches, bit for bit; it equals the JAX package's shard_map
    ShardedTrainer fed the same global batches on 2 of the 8 forced CPU
    devices, and the single-device FusedDeviceTrainer, within f32 rtol
    1e-5, atol 1e-6."""

import numpy as np
import pytest
import torch

from knowledgegraphembedding_torch.config import ModelSpec, TrainSpec
from knowledgegraphembedding_torch.fused_train import FusedDeviceTrainer
from knowledgegraphembedding_torch.models import kge as t_kge
from knowledgegraphembedding_torch.sampler.device_sampler import build_device_iterator

import torch_mesh

W = 2
RTOL, ATOL = 1e-5, 1e-6
E, R, B, N, SEED, STEPS, K = 41, 4, 16, 8, 5, 6, 4
MODES = ["head-batch", "tail-batch"]
TRUES = [0, 3, 4, 5, 20, 39]


def _graph(seed=0):
    rng = np.random.default_rng(seed)
    tr = np.stack([rng.integers(0, E, 400), rng.integers(0, R, 400), rng.integers(0, E, 400)], 1)
    return np.unique(tr, axis=0).astype(np.int32)


def _chi_trains():
    return {"tail-batch": np.array([[0, 0, t] for t in TRUES], np.int32),
            "head-batch": np.array([[h, 0, 0] for h in TRUES], np.int32)}


SKW = torch_mesh.spec_kw("RotatE", E, nrelation=R)
TKW = dict(negative_sample_size=N, batch_size=B, negative_adversarial_sampling=True)


@pytest.fixture(scope="module")
def world():
    train = _graph()
    p0 = torch_mesh.init_params(SKW)
    return train, p0, torch_mesh.world(
        torch_mesh.mesh_fused_worker, W, (train, E, R, B, N, SEED, STEPS), _chi_trains(),
        (SKW, TKW, p0, train, SEED, K))


def _global(rank_batches):
    """The global batch from the ranks' rows, in rank order."""
    pos = np.concatenate([b[0] for b in rank_batches])
    neg = np.concatenate([b[1] for b in rank_batches])
    w = np.concatenate([b[2] for b in rank_batches])
    return pos, neg, w, rank_batches[0][3]


def test_mesh_draws_are_equal_across_runs(world):
    for runs, _, _ in world[2]:
        for a, b in zip(*runs):
            for x, y in zip(a, b):
                assert np.array_equal(x, y)


def test_mesh_draws_are_the_single_device_global_batch(world):
    train = world[0]
    it = build_device_iterator(train, E, R, B, N, seed=SEED, depth=1)
    for step in range(STEPS):
        want = it.__next__()
        got = _global([rank[0][0][step] for rank in world[2]])
        assert got[3] == want[3] == ("tail-batch" if step % 2 == 0 else "head-batch")
        for x, y in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(x, y.numpy())


def test_mesh_draws_hold_no_train_true_negative(world):
    tr = set(map(tuple, world[0].tolist()))
    for rank in world[2]:
        for pos, neg, _, mode in rank[0][0]:
            for (h, r, t), row in zip(pos.tolist(), neg.tolist()):
                for x in row:
                    assert ((x, r, t) if mode == "head-batch" else (h, r, x)) not in tr


@pytest.mark.parametrize("mode", MODES)
def test_mesh_draws_uniform_over_allowed_chi_square(world, mode):
    """The ranks' draws for one key over its 34 allowed entities (64 rows x
    4,096 x 4 draws in all): no true entity, Pearson's statistic (33
    degrees of freedom) below 80."""
    counts = sum(rank[1][mode] for rank in world[2])
    assert counts.sum() == 64 * 4096 * 4
    assert counts[TRUES].sum() == 0
    allowed = np.delete(counts, TRUES)
    expected = counts.sum() / len(allowed)
    assert float(((allowed - expected) ** 2 / expected).sum()) < 80


@pytest.mark.parametrize("other", ["singles", "eager"])
def test_block_equals_singles_and_eager_bit_for_bit(world, other):
    for rank in world[2]:
        fused = rank[2]
        for a, b in zip(fused["block"][0], fused[other][0]):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=(other, k))
        if other == "singles":
            for x, y in zip(fused["block"][2], fused["singles"][2]):
                for u, v in zip(x[:3], y[:3]):
                    np.testing.assert_array_equal(u, v)
            for key, total in fused["block"][1].items():
                assert total == pytest.approx(sum(lg[key] for lg in fused["singles"][1]),
                                              rel=RTOL)


def _recorded_global(world):
    return [_global([rank[2]["block"][2][i] for rank in world[2]]) for i in range(K)]


def test_block_matches_jax_shardmap_fed_its_batches(world):
    _, p0, ranks = world
    steps = _recorded_global(world)
    want = torch_mesh.jax_train(SKW, TKW, p0, steps, "shardmap", W)
    got = ranks[0][2]["block"][0]
    for i in range(3):
        for k in want[i]:
            np.testing.assert_allclose(got[i][k], want[i][k], rtol=RTOL, atol=ATOL, err_msg=k)


def test_block_matches_single_device_fused_trainer(world):
    train, p0, ranks = world
    one = FusedDeviceTrainer(ModelSpec(**SKW), TrainSpec(**TKW), t_kge.params_from_numpy(p0, "cpu"),
                             lr=1e-2, warm_up_steps=10**9, train=train, seed=SEED,
                             record_batches=True, block_capacity=K)
    one.run_block(K)
    for (pos, neg, w, mode), want in zip(_recorded_global(world), one.recorded()):
        assert mode == want[3]
        for x, y in zip((pos, neg, w), want[:3]):
            np.testing.assert_array_equal(x, y.numpy())
    got = ranks[0][2]["block"][0][0]
    for k, v in one.params.items():
        np.testing.assert_allclose(got[k], v.detach().numpy(), rtol=RTOL, atol=ATOL, err_msg=k)
