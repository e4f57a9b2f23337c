"""The hand-scheduled mesh step of the port (knowledgegraphembedding_torch/
parallel/shard_map_step.py: the table all-gathered, its gradient
reduce-scattered, the replicated leaves' gradients all-reduced, the loss
from all-reduced sums, ops/loss.kge_loss_global) on gloo worlds of 2 and 4
ranks, against the JAX package's shard_map ShardedTrainer on as many of the
8 forced CPU devices and against the port's single-device Trainer: after 3
steps from one init on the same batches, params, Adam moments and logs
within f32 rtol 1e-5, atol 1e-6. bf16 score math rounds the per-rank sums
differently from the single-device layout, so its case is held to the JAX
package's own bf16 mesh bound (rtol 5e-2, atol 2e-3, tests/test_shard_map.py).

The moments pin the gradient bookkeeping: a gradient summed over the group
once too often would scale m by the group size, which Adam's normalized
update hides from the params but not from m. The collectives' own
gradients are checked in a world as well."""

import numpy as np
import pytest

import torch_mesh

B, N = 8, 4

# name: (model, E, tspec kwargs, W, shared negatives, (rtol, atol))
F32 = (1e-5, 1e-6)
CASES = {
    "rotate-adv-w2": ("RotatE", 37, dict(negative_adversarial_sampling=True,
                                         adversarial_temperature=0.7), 2, False, F32),
    "transe-uni-w4": ("TransE", 41, dict(uni_weight=True), 4, False, F32),
    "distmult-dense-reg-w4": ("DistMult", 41, dict(scoring="dense", regularization=1e-4), 4,
                              False, F32),
    "complex-gather-reg-w2": ("ComplEx", 37, dict(scoring="gather", regularization=5e-5,
                                                  negative_adversarial_sampling=True), 2, False,
                              F32),
    "protate-modulus-w4": ("pRotatE", 41, dict(negative_adversarial_sampling=True), 4, False,
                           F32),
    "rotate-shared-w2": ("RotatE", 37, dict(negative_adversarial_sampling=True), 2, True, F32),
    "rotate-bf16-w2": ("RotatE", 37, dict(negative_adversarial_sampling=True, precision="bf16"),
                       2, False, (5e-2, 2e-3)),
}


def _inputs(name):
    model, E, tkw, W, shared, _ = CASES[name]
    skw = torch_mesh.spec_kw(model, E)
    tkw = dict(tkw, negative_sample_size=N, batch_size=B)
    return skw, tkw, torch_mesh.init_params(skw), torch_mesh.batches(E, 5, B, N, 3, shared), W, \
        shared


@pytest.fixture(scope="module")
def runs():
    """{case: (port mesh, JAX mesh, port single device)}, each (params, m,
    v, logs); one gloo world per rank count."""
    out = {}
    for ranks in (2, 4):
        names = [n for n in CASES if CASES[n][3] == ranks]
        cases = []
        for n in names:
            skw, tkw, p0, steps, W, shared = _inputs(n)
            cases.append((skw, tkw, p0, steps, "shardmap", 1, shared))
        got = torch_mesh.world(torch_mesh.train_worker, ranks, cases)[0]
        for n, port in zip(names, got):
            skw, tkw, p0, steps, W, shared = _inputs(n)
            out[n] = (port, torch_mesh.jax_train(skw, tkw, p0, steps, "shardmap", W, 1, shared),
                      torch_mesh.single_train(skw, tkw, p0, steps))
    return out


def _close(got, want, tol, what):
    rtol, atol = tol
    for k in want:
        assert got[k].shape == want[k].shape, (what, k)
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=f"{what}/{k}")


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("against", ["jax", "single"])
def test_shardmap_state_matches(runs, name, against):
    port, other = runs[name][0], runs[name][1 if against == "jax" else 2]
    tol = CASES[name][5]
    for i, what in enumerate(("params", "adam_m", "adam_v")):
        _close(port[i], other[i], tol, what)


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("against", ["jax", "single"])
def test_shardmap_logs_match(runs, name, against):
    port, other = runs[name][0], runs[name][1 if against == "jax" else 2]
    rtol, atol = CASES[name][5]
    for got, want in zip(port[3], other[3]):
        assert set(got) == set(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=max(rtol, 1e-5), abs=atol), k


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][5] == F32])
def test_gradients_are_not_scaled_by_the_group_size(runs, name):
    """m after 3 steps is a sum of (1 - b1) g terms: equal to the
    single-device moments, not W times them."""
    port, _, single = runs[name]
    W = CASES[name][3]
    for k in single[1]:
        scale = np.abs(port[1][k]).sum() / max(np.abs(single[1][k]).sum(), 1e-30)
        assert scale == pytest.approx(1.0, rel=1e-4), (k, scale, W)


@pytest.fixture(scope="module")
def collectives():
    return {W: torch_mesh.world(torch_mesh.collectives_worker, W) for W in (2,)}


def test_all_reduce_sum_backward_is_the_identity(collectives):
    for rank, (x_grad, _, _) in enumerate(collectives[2]):
        assert x_grad == 2.0 * (rank + 1)  # d(x^2)/dx on this rank, not summed again


def test_all_gather_rows_backward_sums_the_ranks(collectives):
    W = 2
    for rank, (_, rows_grad, shape) in enumerate(collectives[W]):
        assert shape == (2 * W, 3)
        np.testing.assert_array_equal(rows_grad, np.full((2, 3), W * (W + 1) / 2))
