"""The frozen operation and byte counts against arithmetic by hand."""

import pytest

from kge_bench.counts import ops
from kge_bench.harness import spec


@pytest.fixture(scope="module")
def bench(root):
    return spec.load_benchmark(root)


def _cfg(root, bench, name):
    cfg = spec.load_config(root, bench, name)
    return cfg, spec.model_counts(root, cfg["model"]), spec.peaks(root)


def test_rotate_train_step(root, bench):
    cfg, counts, _ = _cfg(root, bench, "rotate_fb15k237")
    # 3 (B (n + 1) d 7 + B d 8) + 14 (E 2d + R d)
    forward = 1024 * 257 * 1000 * 7 + 1024 * 1000 * 8
    assert forward == 1_850_368_000
    params = 14541 * 2000 + 237 * 1000
    assert ops.n_params(cfg) == params == 29_319_000
    assert ops.train_step_ops(cfg, counts) == 3 * forward + 14 * params == 5_961_570_000


def test_distmult_train_step_counts_the_l3_term(root, bench):
    cfg, counts, _ = _cfg(root, bench, "distmult_fb15k237")
    forward = 1024 * 257 * 2000 * 2 + 1024 * 2000
    params = (14541 + 237) * 2000
    assert ops.train_step_ops(cfg, counts) == 3 * forward + (14 + 8) * params == 3_814_392_000


def test_ranking_ops(root, bench):
    cfg, counts, _ = _cfg(root, bench, "rotate_fb15k237")
    assert ops.ranking_ops(cfg, counts, 1) == 14541 * 1000 * 7 + 1000 * 8 == 101_795_000
    cfg, counts, _ = _cfg(root, bench, "distmult_fb15k237")
    assert ops.ranking_ops(cfg, counts, 40932) == 40932 * (14541 * 2000 * 2 + 2000)


def test_rank_kernel_launch_is_bound_by_bytes(root, bench):
    cfg, counts, peaks = _cfg(root, bench, "rotate_fb15k237")
    nbytes = ops.rank_kernel_bytes(cfg, 16, 40)
    assert nbytes == 14541 * 2000 * 4 + 16 * 2000 * 4 + 40 * 4 + 16 * 4 == 116_456_224
    flops = ops.rank_kernel_ops(cfg, counts, 16)
    assert flops == 16 * 14541 * 1000 * 7
    least = ops.least_s(flops, nbytes, peaks)
    assert least == pytest.approx(116_456_224 / 3.35e12)
    assert least > flops / 67e12
