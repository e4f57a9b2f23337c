"""``--negative_sharing batch`` in the port: one uniform, unfiltered
``[1, n]`` negative row a batch, broadcast against the ``[B, ...]``
positives, against the JAX package on the same numpy inputs.

Tolerances: the host sampler's batches equal JAX's bit for bit; broadcast
scores equal tiled ones exactly (the same elementwise values summed in the
same order); loss and gradients against JAX at f32 rtol 1e-5 / atol 1e-7
and f64 rtol 1e-12 / atol 1e-15 (tests/test_torch_train.py's step
tolerances); the backward recompute against none bit for bit (the same ops
run again on the same inputs). The device draw is the port's own generator
(JAX's threefry bits are not reproducible in torch), held to its contract:
in range, a function of the draw index, uniform by a chi-square."""

import contextlib
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from knowledgegraphembedding_torch import eval as t_eval
from knowledgegraphembedding_torch import train as t_train
from knowledgegraphembedding_torch.config import ModelSpec as TSpec
from knowledgegraphembedding_torch.config import TrainSpec as TTrainSpec
from knowledgegraphembedding_torch.data.filterset import FilterSets as TFilterSets
from knowledgegraphembedding_torch.models import kge as t_kge
from knowledgegraphembedding_torch.ops import matmul_scoring as t_ms
from knowledgegraphembedding_torch.sampler import build_train_iterator as t_iterator
from knowledgegraphembedding_torch.sampler import device_sampler as t_ds
from knowledgegraphembedding_torch.sampler.negative import TrainSampler as TSampler
from knowledgegraphembedding_tpu import train as j_train
from knowledgegraphembedding_tpu.config import ModelSpec as JSpec
from knowledgegraphembedding_tpu.config import TrainSpec as JTrainSpec
from knowledgegraphembedding_tpu.data.filterset import FilterSets as JFilterSets
from knowledgegraphembedding_tpu.data.synthetic import make_clustered_kg
from knowledgegraphembedding_tpu.sampler import build_train_iterator as j_iterator
from knowledgegraphembedding_tpu.sampler.negative import TrainSampler as JSampler

MODELS = [("TransE", False, False), ("DistMult", False, False), ("ComplEx", True, True),
          ("RotatE", True, False), ("pRotatE", False, False)]
IDS = [m[0] for m in MODELS]
MODES = ["head-batch", "tail-batch"]
TOL = {np.float32: dict(rtol=1e-5, atol=1e-7), np.float64: dict(rtol=1e-12, atol=1e-15)}


@contextlib.contextmanager
def jax_precision(dtype):
    jax.config.update("jax_enable_x64", dtype == np.float64)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def kg():
    return make_clustered_kg(n_clusters=4, entities_per_cluster=6, nrelation=2, seed=0)


def _setup(model, de, dr, E=60, R=5, dim=8, B=16, n=12, seed=0, dtype=np.float32):
    kw = dict(model_name=model, nentity=E, nrelation=R, hidden_dim=dim, gamma=6.0,
              double_entity_embedding=de, double_relation_embedding=dr)
    jspec, tspec = JSpec(**kw), TSpec(**kw)
    rng = np.random.default_rng(seed)
    r = jspec.embedding_range
    p = {"entity_embedding": rng.uniform(-r, r, (E, jspec.entity_dim)),
         "relation_embedding": rng.uniform(-r, r, (R, jspec.relation_dim))}
    if jspec.has_modulus:
        p["modulus"] = np.asarray(0.5 * r)
    pos = np.stack([rng.integers(0, E, B), rng.integers(0, R, B), rng.integers(0, E, B)],
                   1).astype(np.int32)
    neg = rng.integers(0, E, (1, n)).astype(np.int32)
    w = rng.uniform(0.1, 1, B)
    return (jspec, tspec, {k: np.asarray(v, dtype) for k, v in p.items()}, pos, neg,
            w.astype(dtype))


def _t(p):
    return t_kge.params_from_numpy(p, "cpu")


@pytest.mark.parametrize("mode", MODES)
def test_host_sampler_equals_jax(kg, mode):
    """One seed, both packages' numpy samplers: the same positives, shared
    [1, n] rows and weights, batch for batch across epochs."""
    filters = JFilterSets.build(kg.train, kg.all_true_triples, kg.nentity, kg.nrelation)
    want = JSampler(kg.train, kg.nentity, kg.nrelation, 16, 8, mode, filters, seed=5,
                    backend="numpy", negative_sharing="batch")
    got = TSampler(kg.train, kg.nentity, kg.nrelation, 16, 8, mode, seed=5, backend="numpy",
                   negative_sharing="batch")
    for _ in range(3 * len(kg.train) // 16):
        g, w = got.next_batch(), want.next_batch()
        assert g[1].shape == (1, 8) and g[3] == w[3] == mode
        for a, b in zip(g[:3], w[:3]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_iterator_equals_jax(kg):
    """build_train_iterator with negative_sharing, both packages: the same
    tail-first stream (head seed, tail seed + 1)."""
    filters = JFilterSets.build(kg.train, kg.all_true_triples, kg.nentity, kg.nrelation)
    want = j_iterator(kg.train, kg.nentity, kg.nrelation, 16, 8, filters, seed=2,
                      prefetch_depth=0, backend="numpy", negative_sharing="batch")
    got = t_iterator(kg.train, kg.nentity, kg.nrelation, 16, 8, seed=2, prefetch_depth=3,
                     backend="numpy", negative_sharing="batch")
    try:
        for _ in range(20):
            g, w = next(got), next(want)
            assert g[3] == w[3]
            for a, b in zip(g[:3], w[:3]):
                np.testing.assert_array_equal(a, b)
    finally:
        got.close()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("model,de,dr", MODELS, ids=IDS)
def test_broadcast_equals_tiling(model, de, dr, mode):
    """A [1, n] row through the gather forward (and, for the bilinear
    models, the dense scores) equals the same row tiled to [B, n]."""
    _, tspec, p, pos, neg, _ = _setup(model, de, dr)
    tp, pos_t = _t(p), torch.from_numpy(pos).long()
    shared, tiled = torch.from_numpy(neg).long(), torch.from_numpy(np.tile(neg, (16, 1))).long()
    got = t_kge.forward(tp, tspec, (pos_t, shared), mode)
    assert got.shape == (16, 12)
    assert torch.equal(got, t_kge.forward(tp, tspec, (pos_t, tiled), mode))
    if t_ms.supports_dense(model):
        got = t_ms.dense_negative_scores(tspec, tp, pos_t, shared, mode)
        assert got.shape == (16, 12)
        assert torch.equal(got, t_ms.dense_negative_scores(tspec, tp, pos_t, tiled, mode))


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("model,de,dr", MODELS, ids=IDS)
def test_loss_and_grads_match_jax(model, de, dr, dtype):
    """loss_and_logs with a shared row, both modes: the gather path's
    recomputed negative forward (RotatE, pRotatE, TransE) and the dense path
    (DistMult, ComplEx at E <= 100 n) against JAX's."""
    jspec, tspec, p, pos, neg, w = _setup(model, de, dr, seed=3, dtype=dtype)
    kw = dict(negative_sample_size=12, batch_size=16, negative_adversarial_sampling=True,
              regularization=1e-5 if model == "ComplEx" else 0.0)
    jts, tts = JTrainSpec(**kw), TTrainSpec(**kw)
    for mode in MODES:
        with jax_precision(dtype):
            (want, want_logs), want_g = jax.value_and_grad(
                lambda q: j_train.loss_and_logs(q, jspec, jts, jnp.asarray(pos),
                                                jnp.asarray(neg), jnp.asarray(w), mode),
                has_aux=True)({k: jnp.asarray(v) for k, v in p.items()})
            want_logs = {k: float(v) for k, v in want_logs.items()}
            want_g = {k: np.asarray(v) for k, v in want_g.items()}
        tp = {k: v.requires_grad_(True) for k, v in _t(p).items()}
        loss, logs = t_train.loss_and_logs(tp, tspec, tts, torch.from_numpy(pos).long(),
                                           torch.from_numpy(neg).long(), torch.from_numpy(w),
                                           mode)
        assert set(logs) == set(want_logs)
        for k in want_logs:
            np.testing.assert_allclose(float(logs[k].detach()), want_logs[k], **TOL[dtype],
                                       err_msg=k)
        for k, g in zip(tp, torch.autograd.grad(loss, list(tp.values()))):
            assert g.numpy().dtype == want_g[k].dtype
            np.testing.assert_allclose(g.numpy(), want_g[k], **TOL[dtype], err_msg=(mode, k))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("model,de,dr", [MODELS[0], MODELS[3], MODELS[4]],
                         ids=["TransE", "RotatE", "pRotatE"])
def test_recompute_equals_no_recompute(model, de, dr, precision, monkeypatch):
    """The checkpointed negative forward against the same forward kept in
    the graph (the checkpoint replaced by a plain call): loss and gradients
    bit for bit, through torch.autograd.grad as train_step takes them."""
    _, tspec, p, pos, neg, w = _setup(model, de, dr, seed=4)
    tts = TTrainSpec(negative_sample_size=12, batch_size=16,
                     negative_adversarial_sampling=True, precision=precision)

    def run():
        tp = {k: v.requires_grad_(True) for k, v in _t(p).items()}
        loss, _ = t_train.loss_and_logs(tp, tspec, tts, torch.from_numpy(pos).long(),
                                        torch.from_numpy(neg).long(), torch.from_numpy(w),
                                        "head-batch")
        return loss, torch.autograd.grad(loss, list(tp.values()))

    calls = []
    real = t_train.checkpoint
    monkeypatch.setattr(t_train, "checkpoint",
                        lambda fn, *a, **kw: calls.append(kw) or real(fn, *a, **kw))
    loss_r, grads_r = run()
    assert calls == [dict(use_reentrant=False, preserve_rng_state=False)]
    monkeypatch.setattr(t_train, "checkpoint", lambda fn, *a, **kw: fn(*a))
    loss_p, grads_p = run()
    assert torch.equal(loss_r, loss_p)
    assert all(torch.equal(a, b) for a, b in zip(grads_r, grads_p))


def test_per_positive_negatives_take_no_recompute(monkeypatch):
    """As in the JAX package, only a shared row with B > 1 is recomputed."""
    _, tspec, p, pos, _, w = _setup("RotatE", True, False)
    monkeypatch.setattr(t_train, "checkpoint", lambda *a, **kw: pytest.fail("recomputed"))
    neg = torch.from_numpy(np.random.default_rng(0).integers(0, 60, (16, 12)))
    t_train.loss_and_logs(_t(p), tspec, TTrainSpec(negative_sample_size=12),
                          torch.from_numpy(pos).long(), neg, torch.from_numpy(w), "tail-batch")


def _train(E=60, R=4, T=400, seed=0):
    rng = np.random.default_rng(seed)
    tr = np.stack([rng.integers(0, E, T), rng.integers(0, R, T), rng.integers(0, E, T)], 1)
    return np.unique(tr, axis=0).astype(np.int32)


@pytest.mark.parametrize("mode", MODES)
def test_device_shared_draw(mode):
    """The device sampler's shared row: no CSR, shape [1, n], ids in [0, E),
    the same row for the same draw index (on a fresh sampler too) and
    another for the next one; the positives and weights are the
    per-positive sampler's."""
    train = _train()
    make = lambda sharing: t_ds.DeviceSampler(train, 60, 4, 16, 32, mode, seed=3,  # noqa: E731
                                              negative_sharing=sharing)
    s, again, plain = make("batch"), make("batch"), make("none")
    assert s.csr is None and plain.csr is not None
    idx = torch.arange(16, dtype=torch.int32)
    pos, neg, w = s.sample(idx, torch.tensor(7))
    assert neg.shape == (1, 32) and neg.dtype == torch.int32
    assert int(neg.min()) >= 0 and int(neg.max()) < 60
    assert torch.equal(neg, again.sample(idx, torch.tensor(7))[1])
    assert not torch.equal(neg, s.sample(idx, torch.tensor(8))[1])
    want = plain.sample(idx, torch.tensor(7))
    assert torch.equal(pos, want[0]) and torch.equal(w, want[2])
    batch = s.next_batch()
    assert batch[1].shape == (1, 32) and batch[3] == mode


@pytest.mark.parametrize("mode", MODES)
def test_device_shared_draw_is_uniform(mode):
    """4,096 draw indices of a [1, 64] row over E = 97: Pearson's statistic
    over the 97 ids (96 degrees of freedom) has |z| < 3."""
    E = 97
    s = t_ds.DeviceSampler(_train(E=E), E, 4, 8, 64, mode, seed=11, negative_sharing="batch")
    idx = torch.zeros(8, dtype=torch.int32)
    counts = np.zeros(E)
    for d in range(1, 4097):
        counts += np.bincount(s.sample(idx, torch.tensor(d))[1].numpy().ravel(), minlength=E)
    expected = counts.sum() / E
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    z = (chi2 - (E - 1)) / math.sqrt(2 * (E - 1))
    assert abs(z) < 3, z


def test_shared_device_sampler_skips_the_key_guard():
    """Shared negatives build no CSR, so a key space past int32 is allowed,
    as in the JAX package."""
    from knowledgegraphembedding_tpu.sampler import device_sampler as j_ds

    train = np.zeros((4, 3), np.int32)
    for mod in (t_ds, j_ds):
        s = mod.DeviceSampler(train, 2**17, 2**15, 4, 4, "tail-batch", negative_sharing="batch")
        assert s.csr is None


def test_shared_negatives_learn():
    """tests/test_negative_sharing.py::test_shared_negatives_learn on the
    port: RotatE on the clustered graph with shared rows, HITS@10 > 0.35."""
    ds = make_clustered_kg(n_clusters=6, entities_per_cluster=10, nrelation=3, seed=0)
    spec = TSpec(model_name="RotatE", nentity=ds.nentity, nrelation=ds.nrelation,
                 hidden_dim=32, gamma=6.0, double_entity_embedding=True)
    tspec = TTrainSpec(negative_sample_size=32, batch_size=64,
                       negative_adversarial_sampling=True)
    params = t_kge.init_params(spec, torch.Generator().manual_seed(0), device="cpu")
    trainer = t_train.Trainer(spec, tspec, params, lr=5e-3, warm_up_steps=10**9)
    it = t_iterator(ds.train, ds.nentity, ds.nrelation, 64, 32, prefetch_depth=0,
                    backend="numpy", negative_sharing="batch")
    for _ in range(300):
        pos, neg, w, mode = next(it)
        assert neg.shape == (1, 32)
        trainer.one_step((torch.from_numpy(pos), torch.from_numpy(neg), torch.from_numpy(w),
                          mode))
    filters = TFilterSets.build(ds.train, ds.all_true_triples, ds.nentity, ds.nrelation)
    metrics = t_eval.test_step(trainer.params, spec, ds.test, filters, test_batch_size=8,
                               eval_chunk_size=32)
    assert metrics["HITS@10"] > 0.35, metrics
