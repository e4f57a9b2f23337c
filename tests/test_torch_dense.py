"""The port's dense matmul scoring (ops/matmul_scoring.py, the dense branches
of eval.py and train.py) against the JAX package's on the same numpy inputs.

Tolerances: scores at f32 rtol 1e-5 / atol 1e-6 (the two matmuls sum the
d products in different orders) and at f64 rtol 1e-12; ranks exactly
(f64, where no near tie can flip between two summation orders, and the
small f32 cases used here); one train step's loss, gradients and Adam
update at f32 rtol 1e-5 / atol 1e-7 and f64 rtol 1e-12 / atol 1e-15."""

import contextlib
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from knowledgegraphembedding_torch import checkpoint as t_ckpt
from knowledgegraphembedding_torch import cli as t_cli
from knowledgegraphembedding_torch import eval as t_eval
from knowledgegraphembedding_torch import train as t_train
from knowledgegraphembedding_torch.config import ModelSpec as TSpec
from knowledgegraphembedding_torch.config import RunConfig as TRunConfig
from knowledgegraphembedding_torch.config import TrainSpec as TTrainSpec
from knowledgegraphembedding_torch.data.filterset import FilterSets as TFilterSets
from knowledgegraphembedding_torch.models import kge as t_kge
from knowledgegraphembedding_torch.ops import matmul_scoring as t_ms
from knowledgegraphembedding_tpu import cli as j_cli
from knowledgegraphembedding_tpu import eval as j_eval
from knowledgegraphembedding_tpu import optim as j_optim
from knowledgegraphembedding_tpu import train as j_train
from knowledgegraphembedding_tpu.config import ModelSpec as JSpec
from knowledgegraphembedding_tpu.config import TrainSpec as JTrainSpec
from knowledgegraphembedding_tpu.data.filterset import FilterSets as JFilterSets
from knowledgegraphembedding_tpu.data.synthetic import make_clustered_kg, make_random_kg
from knowledgegraphembedding_tpu.data.vocab import save_dataset
from knowledgegraphembedding_tpu.models import kge as j_kge
from knowledgegraphembedding_tpu.ops import matmul_scoring as j_ms

CASES = [("DistMult", False, False), ("ComplEx", True, True)]
IDS = [c[0] for c in CASES]
MODES = ["head-batch", "tail-batch"]
DTYPES = [np.float32, np.float64]
TOL = {np.float32: dict(rtol=1e-5, atol=1e-6), np.float64: dict(rtol=1e-12, atol=1e-15)}


@contextlib.contextmanager
def jax_precision(dtype):
    jax.config.update("jax_enable_x64", dtype == np.float64)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


def _setup(model, de, dr, E=50, R=7, dim=16, B=6, n=9, seed=0, dtype=np.float32):
    """The inputs of tests/test_dense_scoring.py::setup, as numpy."""
    kw = dict(model_name=model, nentity=E, nrelation=R, hidden_dim=dim, gamma=12.0,
              double_entity_embedding=de, double_relation_embedding=dr)
    jspec, tspec = JSpec(**kw), TSpec(**kw)
    rng = np.random.default_rng(seed)
    r = jspec.embedding_range
    params = {
        "entity_embedding": rng.uniform(-r, r, (E, jspec.entity_dim)).astype(dtype),
        "relation_embedding": rng.uniform(-r, r, (R, jspec.relation_dim)).astype(dtype),
    }
    pos = np.stack([rng.integers(0, E, B), rng.integers(0, R, B), rng.integers(0, E, B)],
                   1).astype(np.int32)
    neg = rng.integers(0, E, (B, n)).astype(np.int32)
    w = rng.uniform(0.1, 1, B).astype(dtype)
    return jspec, tspec, params, pos, neg, w


def _j(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def _t(params):
    return t_kge.params_from_numpy(params, "cpu")


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("model,de,dr", CASES, ids=IDS)
def test_dense_scores_all_and_negatives_match_jax(model, de, dr, mode, dtype):
    jspec, tspec, p, pos, neg, _ = _setup(model, de, dr, dtype=dtype)
    with jax_precision(dtype):
        want_all = np.asarray(j_ms.dense_scores_all(jspec, _j(p), jnp.asarray(pos), mode,
                                                    compute_dtype=jnp.dtype(dtype)))
        want_neg = np.asarray(j_ms.dense_negative_scores(jspec, _j(p), jnp.asarray(pos),
                                                         jnp.asarray(neg), mode,
                                                         compute_dtype=jnp.dtype(dtype)))
    tp = _t(p)
    got_all = t_ms.dense_scores_all(tspec, tp, torch.from_numpy(pos), mode)
    got_neg = t_ms.dense_negative_scores(tspec, tp, torch.from_numpy(pos),
                                         torch.from_numpy(neg), mode)
    assert got_all.shape == (pos.shape[0], tspec.nentity) and got_all.dtype == tp[
        "entity_embedding"].dtype
    np.testing.assert_allclose(got_all.numpy(), want_all, **TOL[dtype])
    np.testing.assert_allclose(got_neg.numpy(), want_neg, **TOL[dtype])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("model,de,dr", CASES, ids=IDS)
def test_dense_scores_match_gather(model, de, dr, mode):
    """tests/test_dense_scoring.py::test_dense_scores_match_gather on the
    port: the dense scores equal the gather path's (the port's and JAX's)."""
    jspec, tspec, p, pos, neg, _ = _setup(model, de, dr)
    tp = _t(p)
    got = t_ms.dense_negative_scores(tspec, tp, torch.from_numpy(pos), torch.from_numpy(neg),
                                     mode)
    gather = t_kge.forward(tp, tspec, (torch.from_numpy(pos).long(),
                                       torch.from_numpy(neg).long()), mode)
    want = np.asarray(j_kge.forward(_j(p), jspec, (jnp.asarray(pos), jnp.asarray(neg)), mode))
    np.testing.assert_allclose(got.numpy(), gather.detach().numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("model,de,dr", CASES, ids=IDS)
def test_dense_loss_and_grads_match_gather(model, de, dr, mode):
    """tests/test_dense_scoring.py::test_dense_loss_and_grads_match_gather on
    the port, and the port's dense loss and gradients against JAX's."""
    jspec, tspec, p, pos, neg, w = _setup(model, de, dr, seed=3)
    kw = dict(negative_sample_size=9, negative_adversarial_sampling=True, regularization=1e-5)
    t_dense, t_gather = TTrainSpec(scoring="dense", **kw), TTrainSpec(scoring="gather", **kw)
    assert t_train.use_dense_scoring(tspec, t_dense)
    assert not t_train.use_dense_scoring(tspec, t_gather)

    def loss_grads(tsp):
        tp = {k: v.requires_grad_(True) for k, v in _t(p).items()}
        loss, _ = t_train.loss_and_logs(tp, tspec, tsp, torch.from_numpy(pos).long(),
                                        torch.from_numpy(neg).long(), torch.from_numpy(w), mode)
        grads = torch.autograd.grad(loss, list(tp.values()))
        return float(loss.detach()), {k: g.numpy() for k, g in zip(tp, grads)}

    l1, g1 = loss_grads(t_dense)
    l2, g2 = loss_grads(t_gather)
    np.testing.assert_allclose(l1, l2, rtol=1e-5)
    lj, gj = jax.value_and_grad(lambda q: j_train.loss_and_logs(
        q, jspec, JTrainSpec(scoring="dense", **kw), jnp.asarray(pos), jnp.asarray(neg),
        jnp.asarray(w), mode)[0])(_j(p))
    np.testing.assert_allclose(l1, float(lj), rtol=1e-5)
    for k in g1:
        np.testing.assert_allclose(g1[k], g2[k], rtol=2e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(g1[k], np.asarray(gj[k]), rtol=1e-5, atol=1e-8, err_msg=k)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("model,de,dr", CASES, ids=IDS)
def test_dense_train_step_matches_jax(model, de, dr, dtype):
    """One dense loss, gradient and Adam step per mode, JAX train_step vs
    the port's Trainer, from the same params and batch."""
    jspec, tspec, p, pos, neg, w = _setup(model, de, dr, seed=5, dtype=dtype)
    kw = dict(negative_sample_size=9, batch_size=6, negative_adversarial_sampling=True,
              regularization=1e-5, scoring="auto")
    jts, tts = JTrainSpec(**kw), TTrainSpec(**kw)
    assert j_train.use_dense_scoring(jspec, jts) and t_train.use_dense_scoring(tspec, tts)
    lr = 0.01
    with jax_precision(dtype):
        jp, state = _j(p), j_optim.init_state(_j(p))
        want_logs = []
        for mode in MODES:
            jp, state, logs = j_train.train_step(
                jp, state, jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(w),
                jnp.asarray(lr, dtype), spec=jspec, tspec=jts, mode=mode)
            want_logs.append({k: float(v) for k, v in logs.items()})
        want = {k: np.asarray(v) for k, v in jp.items()}
    trainer = t_train.Trainer(tspec, tts, _t(p), lr=lr, warm_up_steps=10)
    assert trainer.dense
    for mode, wl in zip(MODES, want_logs):
        logs = trainer.one_step((torch.from_numpy(pos), torch.from_numpy(neg),
                                 torch.from_numpy(w), mode))
        for k in wl:
            np.testing.assert_allclose(float(logs[k]), wl[k], **TOL[dtype], err_msg=k)
    for k in want:
        got = trainer.params[k].detach().numpy()
        assert got.dtype == want[k].dtype
        np.testing.assert_allclose(got, want[k], **TOL[dtype], err_msg=k)


def test_dense_rejected_for_nonbilinear():
    jspec, tspec, *_ = _setup("DistMult", False, False)
    tspec = dataclasses.replace(tspec, model_name="RotatE", double_entity_embedding=True)
    with pytest.raises(ValueError, match="dense bilinear"):
        t_train.use_dense_scoring(tspec, TTrainSpec(scoring="dense"))
    for fn in (lambda: t_ms.phi("RotatE", torch.zeros(1, 4), torch.zeros(1, 4)),
               lambda: t_ms.phi_for_mode("TransE", torch.zeros(1, 4), torch.zeros(1, 4),
                                         "head-batch")):
        with pytest.raises(ValueError, match="dense bilinear"):
            fn()


@pytest.mark.parametrize("model", ["TransE", "DistMult", "ComplEx", "RotatE", "pRotatE"])
def test_use_dense_scoring_matches_jax(model):
    for scoring in ("auto", "gather", "dense"):
        for E in (10, 2560, 2561, 14541, 123182):
            for n in (1, 25, 128, 256):
                kw = dict(model_name=model, nentity=E, nrelation=3, hidden_dim=4, gamma=1.0,
                          double_entity_embedding=model in ("RotatE", "ComplEx"),
                          double_relation_embedding=model == "ComplEx")
                jspec, tspec = JSpec(**kw), TSpec(**kw)
                jts = JTrainSpec(scoring=scoring, negative_sample_size=n)
                tts = TTrainSpec(scoring=scoring, negative_sample_size=n)
                try:
                    want = j_train.use_dense_scoring(jspec, jts)
                except ValueError as e:
                    with pytest.raises(ValueError, match=str(e)):
                        t_train.use_dense_scoring(tspec, tts)
                    continue
                assert t_train.use_dense_scoring(tspec, tts) == want, (scoring, E, n)


@pytest.mark.parametrize("model,de,dr", CASES, ids=IDS)
def test_dense_eval_ranks_match_chunked(model, de, dr):
    """tests/test_dense_scoring.py::test_dense_eval_ranks_match_chunked on the
    port: ranks_batch's dense branch against brute force over the scores, and
    against JAX's ranks_batch."""
    ds = make_random_kg(nentity=60, nrelation=4, ntriples=600, n_valid=50, n_test=60, seed=5)
    jspec, tspec, p, *_ = _setup(model, de, dr, E=60, R=4)
    filters = TFilterSets.build(ds.train, ds.all_true_triples, 60, 4)
    tp = _t(p)
    for mode in MODES:
        test_triples = ds.test[:10]
        mask = filters.filter_mask_rows(test_triples, mode)
        mask_p = t_eval._pad_mask(mask, 16)
        got = t_eval.ranks_batch(tp, torch.from_numpy(test_triples), torch.from_numpy(mask_p),
                                 spec=tspec, mode=mode, chunk=16).numpy()
        want = np.asarray(j_eval.ranks_batch(_j(p), jnp.asarray(test_triples),
                                             jnp.asarray(mask_p), spec=jspec, mode=mode,
                                             chunk=16))
        np.testing.assert_array_equal(got, want)
        all_scores = t_ms.dense_scores_all(tspec, tp, torch.from_numpy(test_triples),
                                           mode).numpy()
        true_ids = test_triples[:, 0] if mode == "head-batch" else test_triples[:, 2]
        for i in range(len(test_triples)):
            s = all_scores[i]
            assert got[i] == 1 + int(np.sum((s > s[true_ids[i]]) & ~mask[i]))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("model,de,dr", CASES, ids=IDS)
def test_dense_ranks_window_matches_jax(model, de, dr, mode, dtype):
    ds = make_random_kg(nentity=73, nrelation=5, ntriples=700, n_valid=20, n_test=40, seed=2)
    jspec, tspec, p, *_ = _setup(model, de, dr, E=73, R=5, seed=9, dtype=dtype)
    jf = JFilterSets.build(ds.train, ds.all_true_triples, 73, 5)
    tf = TFilterSets.build(ds.train, ds.all_true_triples, 73, 5)
    pos = ds.test[:32].astype(np.int32)
    with jax_precision(dtype):
        jo, jc, jv, jk = j_eval.DeviceFilter(jf)._modes[mode]
        want = np.asarray(j_eval.dense_ranks_window(_j(p), jnp.asarray(pos), jo, jc, jv,
                                                    spec=jspec, mode=mode, k_max=jk))
    to, tc, tv, tk = t_eval.DeviceFilter(tf, "cpu")._modes[mode]
    assert tk == jk
    got = t_eval.dense_ranks_window(_t(p), torch.from_numpy(pos), to, tc, tv, spec=tspec,
                                    mode=mode, k_max=tk)
    np.testing.assert_array_equal(got.numpy(), want)
    # the window correction equals the masked count of ranks_batch
    mask = torch.from_numpy(tf.filter_mask_rows(pos, mode))
    np.testing.assert_array_equal(
        got.numpy(), t_eval.ranks_batch(_t(p), torch.from_numpy(pos), mask, spec=tspec,
                                        mode=mode, chunk=tspec.nentity).numpy())


def _eval_setup(model, E=73, R=5, seed=0):
    """tests/test_device_eval.py::_setup, both packages."""
    ds = make_random_kg(nentity=E, nrelation=R, ntriples=400, n_valid=40, n_test=40, seed=seed)
    kw = dict(model_name=model, nentity=E, nrelation=R, hidden_dim=16, gamma=6.0,
              double_entity_embedding=model == "ComplEx",
              double_relation_embedding=model == "ComplEx")
    jspec, tspec = JSpec(**kw), TSpec(**kw)
    jparams = j_kge.init_params(jspec, jax.random.PRNGKey(1))
    tparams = t_kge.params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    jf = JFilterSets.build(ds.train, ds.all_true_triples, E, R)
    tf = TFilterSets.build(ds.train, ds.all_true_triples, E, R)
    return ds, jspec, tspec, jparams, tparams, jf, tf


@pytest.mark.parametrize("model", IDS)
def test_device_eval_metrics_equal_host(model):
    """tests/test_device_eval.py::test_device_eval_metrics_equal_host, dense
    cases: the device filter (dense_ranks_window) equals the host masks,
    and both equal the JAX package's metrics."""
    ds, jspec, tspec, jparams, tparams, jf, tf = _eval_setup(model)
    kw = dict(test_batch_size=8, eval_chunk_size=32)
    want = j_eval.test_step(jparams, jspec, ds.test, jf, device_filter=False,
                            use_pallas=False, **kw)
    assert j_eval.test_step(jparams, jspec, ds.test, jf, device_filter=True,
                            use_pallas=False, **kw) == pytest.approx(want, abs=1e-9)
    for device_filter in (False, True):
        assert t_eval.test_step(tparams, tspec, ds.test, tf, device_filter=device_filter,
                                **kw) == want


def test_ragged_tail_batch_padding():
    """tests/test_device_eval.py::test_ragged_tail_batch_padding: 13 triples
    in batches of 5; the padded rows' ranks are dropped."""
    ds, jspec, tspec, jparams, tparams, jf, tf = _eval_setup("DistMult")
    kw = dict(eval_chunk_size=32, test_batch_size=5)
    want = j_eval.test_step(jparams, jspec, ds.test[:13], jf, device_filter=False,
                            use_pallas=False, **kw)
    for device_filter in (False, True):
        got = t_eval.test_step(tparams, tspec, ds.test[:13], tf, device_filter=device_filter,
                               **kw)
        assert got == pytest.approx(want, abs=1e-12)


def test_full_precision_is_enforced():
    jspec, tspec, p, pos, _, _ = _setup("DistMult", False, False)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="full-f32"):
            t_ms.dense_scores_all(tspec, _t(p), torch.from_numpy(pos), "tail-batch")
        # f64 never runs in TF32
        p64 = {k: v.astype(np.float64) for k, v in p.items()}
        t_ms.dense_scores_all(tspec, _t(p64), torch.from_numpy(pos), "tail-batch")
    finally:
        torch.set_float32_matmul_precision(before)
    # bf16 operands (once refused) multiply in full f32 too: the guard holds
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="full-f32"):
            t_ms.dense_scores_all(tspec, _t(p), torch.from_numpy(pos), "tail-batch",
                                  compute_dtype=torch.bfloat16)
    finally:
        torch.set_float32_matmul_precision(before)
    got = t_ms.dense_scores_all(tspec, _t(p), torch.from_numpy(pos), "tail-batch",
                                compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32


def _windows(save_dir):
    with open(os.path.join(save_dir, "train.log")) as f:
        log = f.read()
    return ([float(x) for x in re.findall(r"Training average loss at step \d+: ([0-9.]+)", log)],
            log)


@pytest.mark.parametrize("model,flags", [("DistMult", []), ("ComplEx", ["-de", "-dr"])],
                         ids=IDS)
def test_tiny_train_and_test_through_both_clis(tmp_path, model, flags):
    """A tiny --do_train --do_test run through both CLIs from one step-0
    checkpoint, --scoring auto (dense at this E, in both packages): equal
    loss windows to 1e-4 and the same Test metrics; the port's log names
    the dense choice and its -init rerun reproduces its metrics."""
    data_dir = str(tmp_path / "data")
    save_dataset(make_clustered_kg(n_clusters=4, entities_per_cluster=7, nrelation=2, seed=5),
                 data_dir)
    init = str(tmp_path / "init")
    cfg = TRunConfig(model=model, double_entity_embedding="-de" in flags,
                     double_relation_embedding="-dr" in flags, hidden_dim=8, gamma=4.0,
                     data_path=data_dir, learning_rate=0.01)
    from knowledgegraphembedding_torch.data import registry as t_registry
    tds = t_registry.load(data_dir)
    cfg.nentity, cfg.nrelation = tds.nentity, tds.nrelation
    params = t_kge.init_params(cfg.model_spec(), torch.Generator().manual_seed(3), device="cpu")
    t_ckpt.save_initial_checkpoint(params, cfg, init, warm_up_steps=30)
    argv = ["--do_train", "--do_test", "-init", init, "-n", "8", "-b", "32", "-adv",
            "-lr", "0.01", "-r", "0.00001", "--max_steps", "40", "--log_steps", "20",
            "--save_checkpoint_steps", "1000", "--test_batch_size", "4",
            "--sampler_backend", "numpy"]
    j_save, t_save = str(tmp_path / "jax"), str(tmp_path / "port")
    want = j_cli.main(argv + ["-save", j_save])
    got = t_cli.main(argv + ["-save", t_save, "--platform", "cpu"])
    (tw, log), (jw, _) = _windows(t_save), _windows(j_save)
    assert len(tw) == 2
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-4)
    assert "negative scoring: dense (--scoring auto)" in log
    assert got["test"] == want["test"]
    assert t_cli.main(["--do_test", "-init", t_save, "--platform", "cpu"])["test"] == got["test"]
