"""Fused k-step training (knowledgegraphembedding_torch/fused_train.py) on
the CPU, where the same step function that the card replays from CUDA
graphs runs eagerly: block(k) equals k blocks of 1 bit for bit, blocks
respect the clipping and the warm-up decay as the JAX package's
FusedDeviceTrainer does, a block's own batches fed to the JAX Trainer give
the same trajectory across the decay (f64 within 1e-9, op-order noise), the
quality bar of tests/test_fused_train.py holds, and the CLI's fused and
per-step device flows log their windows and decay at the JAX CLI's steps."""

import contextlib
import os
import re
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from knowledgegraphembedding_torch import checkpoint as t_ckpt
from knowledgegraphembedding_torch import cli as t_cli
from knowledgegraphembedding_torch import cuda_graphs
from knowledgegraphembedding_torch import eval as t_eval
from knowledgegraphembedding_torch.config import ModelSpec as TSpec
from knowledgegraphembedding_torch.config import TrainSpec as TTrainSpec
from knowledgegraphembedding_torch.data.filterset import FilterSets as TFilterSets
from knowledgegraphembedding_torch.fused_train import FusedDeviceTrainer
from knowledgegraphembedding_torch.models import kge as t_kge
from knowledgegraphembedding_tpu import cli as j_cli
from knowledgegraphembedding_tpu import train as j_train
from knowledgegraphembedding_tpu.config import ModelSpec as JSpec
from knowledgegraphembedding_tpu.config import TrainSpec as JTrainSpec
from knowledgegraphembedding_tpu.data.synthetic import make_clustered_kg
from knowledgegraphembedding_tpu.data.vocab import save_dataset
from knowledgegraphembedding_tpu.fused_train import FusedDeviceTrainer as JFused
from knowledgegraphembedding_tpu.models import kge as j_kge

SPEC = dict(model_name="RotatE", hidden_dim=16, gamma=6.0, double_entity_embedding=True)
TSPEC = dict(negative_sample_size=8, batch_size=32, negative_adversarial_sampling=True)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These tensors are small: one intra-op thread, whose ops take
    microseconds, where waking a pool of threads costs milliseconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def kg():
    return make_clustered_kg(n_clusters=5, entities_per_cluster=8, nrelation=2, seed=1)


def _setup(ds, dtype=np.float32, **spec_kw):
    spec = TSpec(nentity=ds.nentity, nrelation=ds.nrelation, **{**SPEC, **spec_kw})
    tspec = TTrainSpec(**TSPEC)
    rng = np.random.default_rng(0)
    r = spec.embedding_range
    p = {"entity_embedding": rng.uniform(-r, r, (spec.nentity, spec.entity_dim)),
         "relation_embedding": rng.uniform(-r, r, (spec.nrelation, spec.relation_dim))}
    return spec, tspec, {k: np.asarray(v, dtype) for k, v in p.items()}


def _fused(ds, spec, tspec, p, **kw):
    kw = {"lr": 1e-2, "warm_up_steps": 10**9, "seed": 3, **kw}
    return FusedDeviceTrainer(spec, tspec, t_kge.params_from_numpy(p, "cpu"),
                              train=ds.train, **kw)


@pytest.mark.parametrize("start,sharing", [(0, "none"), (1, "none"), (0, "batch"),
                                           (1, "batch")],
                         ids=["even", "odd", "even-shared", "odd-shared"])
def test_block_equals_singles_bit_for_bit(kg, start, sharing):
    """run_block(8) == 8 x run_block(1) from the same state, starting on a
    tail (even) or a head (odd) step, with per-positive or shared negatives
    (as tests/test_fused_train.py::test_block_equals_singles): params,
    moments, count and the summed logs are equal bit for bit (one step
    function, one order of ops)."""
    spec, tspec, p = _setup(kg)
    a, b = (_fused(kg, spec, tspec, p, negative_sharing=sharing) for _ in range(2))
    for tr in (a, b)[:2 * start]:
        tr.run_block(1)
    logs_a = a.run_block(8)
    sums = None
    for _ in range(8):
        lg = b.run_block(1)
        sums = lg if sums is None else {k: sums[k] + lg[k] for k in lg}
    assert a.step == b.step == 8 + start
    assert a.opt_state.count == b.opt_state.count == 8 + start
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
        assert torch.equal(a.opt_state.m[k], b.opt_state.m[k]), k
        assert torch.equal(a.opt_state.v[k], b.opt_state.v[k]), k
    assert set(logs_a) == {"loss", "negative_sample_loss", "positive_sample_loss"}
    for k in logs_a:
        assert torch.equal(logs_a[k], sums[k]), k


class _StandInCapturer(cuda_graphs.Capturer):
    """Captures nothing: each "graph" replays its body eagerly, so the
    replay path of ``cuda_graphs.Graph`` runs on the CPU."""

    def capture(self, kind, body, *, written=(), warm=None):
        return cuda_graphs.Graph(kind, types.SimpleNamespace(replay=body), None, [], written)


def test_run_block_bumps_versions_for_the_ranker_cache(kg, monkeypatch):
    """A CUDA graph replay writes the params without moving their autograd
    version. Here the block's graphs (``_block_graph``) are replayed by a
    stand-in for the card, and the step is a write through ``.data``, which
    leaves the version alone as a replay does. With the replay's version
    bump (``cuda_graphs.bump_versions``) switched off, the ranker cache
    serves the pRotatE sin | cos table of before the block; with it on, a
    fresh table equal to a new Ranker's."""
    from knowledgegraphembedding_torch.ops import rank_kernel

    spec = TSpec(nentity=kg.nentity, nrelation=kg.nrelation, model_name="pRotatE",
                 hidden_dim=16, gamma=6.0)
    params = t_kge.init_params(spec, torch.Generator().manual_seed(0), device="cpu")
    tr = FusedDeviceTrainer(spec, TTrainSpec(**TSPEC), params, lr=1e-2, warm_up_steps=10**9,
                            train=kg.train, seed=3)
    monkeypatch.setattr(tr, "_step", lambda mode: tr.params["entity_embedding"].data.add_(0.25))
    tr._capturer = _StandInCapturer("cpu")
    stale = rank_kernel.get_ranker(tr.params, spec)
    table = stale.table.clone()
    version = tr.params["entity_embedding"]._version
    with monkeypatch.context() as m:
        m.setattr(cuda_graphs, "bump_versions", lambda tensors: None)
        for mode in ("tail-batch", "head-batch"):
            tr._block_graph(mode).replay()
    assert tr.params["entity_embedding"]._version == version
    assert rank_kernel.get_ranker(tr.params, spec) is stale  # the fault, without the bump
    assert torch.equal(stale.table, table)
    for mode in ("tail-batch", "head-batch"):
        tr._block_graph(mode).replay()
    assert tr.params["entity_embedding"]._version > version
    fresh = rank_kernel.get_ranker(tr.params, spec)
    assert fresh is not stale
    assert torch.equal(fresh.table, rank_kernel.Ranker(tr.params, spec).table)
    assert not torch.equal(fresh.table, table)


def test_decay_fires_after_block_at_boundary_as_jax(kg):
    spec, tspec, p = _setup(kg)
    tr = _fused(kg, spec, tspec, p, warm_up_steps=10)
    jspec = JSpec(nentity=kg.nentity, nrelation=kg.nrelation, **SPEC)
    jt = JFused(jspec, JTrainSpec(**TSPEC), {k: jnp.asarray(v) for k, v in p.items()},
                lr=1e-2, warm_up_steps=10, train=kg.train, seed=3)
    assert tr.max_block(64) == jt.max_block(64) == 11  # step 10 closes a block
    for t in (tr, jt):
        t.run_block(t.max_block(64))
    assert (tr.step, tr.warm_up_steps, tr.opt_state.count) == (
        jt.step, jt.warm_up_steps, int(jt.opt_state.count)) == (11, 30, 0)
    assert tr.current_learning_rate == pytest.approx(1e-3) == jt.current_learning_rate
    assert float(tr.lr_tensor) == pytest.approx(1e-3)
    assert not any(bool(m.any()) for m in tr.opt_state.m.values())
    assert tr.max_block(64) == jt.max_block(64) == 20  # the next boundary, step 30
    tr.run_block(20)  # steps 11-30: the boundary step 30 decays again
    assert (tr.step, tr.opt_state.count, tr.warm_up_steps) == (31, 0, 90)


def test_run_block_rejects_unclipped_k(kg):
    spec, tspec, p = _setup(kg)
    tr = _fused(kg, spec, tspec, p, warm_up_steps=10)
    for k in (12, 0):
        with pytest.raises(ValueError, match="LR-decay boundary"):
            tr.run_block(k)
    assert tr.step == 0 and tr.opt_state.count == 0


@contextlib.contextmanager
def _x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("model,de,reg,sharing", [("RotatE", True, 0.0, "none"),
                                                 ("ComplEx", True, 1e-4, "none"),
                                                 ("RotatE", True, 0.0, "batch"),
                                                 ("ComplEx", True, 1e-4, "batch")],
                         ids=["RotatE-True-0.0", "ComplEx-True-0.0001", "RotatE-shared",
                              "ComplEx-shared"])
def test_block_batches_fed_to_jax_trainer_match_across_decay(kg, model, de, reg, sharing):
    """The fused blocks (clipped at the decay, warm-up 5, 14 steps) and the
    JAX Trainer's one_step fed the batches those blocks drew: the same
    trajectory at f64 within 1e-9 and the same schedule. With shared
    negatives the blocks draw [1, n] rows, and JAX's step recomputes (gather)
    or broadcasts (dense) them as the port's does."""
    spec_kw = dict(model_name=model, double_entity_embedding=de,
                   double_relation_embedding=model == "ComplEx")
    spec, _, p = _setup(kg, np.float64, **spec_kw)
    tspec = TTrainSpec(regularization=reg, **TSPEC)
    tr = _fused(kg, spec, tspec, p, warm_up_steps=5, record_batches=True,
                negative_sharing=sharing)
    batches = []
    while tr.step < 14:
        tr.run_block(tr.max_block(min(6, 14 - tr.step)))
        batches += tr.recorded()
    assert tr.warm_up_steps == 15
    assert batches[0][1].shape == ((1, 8) if sharing == "batch" else (32, 8))
    jspec = JSpec(nentity=kg.nentity, nrelation=kg.nrelation, hidden_dim=16, gamma=6.0,
                  **spec_kw)
    with _x64():
        jt = j_train.Trainer(jspec, JTrainSpec(regularization=reg, **TSPEC),
                             {k: jnp.asarray(v) for k, v in p.items()}, lr=1e-2,
                             warm_up_steps=5)
        for pos, neg, w, mode in batches:
            jt.one_step((jnp.asarray(pos.numpy()), jnp.asarray(neg.numpy()),
                         jnp.asarray(w.numpy()), mode))
        want = {k: np.asarray(v) for k, v in jt.params.items()}
        jstate = (jt.step, jt.current_learning_rate, jt.warm_up_steps, int(jt.opt_state.count))
    assert (tr.step, tr.current_learning_rate, tr.warm_up_steps, tr.opt_state.count) == jstate
    for k in want:
        got = tr.params[k].detach().numpy()
        assert got.dtype == np.float64
        np.testing.assert_allclose(got, want[k], rtol=0, atol=1e-9, err_msg=k)


def test_fused_learns_clustered_graph():
    ds = make_clustered_kg(n_clusters=6, entities_per_cluster=10, nrelation=3, seed=0)
    spec = TSpec(model_name="RotatE", nentity=ds.nentity, nrelation=ds.nrelation,
                 hidden_dim=32, gamma=6.0, double_entity_embedding=True)
    tspec = TTrainSpec(negative_sample_size=32, batch_size=64,
                       negative_adversarial_sampling=True)
    params = t_kge.init_params(spec, torch.Generator().manual_seed(0), device="cpu")
    tr = FusedDeviceTrainer(spec, tspec, params, lr=5e-3, warm_up_steps=10**9,
                            train=ds.train, seed=0, block_capacity=20)
    for _ in range(300 // 20):
        tr.run_block(20)
    filters = TFilterSets.build(ds.train, ds.all_true_triples, ds.nentity, ds.nrelation)
    metrics = t_eval.test_step(tr.params, spec, ds.test, filters, test_batch_size=8,
                               eval_chunk_size=32)
    assert metrics["HITS@10"] > 0.35, metrics


# ---- the CLI flows, through both packages --------------------------------

FLOW = ["--model", "RotatE", "-de", "-n", "8", "-b", "32", "-d", "8", "-g", "4.0", "-adv",
        "-lr", "0.01", "--max_steps", "60", "--log_steps", "20", "--warm_up_steps", "30",
        "--save_checkpoint_steps", "25", "--test_batch_size", "4"]
FLOWS = {"fused": ["--steps_per_dispatch", "8"],
         "device": ["--sampler_backend", "device"],
         # the max-throughput stack: fused blocks, shared negatives, bf16
         "fused-shared-bf16": ["--steps_per_dispatch", "8", "--negative_sharing", "batch",
                               "--precision", "bf16"]}


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("kg") / "data")
    save_dataset(make_clustered_kg(n_clusters=4, entities_per_cluster=7, nrelation=2, seed=5), d)
    return d


def _events(save_dir):
    with open(os.path.join(save_dir, "train.log")) as f:
        log = f.read()
    windows = re.findall(r"Training average (\w+) at step (\d+):", log)
    decay = re.findall(r"Change learning_rate to \S+ at step \d+", log)
    loss = [float(x) for x in re.findall(r"Training average loss at step \d+: (\S+)", log)]
    return windows, decay, loss, log


@pytest.fixture(scope="module")
def flows(data_dir, tmp_path_factory):
    """Each flow through the JAX CLI and the port's: (port metrics, save
    dirs)."""
    root = tmp_path_factory.mktemp("flows")
    out = {}
    for name, extra in FLOWS.items():
        saves = {pkg: str(root / f"{name}-{pkg}") for pkg in ("jax", "port")}
        argv = ["--do_train", "--do_test", "--data_path", data_dir, *FLOW, *extra]
        j_cli.main(argv + ["-save", saves["jax"]])
        got = t_cli.main(argv + ["-save", saves["port"], "--platform", "cpu"])
        out[name] = (got, saves)
    return out


@pytest.mark.parametrize("flow", list(FLOWS))
def test_cli_flow_logs_events_at_the_jax_steps(flows, flow):
    got, saves = flows[flow]
    jw, jd, _, _ = _events(saves["jax"])
    tw, td, loss, log = _events(saves["port"])
    assert tw == jw and [s for _, s in tw][::4] == ["19", "39", "59"]
    assert td == jd == ["Change learning_rate to 0.001000 at step 30"]
    assert all(np.isfinite(loss)) and loss[0] > loss[-1], loss
    assert "sampler backend: device" in log
    assert ("fused training: 8 steps per dispatch" in log) == flow.startswith("fused")
    assert 0 < got["test"]["MRR"] <= 1


@pytest.mark.parametrize("flow", list(FLOWS))
def test_cli_flow_init_rerun_reproduces_test_metrics(flows, flow):
    got, saves = flows[flow]
    again = t_cli.main(["--do_test", "-init", saves["port"], "--platform", "cpu"])
    assert again["test"] == got["test"]
    ck = t_ckpt.load_checkpoint(saves["port"], "cpu")
    assert (ck.step, ck.warm_up_steps, ck.adam_count) == (60, 90, 29)


def test_fused_checkpoint_resumes_per_step_and_in_jax(flows, tmp_path):
    """A fused run's checkpoint: the JAX CLI's ``-init --do_test`` gives the
    port's Test metrics, and the port's per-step CLI trains on from it."""
    got, saves = flows["fused"]
    want = j_cli.main(["--do_test", "-init", saves["port"]])
    assert want["test"] == got["test"]
    more = t_cli.main(["--do_train", "-init", saves["port"], "--max_steps", "70",
                       "--log_steps", "10", "-save", str(tmp_path), "--platform", "cpu"])
    assert more == {}
    ck = t_ckpt.load_checkpoint(str(tmp_path), "cpu")
    assert (ck.step, ck.adam_count) == (70, 39)


def test_fused_cli_logs_regularization(data_dir, tmp_path):
    t_cli.main(["--do_train", "--data_path", data_dir, "--model", "ComplEx", "-de", "-dr",
                "-r", "0.00001", "-n", "4", "-b", "16", "-d", "8", "-g", "200.0",
                "-lr", "0.001", "--max_steps", "20", "--log_steps", "10",
                "--steps_per_dispatch", "4", "-save", str(tmp_path), "--platform", "cpu"])
    _, _, _, log = _events(str(tmp_path))
    assert "Training average regularization at step 9" in log
    assert "Training average regularization at step 19" in log
    assert "negative scoring: dense (--scoring auto)" in log


def test_device_sampler_cli_learns(data_dir, tmp_path):
    """The per-step device flow learns well above chance (the bar of
    tests/test_device_sampler.py::test_train_e2e_with_device_sampler). The
    port draws its init with torch, not JAX: at --seed 0 this init stays
    near chance with either sampler (MRR 0.149 numpy, 0.132 device); at
    seeds 1-4 both reach 0.19-0.27, so seed 1 is used."""
    metrics = t_cli.main(["--do_train", "--do_test", "--seed", "1", "--data_path", data_dir,
                          "--model",
                          "RotatE", "-de", "-n", "8", "-b", "32", "-d", "8", "-g", "4.0",
                          "-adv", "-lr", "0.01", "--max_steps", "120", "--log_steps", "60",
                          "--sampler_backend", "device", "--test_batch_size", "4",
                          "-save", str(tmp_path), "--platform", "cpu"])
    assert metrics["test"]["MRR"] > 0.15


def test_auto_sampler_policy(data_dir, caplog):
    """``--sampler_backend auto`` on CUDA (the JAX CLI's policy on the TPU):
    the device sampler for dense scoring, else the host sampler unless the
    median of three host batches takes over 25 ms."""
    import logging

    from knowledgegraphembedding_torch.data import registry

    ds = registry.load(data_dir)
    chosen = {}
    with caplog.at_level(logging.INFO):
        for model, flags in (("DistMult", []), ("RotatE", ["-de"])):
            cfg = t_cli.parse_args(["--do_train", "--data_path", data_dir, "-save", "s",
                                    "--model", model, *flags, "-n", "8", "-b", "32", "-d", "8"])
            cfg.nentity, cfg.nrelation = ds.nentity, ds.nrelation
            chosen[model] = t_cli._auto_sampler_backend(cfg, ds, cfg.model_spec(),
                                                        cfg.train_spec())
    assert chosen == {"DistMult": "device", "RotatE": "auto"}
    text = caplog.text
    assert "sampler backend: device (auto)" in text
    assert re.search(r"sampler auto-probe: host batches [0-9./]+ ms \(median [0-9.]+, "
                     r"threshold 25.0\)", text)
    assert "sampler backend: host (auto" in text
