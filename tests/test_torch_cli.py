"""The port's CLI against the JAX package's: a checkpoint trained by the JAX
CLI (the tiny RotatE run of the verify recipe) is evaluated by both CLIs with
``--do_test -init`` and must give the same Test metrics; flags of work not
ported yet are refused; the platform flag never falls back to the CPU."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from knowledgegraphembedding_torch import checkpoint as t_ckpt
from knowledgegraphembedding_torch import cli as t_cli
from knowledgegraphembedding_torch.config import RunConfig as TRunConfig
from knowledgegraphembedding_torch.models import kge as t_kge
from knowledgegraphembedding_tpu import checkpoint as j_ckpt
from knowledgegraphembedding_tpu import cli as j_cli
from knowledgegraphembedding_tpu.config import RunConfig as JRunConfig
from knowledgegraphembedding_tpu.data.synthetic import make_clustered_kg
from knowledgegraphembedding_tpu.data.vocab import save_dataset


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """(data dir, save dir, JAX Test metrics of ``--do_test -init``)."""
    root = tmp_path_factory.mktemp("jax_run")
    data_dir, save_dir = str(root / "data"), str(root / "save")
    save_dataset(make_clustered_kg(n_clusters=4, entities_per_cluster=7, nrelation=2,
                                   seed=5), data_dir)
    j_cli.main([
        "--do_train", "--data_path", data_dir, "--model", "RotatE", "-de",
        "-n", "8", "-b", "32", "-d", "8", "-g", "4.0", "-adv", "-lr", "0.01",
        "--max_steps", "60", "--log_steps", "20", "--test_batch_size", "4",
        "-save", save_dir,
    ])
    metrics = j_cli.main(["--do_test", "-init", save_dir, "--eval_chunk_size", "16"])
    return data_dir, save_dir, metrics["test"]


@pytest.mark.parametrize("extra", [
    [],
    ["--eval_filter", "device"],
    ["--use_pallas", "--eval_filter", "host"],
    ["--no-use_pallas", "--eval_chunk_size", "16"],
], ids=["default", "device-filter", "kernel-host-filter", "plain-chunk16"])
def test_do_test_init_reproduces_jax_metrics(jax_run, extra):
    data_dir, save_dir, want = jax_run
    got = t_cli.main(["--do_test", "-init", save_dir, "--platform", "cpu", *extra])
    assert got["test"] == want


def test_do_valid_and_evaluate_train_match_jax(jax_run):
    data_dir, save_dir, _ = jax_run
    argv = ["--do_valid", "--evaluate_train", "-init", save_dir, "--eval_chunk_size", "16"]
    want = j_cli.main(argv)
    got = t_cli.main(argv + ["--platform", "cpu"])
    assert got == want


@pytest.mark.parametrize("argv,item", [
    (["--do_train", "-save", "s"], "items 5-8"),
    (["--do_test", "--countries"], "item 10"),
    (["--do_test", "--num_shards", "2"], "item 14"),
    (["--do_test", "--model_shards", "2"], "item 14"),
    (["--do_test", "--multihost"], "item 14"),
    (["--do_test", "--precision", "bf16"], "item 11"),
])
def test_unported_flags_are_refused(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        t_cli.main(argv + ["--data_path", "synthetic:clustered", "--platform", "cpu"])


def test_platform_auto_and_gpu_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for platform in ("auto", "gpu"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_cli.main(["--do_test", "--data_path", "synthetic:clustered",
                        "--platform", platform])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_cli.main(["--do_test", "--data_path", "synthetic:clustered", "--cuda"])
    with pytest.raises(ValueError, match="conflicts"):
        t_cli.main(["--do_test", "--data_path", "synthetic:clustered", "--cuda",
                    "--platform", "cpu"])


def test_validation_errors_match_jax():
    for argv, msg in ((["--data_path", "x"], "one of train/val/test"),
                      (["--do_test"], "init_checkpoint/data_path"),
                      (["--do_train", "--data_path", "x"], "save your trained model")):
        with pytest.raises(ValueError, match=msg):
            j_cli.main(argv)
        with pytest.raises(ValueError, match=msg):
            t_cli.main(argv)


@pytest.mark.parametrize("argv", [
    ["--do_train", "--data_path", "x", "-save", "s"],
    ["--do_test", "-init", "ck", "--model", "RotatE", "-de", "-d", "1000", "-g", "9.0",
     "--test_batch_size", "16", "--use_pallas", "--eval_filter", "device", "--seed", "3"],
])
def test_parse_args_matches_jax(argv):
    got = dataclasses.asdict(t_cli.parse_args(argv))
    want = dataclasses.asdict(j_cli.parse_args(argv))
    assert got == want


def test_jax_config_json_loads_in_port(jax_run):
    _, save_dir, _ = jax_run
    with open(os.path.join(save_dir, "config.json")) as f:
        saved = json.load(f)
    assert set(saved) == {f.name for f in dataclasses.fields(TRunConfig)}
    assert dataclasses.asdict(TRunConfig(**saved)) == saved


def test_step0_checkpoint_loads_in_jax(tmp_path):
    cfg = TRunConfig(model="RotatE", double_entity_embedding=True, hidden_dim=4,
                     gamma=3.0, nentity=9, nrelation=2, data_path="synthetic:clustered",
                     learning_rate=0.001)
    params = t_kge.init_params(cfg.model_spec(), torch.Generator().manual_seed(0),
                               device="cpu")
    t_ckpt.save_initial_checkpoint(params, cfg, str(tmp_path), warm_up_steps=7)
    jparams, state, step, lr, warm_up = j_ckpt.load_checkpoint(str(tmp_path))
    assert (step, lr, warm_up, int(state.count)) == (0, 0.001, 7, 0)
    for k, v in params.items():
        np.testing.assert_array_equal(np.asarray(jparams[k]), v.numpy())
        assert not np.asarray(state.m[k]).any() and not np.asarray(state.v[k]).any()
    jcfg = j_ckpt.override_config(JRunConfig(do_test=True, init_checkpoint=str(tmp_path)))
    tcfg = t_ckpt.override_config(TRunConfig(do_test=True, init_checkpoint=str(tmp_path)))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert tcfg.data_path == "synthetic:clustered" and tcfg.hidden_dim == 4


def test_jax_checkpoint_loads_in_port(jax_run):
    _, save_dir, _ = jax_run
    jparams, state, step, lr, warm_up = j_ckpt.load_checkpoint(save_dir)
    ck = t_ckpt.load_checkpoint(save_dir, "cpu")
    assert (ck.step, ck.current_learning_rate, ck.warm_up_steps, ck.adam_count) == (
        step, lr, warm_up, int(state.count))
    for k, v in jparams.items():
        np.testing.assert_array_equal(ck.params[k].numpy(), np.asarray(v))
        np.testing.assert_array_equal(ck.adam_m[k], np.asarray(state.m[k]))
        np.testing.assert_array_equal(ck.adam_v[k], np.asarray(state.v[k]))
