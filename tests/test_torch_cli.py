"""The port's CLI against the JAX package's: a checkpoint trained by the JAX
CLI (the tiny RotatE run of the verify recipe) is evaluated by both CLIs with
``--do_test -init`` and must give the same Test metrics; both CLIs train the
same step-0 checkpoint on the same sampler stream with ``--do_train
--do_valid --do_test`` and must log the same loss windows and Test metrics,
one device or a mesh (``--num_shards 2`` under each ``--spmd_mode``, and
``--num_shards 2 --model_shards 2``: gloo ranks against the JAX CLI's CPU
devices); ``--profile_dir``, ``--no-async_checkpoint`` and the inert
``--sharded_checkpoint`` run and leave the metrics as they were; the
platform flag never falls back to the CPU. The fused and device-sampler flows are in
tests/test_torch_fused_train.py, countries in tests/test_torch_countries.py."""

import dataclasses
import json
import os
import re

import numpy as np
import pytest
import torch

from knowledgegraphembedding_torch import checkpoint as t_ckpt
from knowledgegraphembedding_torch import cli as t_cli
from knowledgegraphembedding_torch.config import RunConfig as TRunConfig
from knowledgegraphembedding_torch.data import registry as t_registry
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


@pytest.mark.parametrize("argv,exc,item", [
    # a host sampler cannot feed a fused block: the JAX CLI's ValueError
    (["--do_train", "-save", "s", "--steps_per_dispatch", "2", "--sampler_backend", "native"],
     ValueError, "cannot feed a fused block"),
])
def test_unported_flags_are_refused(argv, exc, item, tmp_path):
    """The JAX CLI's refusal of a fused block fed by a host sampler (the
    same ValueError in both CLIs, raised after the log file opens in the
    save directory)."""
    argv = [str(tmp_path / a) if a == "s" else a for a in argv]
    with pytest.raises(exc, match=item):
        t_cli.main(argv + ["--data_path", "synthetic:clustered", "--platform", "cpu"])
    if exc is ValueError:
        with pytest.raises(exc, match=item):
            j_cli.main(argv + ["--data_path", "synthetic:clustered", "--platform", "cpu"])


@pytest.mark.parametrize("extra,msg", [
    ([], "coordinator_address should be defined"),
    (["--num_shards", "2"], "coordinator_address should be defined"),
    (["--coordinator_address", "127.0.0.1:1"], "together"),
], ids=["bare", "num_shards", "no-num_processes"])
def test_multihost_without_a_fleet_raises(extra, msg, monkeypatch):
    """An explicit --multihost with neither all three fleet flags nor a
    torchrun environment raises before any rank starts, as the JAX CLI's
    ``initialize(require=True)`` does; it never trains alone as process 0.
    The JAX CLI runs in a fresh process: its check needs an uninitialised
    XLA backend."""
    import subprocess
    import sys

    from knowledgegraphembedding_torch.parallel import multihost as t_mh

    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(t_mh, "launch", lambda *a: pytest.fail("a rank started"))
    argv = ["--do_test", "--multihost", "--data_path", "synthetic:clustered", "--platform",
            "cpu", *extra]
    with pytest.raises(ValueError, match=msg):
        t_cli.main(argv)
    if msg.startswith("coordinator"):
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        out = subprocess.run(
            [sys.executable, "-c", "import sys; from knowledgegraphembedding_tpu import cli; "
             "cli.main(sys.argv[1:])", *argv], cwd=root, capture_output=True, text=True,
            env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=root), timeout=120)
        assert out.returncode != 0
        assert "ValueError: " + msg in out.stderr, out.stderr[-2000:]


@pytest.mark.parametrize("flag", [["--profile_dir", "p"], ["--no-async_checkpoint"],
                                  ["--sharded_checkpoint"]],
                         ids=["profile_dir", "no-async_checkpoint", "sharded_checkpoint"])
def test_item_15_flags_run(tmp_path, flag):
    """Once refused with item 15 (``--profile_dir``) or inert before it: a
    short train-then-test run gives the metrics of the run without the
    flag. ``--sharded_checkpoint`` applies to mesh trainers only (item 14),
    as in the JAX CLI without a mesh: the save stays single-file."""
    argv = ["--do_train", "--do_test", "--data_path", "synthetic:clustered", "--model",
            "TransE", "-n", "4", "-b", "16", "-d", "8", "--max_steps", "12", "--log_steps", "6",
            "--save_checkpoint_steps", "6", "--test_batch_size", "8", "--platform", "cpu"]
    want = t_cli.main(argv + ["-save", str(tmp_path / "plain")])
    flag = [str(tmp_path / a) if a == "p" else a for a in flag]
    got = t_cli.main(argv + flag + ["-save", str(tmp_path / "flag")])
    assert got == want
    assert sorted(f for f in os.listdir(tmp_path / "flag") if f.endswith((".npz", ".npy"))) == [
        "checkpoint.npz", "entity_embedding.npy", "relation_embedding.npy"]
    if flag[0] == "--profile_dir":
        assert [f for f in os.listdir(flag[1]) if f.endswith(".pt.trace.json")]


def test_scoring_dense_on_a_distance_model_is_refused(tmp_path):
    with pytest.raises(ValueError, match="TransE has no dense bilinear form"):
        t_cli.main(["--do_train", "-save", str(tmp_path / "s"), "--scoring", "dense",
                    "--data_path", "synthetic:clustered", "--platform", "cpu"])


@pytest.mark.parametrize("model,flags", [("DistMult", []), ("ComplEx", ["-de", "-dr"])])
def test_bilinear_do_test_matches_jax(jax_run, tmp_path, model, flags):
    """DistMult and ComplEx evaluation (once refused) through both CLIs from
    one step-0 checkpoint: the same Test metrics, host and device filters."""
    data_dir = jax_run[0]
    init = str(tmp_path / "init")
    cfg = TRunConfig(model=model, double_entity_embedding="-de" in flags,
                     double_relation_embedding="-dr" in flags, hidden_dim=8, gamma=4.0,
                     data_path=data_dir)
    tds = t_registry.load(data_dir)
    cfg.nentity, cfg.nrelation = tds.nentity, tds.nrelation
    params = t_kge.init_params(cfg.model_spec(), torch.Generator().manual_seed(4), device="cpu")
    t_ckpt.save_initial_checkpoint(params, cfg, init, warm_up_steps=10)
    want = j_cli.main(["--do_test", "-init", init])
    for extra in ([], ["--eval_filter", "device"], ["--eval_filter", "host", "--use_pallas"]):
        got = t_cli.main(["--do_test", "-init", init, "--platform", "cpu", *extra])
        assert got["test"] == want["test"], extra


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
    ["--do_train", "--data_path", "x", "-save", "s", "--sampler_backend", "device"],
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


TRAIN_RUNS = {
    # model flags, sampler backend: the native stream is bit-identical too
    "RotatE": (["-de", "-d", "8", "-g", "4.0"], "auto"),
    "pRotatE": (["-d", "8", "-g", "4.0"], "numpy"),
}


def _windows(save_dir):
    with open(os.path.join(save_dir, "train.log")) as f:
        return [float(x) for x in re.findall(
            r"Training average loss at step \d+: ([0-9.]+)", f.read())]


@pytest.mark.parametrize("model", TRAIN_RUNS)
def test_do_train_matches_jax_cli(jax_run, tmp_path, model):
    """The tiny verify-recipe run through both CLIs, from one step-0
    checkpoint (the two packages draw random inits differently): loss windows
    agree to 1e-4 (f32 op-order noise over 60 steps), Valid and Test metrics
    to eval granularity (a few rank flips among 2 x 64 ranks; measured equal
    on the CPU), and the port's own ``-init`` rerun reproduces its Test
    metrics exactly."""
    data_dir = jax_run[0]
    flags, backend = TRAIN_RUNS[model]
    init = str(tmp_path / "init")
    cfg = TRunConfig(model=model, double_entity_embedding="-de" in flags, hidden_dim=8,
                     gamma=4.0, data_path=data_dir, learning_rate=0.01)
    tds = t_registry.load(data_dir)
    cfg.nentity, cfg.nrelation = tds.nentity, tds.nrelation
    params = t_kge.init_params(cfg.model_spec(), torch.Generator().manual_seed(3), device="cpu")
    t_ckpt.save_initial_checkpoint(params, cfg, init, warm_up_steps=30)
    argv = ["--do_train", "--do_valid", "--do_test", "-init", init, "-n", "8", "-b", "32",
            "-adv", "-lr", "0.01", "--max_steps", "60", "--log_steps", "20",
            "--valid_steps", "30", "--save_checkpoint_steps", "30", "--test_batch_size", "4",
            "--sampler_backend", backend]
    j_save, t_save = str(tmp_path / "jax"), str(tmp_path / "port")
    want = j_cli.main(argv + ["-save", j_save])
    got = t_cli.main(argv + ["-save", t_save, "--platform", "cpu"])

    assert len(_windows(t_save)) == 3
    np.testing.assert_allclose(_windows(t_save), _windows(j_save), rtol=0, atol=1e-4)
    for split in ("valid", "test"):
        for k in want[split]:
            assert abs(got[split][k] - want[split][k]) <= (
                0.05 * want[split][k] if k == "MR" else 1 / 32), (split, k)
    assert {"config.json", "checkpoint.npz", "entity_embedding.npy",
            "relation_embedding.npy", "train.log"} <= set(os.listdir(t_save))
    with open(os.path.join(t_save, "train.log")) as f:
        log = f.read()
    assert "Change learning_rate to 0.001000 at step 30" in log
    assert re.search(r"Training average triples_per_sec at step 59: [0-9.]+", log)
    again = t_cli.main(["--do_test", "-init", t_save, "--platform", "cpu"])
    assert again["test"] == got["test"]
    jck, tck = j_ckpt.load_checkpoint(j_save), t_ckpt.load_checkpoint(t_save, "cpu")
    assert (tck.step, tck.warm_up_steps, tck.adam_count) == (jck[2], jck[4], int(jck[1].count))
    assert tck.current_learning_rate == pytest.approx(jck[3], rel=1e-12)


# flags, and the loss windows' tolerance: f32 op-order noise over 60 steps
# (1e-4, as above); with bf16 scores the two packages round some terms of a
# score a bf16 ulp apart (tests/test_torch_precision.py), and the windows,
# means of 20 losses of about 1, agree to 2e-3 (measured: 2.3e-4 bf16,
# 3.3e-4 shared and bf16)
VARIANTS = {
    "shared": (["--negative_sharing", "batch"], 1e-4),
    "bf16": (["--precision", "bf16"], 2e-3),
    "shared-bf16": (["--negative_sharing", "batch", "--precision", "bf16"], 2e-3),
}


@pytest.mark.parametrize("variant", VARIANTS)
def test_do_train_variants_match_jax_cli(jax_run, tmp_path, variant):
    """``--negative_sharing batch`` and ``--precision bf16`` one step at a
    time on the numpy sampler, through both CLIs from one step-0 checkpoint
    (as test_do_train_matches_jax_cli): the loss windows agree within the
    variant's tolerance, and the port's ``-init`` rerun reproduces its Test
    metrics."""
    data_dir = jax_run[0]
    flags, atol = VARIANTS[variant]
    init = str(tmp_path / "init")
    cfg = TRunConfig(model="RotatE", double_entity_embedding=True, hidden_dim=8, gamma=4.0,
                     data_path=data_dir, learning_rate=0.01)
    tds = t_registry.load(data_dir)
    cfg.nentity, cfg.nrelation = tds.nentity, tds.nrelation
    params = t_kge.init_params(cfg.model_spec(), torch.Generator().manual_seed(3), device="cpu")
    t_ckpt.save_initial_checkpoint(params, cfg, init, warm_up_steps=30)
    argv = ["--do_train", "--do_test", "-init", init, "-n", "8", "-b", "32", "-adv", "-lr",
            "0.01", "--max_steps", "60", "--log_steps", "20", "--save_checkpoint_steps", "30",
            "--test_batch_size", "4", "--sampler_backend", "numpy", *flags]
    j_save, t_save = str(tmp_path / "jax"), str(tmp_path / "port")
    j_cli.main(argv + ["-save", j_save])
    got = t_cli.main(argv + ["-save", t_save, "--platform", "cpu"])
    assert len(_windows(t_save)) == 3
    np.testing.assert_allclose(_windows(t_save), _windows(j_save), rtol=0, atol=atol)
    again = t_cli.main(["--do_test", "-init", t_save, "--platform", "cpu"])
    assert again["test"] == got["test"]


MESH_RUNS = {
    "gspmd": ["--num_shards", "2", "--spmd_mode", "gspmd"],
    "shardmap": ["--num_shards", "2", "--spmd_mode", "shardmap"],
    "routed": ["--num_shards", "2", "--spmd_mode", "routed"],
    "2x2": ["--num_shards", "2", "--model_shards", "2"],
}


@pytest.mark.parametrize("run", MESH_RUNS)
def test_mesh_flags_match_jax_cli(jax_run, tmp_path, run):
    """The mesh flags through both CLIs from one step-0 checkpoint, on the
    numpy sampler: the port's gloo ranks and the JAX CLI's mesh of CPU
    devices log loss windows within 1e-4 (f32 op-order noise, as
    test_do_train_matches_jax_cli) and the same Test metrics, and the
    port's ``-init`` rerun on one device reproduces its own."""
    data_dir = jax_run[0]
    init = str(tmp_path / "init")
    cfg = TRunConfig(model="RotatE", double_entity_embedding=True, hidden_dim=8, gamma=4.0,
                     data_path=data_dir, learning_rate=0.01)
    tds = t_registry.load(data_dir)
    cfg.nentity, cfg.nrelation = tds.nentity, tds.nrelation
    params = t_kge.init_params(cfg.model_spec(), torch.Generator().manual_seed(3), device="cpu")
    t_ckpt.save_initial_checkpoint(params, cfg, init, warm_up_steps=10)
    argv = ["--do_train", "--do_test", "-init", init, "-n", "8", "-b", "32", "-adv", "-lr",
            "0.01", "--max_steps", "20", "--log_steps", "10", "--save_checkpoint_steps", "20",
            "--test_batch_size", "4", "--sampler_backend", "numpy", *MESH_RUNS[run]]
    j_save, t_save = str(tmp_path / "jax"), str(tmp_path / "port")
    want = j_cli.main(argv + ["-save", j_save])
    got = t_cli.main(argv + ["-save", t_save, "--platform", "cpu"])
    assert len(_windows(t_save)) == 2
    np.testing.assert_allclose(_windows(t_save), _windows(j_save), rtol=0, atol=1e-4)
    assert got["test"] == want["test"]
    with open(os.path.join(t_save, "train.log")) as f:
        log = f.read()
    assert "Change learning_rate to 0.001000 at step 10" in log
    assert "SPMD mesh: " in log
    again = t_cli.main(["--do_test", "-init", t_save, "--platform", "cpu"])
    assert again["test"] == got["test"]
