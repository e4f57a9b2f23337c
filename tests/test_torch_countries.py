"""``--countries`` in the port: AUC-PR over the region candidates
(codes/model.py §test_step's countries branch) against the JAX package.

Tolerances: ``average_precision`` equal to JAX's to 1e-12 (the same float64
sweep); ``countries_auc_pr`` on the same params to 1e-6 (f32 scores that
may differ in the last bits between the two packages; a rank swap of two
candidates would move the AP by far more than that); the CLIs' ``auc_pr``
from one step-0 checkpoint to 1e-6, and after 20 training steps from it to
1e-4 (f32 op-order noise in the steps)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from knowledgegraphembedding_torch import checkpoint as t_ckpt
from knowledgegraphembedding_torch import cli as t_cli
from knowledgegraphembedding_torch import eval as t_eval
from knowledgegraphembedding_torch.config import RunConfig as TRunConfig
from knowledgegraphembedding_torch.data import registry as t_registry
from knowledgegraphembedding_torch.models import kge as t_kge
from knowledgegraphembedding_tpu import cli as j_cli
from knowledgegraphembedding_tpu import eval as j_eval
from knowledgegraphembedding_tpu.config import ModelSpec as JSpec

DATA = "synthetic:countries_S1"


@pytest.mark.parametrize("seed", range(4))
def test_average_precision_equals_jax(seed):
    """Random labels over scores with many ties (values on a coarse grid),
    and the all-negative case."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, 200)
    s = rng.integers(0, 12, 200).astype(np.float32) / 4
    want = j_eval.average_precision(y, s)
    assert t_eval.average_precision(y, s) == pytest.approx(want, rel=1e-12, abs=1e-12)
    assert t_eval.average_precision(np.zeros(5, np.int64), s[:5]) == 0.0


def test_average_precision_by_hand():
    """Scores 3, 2, 2, 1 with labels 1, 0, 1, 0: the tie at 2 counts once,
    at its last index: AP = 1/2 * 1 + 1/2 * 2/3."""
    got = t_eval.average_precision(np.array([1, 0, 1, 0]), np.array([3.0, 2.0, 2.0, 1.0]))
    assert got == pytest.approx(0.5 + 0.5 * 2 / 3, rel=1e-15)


@pytest.mark.parametrize("model,de", [("RotatE", True), ("TransE", False)])
def test_countries_auc_pr_equals_jax(model, de):
    ds = t_registry.load(DATA, countries=True)
    cfg = TRunConfig(model=model, double_entity_embedding=de, hidden_dim=16, gamma=6.0,
                     nentity=ds.nentity, nrelation=ds.nrelation)
    spec = cfg.model_spec()
    params = t_kge.init_params(spec, torch.Generator().manual_seed(2), device="cpu")
    jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    want = j_eval.countries_auc_pr(jparams, JSpec(**vars(spec)), ds.test, ds.regions)
    got = t_eval.countries_auc_pr(params, spec, ds.test, ds.regions, batch_size=100)
    assert 0 < got <= 1
    assert got == pytest.approx(want, abs=1e-6)


@pytest.fixture(scope="module")
def init(tmp_path_factory):
    """A step-0 RotatE checkpoint on synthetic:countries_S1."""
    path = str(tmp_path_factory.mktemp("countries") / "init")
    ds = t_registry.load(DATA, countries=True)
    cfg = TRunConfig(model="RotatE", double_entity_embedding=True, hidden_dim=8, gamma=4.0,
                     data_path=DATA, countries=True, learning_rate=0.01,
                     nentity=ds.nentity, nrelation=ds.nrelation)
    params = t_kge.init_params(cfg.model_spec(), torch.Generator().manual_seed(1), device="cpu")
    t_ckpt.save_initial_checkpoint(params, cfg, path, warm_up_steps=10)
    return path


@pytest.mark.parametrize("mesh", [[], ["--num_shards", "2"]], ids=["one-device", "mesh"])
def test_do_test_auc_pr_matches_jax_cli(init, mesh):
    """From the step-0 checkpoint; with ``--num_shards 2`` the port's two
    gloo ranks score the gathered tables (JAX's mesh: its host_params)."""
    argv = ["--do_valid", "--do_test", "--countries", "-init", init, *mesh]
    want = j_cli.main(argv)
    got = t_cli.main(argv + ["--platform", "cpu"])
    assert set(got) == {"valid", "test"} and set(got["test"]) == {"auc_pr"}
    for split in got:
        assert got[split]["auc_pr"] == pytest.approx(want[split]["auc_pr"], abs=1e-6)


def test_train_then_test_auc_pr_matches_jax_cli(init, tmp_path):
    """20 steps through both CLIs from the checkpoint, Valid at step 9 and
    at the end, Test: the same AUC-PR, and the port's log carries it."""
    argv = ["--do_train", "--do_valid", "--do_test", "--countries", "-init", init, "-n", "4",
            "-b", "16", "-adv", "-lr", "0.01", "--max_steps", "20", "--log_steps", "10",
            "--valid_steps", "10", "--sampler_backend", "numpy"]
    want = j_cli.main(argv + ["-save", str(tmp_path / "jax")])
    got = t_cli.main(argv + ["-save", str(tmp_path / "port"), "--platform", "cpu"])
    for split in ("valid", "test"):
        assert got[split]["auc_pr"] == pytest.approx(want[split]["auc_pr"], abs=1e-4)
    with open(tmp_path / "port" / "train.log") as f:
        log = f.read()
    assert "Valid auc_pr at step 9:" in log and "Test auc_pr at step 20:" in log
