"""``python -m knowledgegraphembedding_torch.export_tables`` against the JAX
package's tools/export_tables.py: the same .npy tables, byte for byte, from
a single-file checkpoint, a 4-shard fleet the port wrote and a fleet a JAX
ShardedTrainer wrote; the export reads the two tables only, so a fleet
whose moment blocks are gone still exports."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from knowledgegraphembedding_torch import checkpoint as t_ckpt
from knowledgegraphembedding_torch import export_tables
from knowledgegraphembedding_torch.config import RunConfig as TRunConfig
from knowledgegraphembedding_torch.models import kge as t_kge
from knowledgegraphembedding_torch.train import Trainer
from knowledgegraphembedding_tpu import checkpoint as j_ckpt
from knowledgegraphembedding_tpu.config import ModelSpec as JSpec
from knowledgegraphembedding_tpu.config import RunConfig as JRunConfig
from knowledgegraphembedding_tpu.config import TrainSpec as JTrainSpec
from knowledgegraphembedding_tpu.models import kge as j_kge
from knowledgegraphembedding_tpu.parallel import sharding

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLES = ("entity_embedding.npy", "relation_embedding.npy")
CFG = dict(model="pRotatE", hidden_dim=6, gamma=5.0, nentity=41, nrelation=3,
           data_path="unused", do_train=True)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_export_tables", os.path.join(REPO_ROOT, "tools", "export_tables.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_trainer(seed=1):
    cfg = TRunConfig(**CFG)
    params = t_kge.init_params(cfg.model_spec(), torch.Generator().manual_seed(seed),
                               device="cpu")
    tr = Trainer(cfg.model_spec(), cfg.train_spec(), params, lr=0.01, warm_up_steps=5,
                 init_step=9)
    return tr, cfg


def _save(kind, path):
    """A checkpoint of ``kind`` in ``path``; returns the tables it holds."""
    if kind == "jax-fleet":
        spec = JSpec(model_name="RotatE", nentity=67, nrelation=5, hidden_dim=8, gamma=4.0,
                     double_entity_embedding=True)
        trainer = sharding.ShardedTrainer(spec, JTrainSpec(negative_sample_size=4,
                                                           batch_size=16),
                                          j_kge.init_params(spec, jax.random.PRNGKey(2)),
                                          lr=1e-2, warm_up_steps=10**9,
                                          mesh=sharding.build_mesh(8))
        j_ckpt.save_model_sharded(trainer, JRunConfig(do_train=True, data_path="unused",
                                                      model="RotatE", save_path=path), path)
        params, _ = trainer.checkpoint_state()
        return {k: np.asarray(params[k]) for k in ("entity_embedding", "relation_embedding")}
    tr, cfg = _port_trainer()
    if kind == "plain":
        t_ckpt.save_model(tr, cfg, path)
    else:
        for p in range(4):
            t_ckpt.save_model_sharded(tr, cfg, path, process_index=p, process_count=4)
    return {k: tr.params[k].detach().numpy() for k in ("entity_embedding", "relation_embedding")}


@pytest.mark.parametrize("kind", ["plain", "port-fleet", "jax-fleet"])
def test_export_equals_the_jax_tool(tmp_path, kind):
    save = str(tmp_path / "save")
    want = _save(kind, save)
    export_tables.main([save, "--out", str(tmp_path / "port")])
    _jax_tool().main([save, "--out", str(tmp_path / "jax")])
    for name in TABLES:
        got = np.load(tmp_path / "port" / name)
        np.testing.assert_array_equal(got, want[name[:-4]])
        with open(tmp_path / "port" / name, "rb") as a, open(tmp_path / "jax" / name, "rb") as b:
            assert a.read() == b.read(), name
    if kind == "plain":  # the save's own exports
        for name in TABLES:
            with open(tmp_path / "port" / name, "rb") as a, open(os.path.join(save, name),
                                                                 "rb") as b:
                assert a.read() == b.read(), name


def test_export_reads_the_tables_only(tmp_path):
    save = str(tmp_path / "save")
    want = _save("port-fleet", save)
    for p in range(4):
        shard = os.path.join(save, f"checkpoint.shard{p:05d}-of-00004.npz")
        with np.load(shard) as z:
            kept = {k: z[k] for k in z.files if not k.startswith("adam_")}
        np.savez(shard, **kept)
    with pytest.raises(RuntimeError, match="coverage"):
        t_ckpt.load_checkpoint(save, "cpu")  # the full load needs the moments
    export_tables.main([save])
    for name in TABLES:
        np.testing.assert_array_equal(np.load(os.path.join(save, name)), want[name[:-4]])


def test_module_entry_point(tmp_path):
    save = str(tmp_path / "save")
    want = _save("port-fleet", save)
    out = subprocess.run([sys.executable, "-m", "knowledgegraphembedding_torch.export_tables",
                          save], env=dict(os.environ, PYTHONPATH=REPO_ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "(41, 6) (step 9, sharded checkpoint)" in out.stdout
    np.testing.assert_array_equal(np.load(os.path.join(save, TABLES[0])),
                                  want["entity_embedding"])
