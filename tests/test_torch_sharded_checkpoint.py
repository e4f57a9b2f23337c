"""Sharded checkpoints of the port (knowledgegraphembedding_torch/checkpoint.py)
against the JAX package's: a JAX ShardedTrainer's shard files (8-device CPU
mesh, padded entity rows) load in the port with JAX's arrays, padding
stripped; shard files the port writes for JAX's blocks equal JAX's files
member for member; a 4-shard fleet written by the port loads in JAX; the
mixed-step and missing-block guards raise in both packages; the port's
block catalog fills slices as JAX's does; an async sharded save equals a
sync one after in-place steps; and two gloo processes each write their own
shard file."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from knowledgegraphembedding_torch import checkpoint as t_ckpt
from knowledgegraphembedding_torch.config import ModelSpec as TSpec
from knowledgegraphembedding_torch.config import RunConfig as TRunConfig
from knowledgegraphembedding_torch.config import TrainSpec as TTrainSpec
from knowledgegraphembedding_torch.train import Trainer
from knowledgegraphembedding_tpu import checkpoint as j_ckpt
from knowledgegraphembedding_tpu.config import ModelSpec as JSpec
from knowledgegraphembedding_tpu.config import RunConfig as JRunConfig
from knowledgegraphembedding_tpu.config import TrainSpec as JTrainSpec
from knowledgegraphembedding_tpu.models import kge as j_kge
from knowledgegraphembedding_tpu.parallel import sharding

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, R = 67, 5  # 67 % 8 != 0: the JAX mesh pads the entity rows to 72
SPEC = dict(model_name="RotatE", nentity=E, nrelation=R, hidden_dim=8, gamma=4.0,
            double_entity_embedding=True)
TSPEC = dict(negative_sample_size=4, batch_size=16, negative_adversarial_sampling=True)
KEYS = ("param.entity_embedding", "adam_m.entity_embedding", "adam_v.entity_embedding")


def _batch(rng):
    pos = np.stack([rng.integers(0, E, 16), rng.integers(0, R, 16),
                    rng.integers(0, E, 16)], 1).astype(np.int32)
    return pos, rng.integers(0, E, (16, 4)).astype(np.int32), \
        rng.uniform(0.2, 1.0, 16).astype(np.float32), "tail-batch"


@pytest.fixture(scope="module", params=[1, 2], ids=["mesh8x1", "mesh4x2"])
def jax_fleet(request, tmp_path_factory):
    """A JAX ShardedTrainer after 3 steps and its shard files."""
    mesh = sharding.build_mesh(8 // request.param, model_shards=request.param)
    spec = JSpec(**SPEC)
    trainer = sharding.ShardedTrainer(spec, JTrainSpec(**TSPEC),
                                      j_kge.init_params(spec, jax.random.PRNGKey(0)),
                                      lr=1e-2, warm_up_steps=10**9, mesh=mesh)
    rng = np.random.default_rng(0)
    for _ in range(3):
        trainer.one_step(_batch(rng))
    path = str(tmp_path_factory.mktemp("jax_fleet"))
    j_ckpt.save_model_sharded(trainer, JRunConfig(do_train=True, data_path="unused",
                                                  model="RotatE", save_path=path), path)
    return trainer, path


def _port_trainer(jtrainer):
    """A port Trainer holding the JAX trainer's gathered state."""
    params, opt = jtrainer.checkpoint_state()
    return Trainer.from_jax_state(TSpec(**SPEC), TTrainSpec(**TSPEC),
                                  {k: np.asarray(params[k]) for k in jtrainer.params},
                                  opt, jtrainer.step, jtrainer.current_learning_rate,
                                  jtrainer.warm_up_steps, "cpu")


def _config(path):
    return TRunConfig(do_train=True, data_path="unused", model="RotatE", save_path=path)


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_jax_fleet_loads_in_port_with_jax_arrays(jax_fleet):
    jtrainer, path = jax_fleet
    assert t_ckpt.is_sharded_checkpoint(path)
    params, state, step, lr, warm_up = j_ckpt.load_checkpoint(path)
    ck = t_ckpt.load_checkpoint(path, "cpu")
    assert (ck.step, ck.current_learning_rate, ck.warm_up_steps, ck.adam_count) == (
        step, lr, warm_up, int(state.count)) == (3, 1e-2, 10**9, 3)
    assert ck.params["entity_embedding"].shape == (E, 16)  # padding rows stripped
    for k in params:
        np.testing.assert_array_equal(ck.params[k].numpy(), np.asarray(params[k]), err_msg=k)
        np.testing.assert_array_equal(ck.adam_m[k], np.asarray(state.m[k]), err_msg=k)
        np.testing.assert_array_equal(ck.adam_v[k], np.asarray(state.v[k]), err_msg=k)
    # and into a port trainer, equal to the JAX trainer's gathered state
    tr = t_ckpt.restore_trainer(Trainer(TSpec(**SPEC), TTrainSpec(**TSPEC),
                                        {k: torch.zeros(v.shape) for k, v in ck.params.items()},
                                        lr=0.5, warm_up_steps=1), path)
    ref, ref_opt = jtrainer.checkpoint_state()
    assert (tr.step, tr.opt_state.count) == (3, 3)
    for k in ref:
        np.testing.assert_array_equal(tr.params[k].detach().numpy(), ref[k], err_msg=k)
        np.testing.assert_array_equal(tr.opt_state.m[k].numpy(), ref_opt.m[k], err_msg=k)


@pytest.mark.parametrize("jax_fleet", [1], ids=["mesh8x1"], indirect=True)
def test_port_writes_jax_files_for_jax_blocks(jax_fleet, tmp_path):
    """The port's writer given the JAX mesh's own row blocks (eight blocks
    of 9 padded rows) writes JAX's two files, member for member: keys in
    order, dtypes, shapes and bytes. (A 2-D mesh numbers its blocks with
    gaps where it skips replicas, which the port's consecutive numbering
    does not copy; the loaders read both.)"""
    jtrainer, path = jax_fleet
    blocks = {}
    for prefix, tree in (("param", jtrainer.params), ("adam_m", jtrainer.opt_state.m),
                         ("adam_v", jtrainer.opt_state.v)):
        val = tree["entity_embedding"]
        full = torch.from_numpy(np.array(val))
        pairs = []
        for sh in val.addressable_shards:
            b = t_ckpt._index_bounds(sh.index, val.shape)
            pairs.append((full[b[0]:b[1], b[2]:b[3]], b))
        blocks[f"{prefix}.entity_embedding"] = (val.shape, pairs)
    t_ckpt.save_model_sharded(_port_trainer(jtrainer), _config(str(tmp_path)), str(tmp_path),
                              blocks=blocks)
    names = ["checkpoint.npz", "checkpoint.shard00000-of-00001.npz"]
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".npz")) == names
    for name in names:
        want, got = _npz(os.path.join(path, name)), _npz(str(tmp_path / name))
        assert list(got) == list(want), name
        for k in want:
            assert (got[k].dtype, got[k].shape) == (want[k].dtype, want[k].shape), (name, k)
            assert got[k].tobytes() == want[k].tobytes(), (name, k)


def _write_port_fleet(trainer, path, n=4):
    for p in range(n):  # one process after another; odd ones asynchronously
        t_ckpt.save_model_sharded(trainer, _config(path), path, asynchronous=p % 2 == 1,
                                  process_index=p, process_count=n)
    t_ckpt.wait_for_pending_save()


def test_port_fleet_loads_in_jax(jax_fleet, tmp_path):
    jtrainer, _ = jax_fleet
    tr = _port_trainer(jtrainer)
    _write_port_fleet(tr, str(tmp_path))
    files = sorted(os.listdir(tmp_path))
    assert files == ["checkpoint.npz"] + [f"checkpoint.shard{p:05d}-of-00004.npz"
                                          for p in range(4)] + ["config.json"]
    meta = _npz(str(tmp_path / "checkpoint.npz"))
    assert int(meta["sharded_shards"]) == 4 and int(meta["nentity"]) == E
    assert not any(k.startswith("param.entity") for k in meta)  # no table rows in the meta
    assert meta["shape:param.entity_embedding"].tolist() == [E, 16]
    for p in range(4):
        local = _npz(str(tmp_path / files[p + 1]))
        assert list(local) == ["step"] + [f"{k}:{m}0" for k in KEYS for m in ("block", "index")]
        r0, r1 = 17 * p, min(17 * (p + 1), E)
        assert local["param.entity_embedding:index0"].tolist() == [r0, r1, 0, 16]
        assert local["param.entity_embedding:index0"].dtype == np.int64
    params, state, step, lr, warm_up = j_ckpt.load_checkpoint(str(tmp_path))
    assert (step, lr, warm_up, int(state.count)) == (tr.step, tr.current_learning_rate,
                                                     tr.warm_up_steps, tr.opt_state.count)
    for k in tr.params:
        np.testing.assert_array_equal(np.asarray(params[k]), tr.params[k].detach().numpy())
        np.testing.assert_array_equal(np.asarray(state.m[k]), tr.opt_state.m[k].numpy())
        np.testing.assert_array_equal(np.asarray(state.v[k]), tr.opt_state.v[k].numpy())


def _fleet(writer, jax_fleet, tmp_path):
    """(directory, name of its first shard file) of a fleet written by
    ``writer`` into tmp_path."""
    jtrainer, _ = jax_fleet
    path = str(tmp_path)
    if writer == "port":
        _write_port_fleet(_port_trainer(jtrainer), path)
        return path, "checkpoint.shard00001-of-00004.npz"
    j_ckpt.save_model_sharded(jtrainer, JRunConfig(do_train=True, data_path="unused",
                                                   model="RotatE", save_path=path), path)
    return path, "checkpoint.shard00000-of-00001.npz"


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_mixed_step_raises(jax_fleet, tmp_path, writer):
    path, shard = _fleet(writer, jax_fleet, tmp_path)
    z = _npz(os.path.join(path, shard))
    z["step"] = np.int64(int(z["step"]) - 1)  # a shard file of the save before
    np.savez(os.path.join(path, shard), **z)
    for load in (lambda: t_ckpt.load_checkpoint(path, "cpu"),
                 lambda: j_ckpt.load_checkpoint(path)):
        with pytest.raises(RuntimeError, match="inconsistent"):
            load()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_missing_block_raises(jax_fleet, tmp_path, writer):
    path, shard = _fleet(writer, jax_fleet, tmp_path)
    z = _npz(os.path.join(path, shard))
    gone = [k for k in z if k.startswith("adam_v.entity_embedding:block")][:1]
    assert gone
    del z[gone[0]]
    np.savez(os.path.join(path, shard), **z)
    for load in (lambda: t_ckpt.load_checkpoint(path, "cpu"),
                 lambda: j_ckpt.load_checkpoint(path)):
        with pytest.raises(RuntimeError, match="coverage"):
            load()


@pytest.mark.parametrize("rows,cols", [((0, 9), (None, None)), ((5, 30), (None, None)),
                                       ((60, 72), (3, 11)), ((None, None), (None, None)),
                                       ((66, 80), (0, 16))],
                         ids=["one-block", "across-blocks", "padding-rows", "all",
                              "past-the-saved-rows"])
def test_block_catalog_fills_slices_as_jax(jax_fleet, rows, cols):
    jtrainer, path = jax_fleet
    with np.load(os.path.join(path, "checkpoint.npz")) as meta:
        n, step = int(meta["sharded_shards"]), int(meta["step"])
        shapes = {k[len("shape:"):]: tuple(int(x) for x in meta[k])
                  for k in meta.files if k.startswith("shape:")}
    jcat = j_ckpt._BlockCatalog(path, n, step)
    with t_ckpt._BlockCatalog(path, n, step) as tcat:
        for key, shape in shapes.items():
            tcat.validate_coverage(key, shape)
            out_shape = (max(shape[0], 80), shape[1])
            idx = (slice(*rows), slice(*cols))
            want = jcat.fill_slice(key, idx, out_shape, np.float32)
            got = tcat.fill_slice(key, idx, out_shape, np.float32)
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), key
            if (rows[0] or 0) < shape[0]:  # the blocks' own dtype
                assert tcat.fill_slice(key, idx, out_shape).tobytes() == want.tobytes(), key
            else:
                with pytest.raises(ValueError, match="no saved block"):
                    tcat.fill_slice(key, idx, out_shape)
        with pytest.raises(RuntimeError, match="coverage"):
            tcat.validate_coverage(KEYS[0], (shapes[KEYS[0]][0] + 1, shapes[KEYS[0]][1]))


def test_async_sharded_save_equals_sync_after_in_place_steps(jax_fleet, tmp_path):
    jtrainer, _ = jax_fleet
    tr = _port_trainer(jtrainer)
    sync, asyn = str(tmp_path / "sync"), str(tmp_path / "async")
    for p in range(2):
        t_ckpt.save_model_sharded(tr, _config(sync), sync, process_index=p, process_count=2)
    t_ckpt.save_model_sharded(tr, _config(asyn), asyn, asynchronous=True, process_index=0,
                              process_count=2)
    rng = np.random.default_rng(5)
    before = tr.params["entity_embedding"].detach().clone()
    tr.one_step(tuple(torch.from_numpy(x) for x in _batch(rng)[:3]) + ("tail-batch",))
    assert not torch.equal(before, tr.params["entity_embedding"])
    t_ckpt.wait_for_pending_save()
    for name in ("checkpoint.npz", "checkpoint.shard00000-of-00002.npz"):
        want, got = _npz(os.path.join(sync, name)), _npz(os.path.join(asyn, name))
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()


def test_process_layout_defaults_and_overrides():
    assert t_ckpt.process_layout() == (0, 1)
    assert t_ckpt.process_layout(2, 4) == (2, 4)
    assert t_ckpt.process_layout(process_count=3) == (0, 3)
    assert not t_ckpt.is_sharded_checkpoint(os.path.dirname(__file__))


GLOO_RANK = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from knowledgegraphembedding_torch import checkpoint as ckpt
from knowledgegraphembedding_torch.config import ModelSpec, RunConfig, TrainSpec
from knowledgegraphembedding_torch.models import kge
from knowledgegraphembedding_torch.train import Trainer

rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2, rank=rank)
spec = ModelSpec(model_name="RotatE", nentity=67, nrelation=5, hidden_dim=8, gamma=4.0,
                 double_entity_embedding=True)
params = kge.init_params(spec, torch.Generator().manual_seed(3), device="cpu")
trainer = Trainer(spec, TrainSpec(negative_sample_size=4, batch_size=16), params, lr=0.01,
                  warm_up_steps=10**9, init_step=7)
ckpt.save_model_sharded(trainer, RunConfig(model="RotatE", save_path=path), path,
                        asynchronous=rank == 1)
ckpt.wait_for_pending_save()
dist.barrier()
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_write_their_own_shard(tmp_path):
    """Rank and world size come from the initialized process group: rank
    r writes shard r of 2, rank 0 the meta npz; one process reassembles."""
    port, path = str(_free_port()), str(tmp_path / "fleet")
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", GLOO_RANK, str(r), port, path], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert sorted(f for f in os.listdir(path) if f.startswith("checkpoint")) == [
        "checkpoint.npz", "checkpoint.shard00000-of-00002.npz",
        "checkpoint.shard00001-of-00002.npz"]
    spec = TSpec(**SPEC)
    from knowledgegraphembedding_torch.models import kge as t_kge
    want = t_kge.init_params(spec, torch.Generator().manual_seed(3), device="cpu")
    ck = t_ckpt.load_checkpoint(path, "cpu")
    assert ck.step == 7 and ck.adam_count == 0
    for k in want:
        assert torch.equal(ck.params[k], want[k]), k
        assert not ck.adam_m[k].any() and not ck.adam_v[k].any()
    for r, rows in enumerate(((0, 34), (34, 67))):
        with np.load(os.path.join(path, f"checkpoint.shard{r:05d}-of-00002.npz")) as z:
            assert z["param.entity_embedding:index0"].tolist() == [*rows, 0, 16]
