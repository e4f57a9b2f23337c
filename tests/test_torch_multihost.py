"""The fleet of the port (knowledgegraphembedding_torch/parallel/multihost.py
and the CLI's --multihost): two CLI processes on the CPU meet at one
coordinator address and train as one 2-rank gloo mesh; both report the same
Test metrics; only global rank 0 writes train.log, config.json and the meta
checkpoint, each rank its own shard file; one process restores the fleet's
sharded checkpoint with ``-init`` (restore_trainer_sharded) to the same
Test metrics. ``verify_consistent_restore`` raises on every rank when one
rank restored another step. The host partition and the multihost halves of
the host sampler (``index_subset``, ``shared_negative_seed``) equal the JAX
package's."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from knowledgegraphembedding_torch import cli as t_cli
from knowledgegraphembedding_torch.parallel import multihost as t_mh
from knowledgegraphembedding_torch.sampler import negative as t_neg
from knowledgegraphembedding_tpu.data.filterset import FilterSets
from knowledgegraphembedding_tpu.data.synthetic import make_random_kg
from knowledgegraphembedding_tpu.sampler import negative as j_neg

import torch_mesh

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--do_train", "--do_test", "--data_path", "synthetic:clustered", "--model", "RotatE",
         "-de", "-n", "8", "-b", "16", "-d", "8", "-g", "4.0", "-adv", "-lr", "0.01",
         "--max_steps", "12", "--log_steps", "6", "--save_checkpoint_steps", "6",
         "--test_batch_size", "8", "--platform", "cpu", "--spmd_mode", "shardmap",
         "--sharded_checkpoint", "--negative_sharing", "batch"]


def _mrr(out):
    found = re.findall(r"Test MRR at step (\d+): ([0-9.]+)", out)
    assert found, out[-3000:]
    return found[-1]


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """(outputs of processes 0 and 1, save dir): a two-process fleet, one
    rank each, timed out at 120 s (it takes seconds)."""
    save = str(tmp_path_factory.mktemp("fleet") / "save")
    port = str(t_mh.free_port())
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "knowledgegraphembedding_torch.cli", *FLAGS, "-save", save,
         "--multihost", "--coordinator_address", f"127.0.0.1:{port}", "--num_processes", "2",
         "--process_id", str(pid)], env=env, cwd=REPO_ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs, save


def test_fleet_forms_one_mesh(fleet):
    outs, _ = fleet
    for pid, out in enumerate(outs):
        assert "SPMD mesh: 2 devices on axis 'data'" in out
        assert f"multihost: process {pid}/2, 1 local devices" in out


def test_both_processes_report_the_same_test(fleet):
    outs, _ = fleet
    assert _mrr(outs[0]) == _mrr(outs[1])
    assert _mrr(outs[0])[0] == "12"


def test_artifacts_come_from_rank_0_only(fleet):
    _, save = fleet
    assert sorted(os.listdir(save)) == [
        "checkpoint.npz", "checkpoint.shard00000-of-00002.npz",
        "checkpoint.shard00001-of-00002.npz", "config.json", "train.log"]
    with open(os.path.join(save, "train.log")) as f:
        log = f.read()
    assert "multihost: process 0/2" in log and "process 1/2" not in log
    assert len(re.findall(r"Test MRR", log)) == 1


def test_one_process_restores_the_fleet_checkpoint(fleet):
    outs, save = fleet
    got = t_cli.main(["--do_test", "-init", save, "--platform", "cpu"])
    assert "%f" % got["test"]["MRR"] == _mrr(outs[0])[1]


def test_torchrun_environment_restores_the_fleet_on_a_mesh(fleet):
    """Two processes with torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT) join one group in-process and run ``-init``
    from the fleet's shard files on a 2-rank mesh (restore_trainer_sharded,
    the consistency guard, the sharded eval): the fleet's Test metrics."""
    outs, save = fleet
    port = str(t_mh.free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-m", "knowledgegraphembedding_torch.cli", "--do_test", "-init", save,
         "--num_shards", "2", "--platform", "cpu"],
        env=dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="1", RANK=str(r),
                 WORLD_SIZE="2", LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=port), cwd=REPO_ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    try:
        got = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, got):
        assert p.returncode == 0, out[-4000:]
    assert "SPMD mesh: 2 devices on axis 'data'" in got[0]
    assert _mrr(got[0]) == _mrr(outs[0])


@pytest.fixture(scope="module")
def guard():
    return {skew: torch_mesh.world(torch_mesh.restore_guard_worker, 2, skew) for skew in (0, 1)}


def test_consistent_restore_passes(guard):
    assert guard[0] == [None, None]


def test_mismatched_restore_raises_on_every_rank(guard):
    for msg in guard[1]:
        assert msg.startswith("inconsistent restore across hosts"), msg
        assert "[101.0" in msg  # the fleet's rows, rank 1's step among them


@pytest.mark.parametrize("host,hosts", [(0, 1), (0, 3), (2, 3)])
def test_host_partition_matches_jax(host, hosts, monkeypatch):
    monkeypatch.setattr(t_mh, "_host", [host, hosts, 1])
    assert np.array_equal(t_mh.host_shard_of_indices(10), np.arange(10)[host::hosts])
    tr = np.arange(30).reshape(10, 3)
    assert np.array_equal(t_mh.host_shard_of_triples(tr), tr[host::hosts])
    if 12 % hosts == 0:
        assert t_mh.host_batch_size(12) == 12 // hosts
    with pytest.raises(ValueError, match=f"global batch 13 not divisible by {hosts} hosts"):
        if hosts == 1:
            raise ValueError("global batch 13 not divisible by 1 hosts")
        t_mh.host_batch_size(13)


@pytest.mark.parametrize("sharing", ["none", "batch"])
def test_host_stream_of_a_fleet_host_matches_jax(sharing):
    """A host's edge partition and the host-independent shared-negative seed
    (the CLI's ``seed + 10_000_019``): the same batches as JAX's sampler."""
    ds = make_random_kg(nentity=41, nrelation=4, ntriples=300, n_valid=5, n_test=5, seed=2)
    subset = np.arange(len(ds.train))[1::2]
    kw = dict(seed=3 + 7919, prefetch_depth=0, backend="numpy", negative_sharing=sharing,
              index_subset=subset, shared_negative_seed=3 + 10_000_019)
    filters = FilterSets.build(ds.train, ds.all_true_triples, ds.nentity, ds.nrelation)
    want = j_neg.build_train_iterator(ds.train, ds.nentity, ds.nrelation, 8, 4, filters, **kw)
    got = t_neg.build_train_iterator(ds.train, ds.nentity, ds.nrelation, 8, 4, **kw)
    for _ in range(6):
        a, b = next(want), next(got)
        assert a[3] == b[3]
        for x, y in zip(a[:3], b[:3]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
