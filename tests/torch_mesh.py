"""Gloo worlds for the port's mesh tests (tests/test_torch_{sharding,shard_map,
routed,eval_sharded,mesh_fused,multihost}.py): ``world(fn, W, *args)``
spawns W ranks on the CPU, runs ``fn(rank, *args)`` in each after joining
the group, and returns every rank's result in rank order. The workers below
import torch, numpy and the port only (no JAX), so a rank starts in a few
seconds; the tests compute the JAX side in their own process."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from knowledgegraphembedding_torch.parallel import multihost


def _rank(local_rank, W, port, fn, args):
    torch.set_num_threads(1)
    multihost.initialize(f"127.0.0.1:{port}", 1, 0, local_rank=local_rank, ranks_per_process=W)
    try:
        out = fn(local_rank, *args)
        everyone = [None] * W
        dist.all_gather_object(everyone, out)
        return everyone
    finally:
        dist.destroy_process_group()


def world(fn, W: int, *args) -> list:
    """[fn(0, *args), ..., fn(W - 1, *args)], each run in a rank of a gloo
    world of W processes."""
    return multihost.launch(_rank, (W, multihost.free_port(), fn, args), W)


def batches(nentity: int, nrelation: int, B: int, n: int, steps: int, shared=False):
    """numpy batches (pos int32 [B, 3], neg int32 [B | 1, n], weight f32 [B],
    mode), head-batch first, from seeds 0, 1, ..."""
    out = []
    for i in range(steps):
        rng = np.random.default_rng(i)
        pos = np.stack([rng.integers(0, nentity, B), rng.integers(0, nrelation, B),
                        rng.integers(0, nentity, B)], 1).astype(np.int32)
        neg = rng.integers(0, nentity, (1 if shared else B, n)).astype(np.int32)
        w = rng.uniform(0.2, 1.0, B).astype(np.float32)
        out.append((pos, neg, w, "head-batch" if i % 2 == 0 else "tail-batch"))
    return out


def train_worker(rank, cases):
    """Per case ``(spec kwargs, tspec kwargs, init params (numpy), batches,
    spmd_mode, model_shards, shared)`` (``shared`` is the JAX trainer's
    flag; here the ``[1, n]`` rows say it): a ShardedTrainer's steps; returns
    per case (full params, full moments, per-step logs), all numpy."""
    from knowledgegraphembedding_torch.config import ModelSpec, TrainSpec
    from knowledgegraphembedding_torch.parallel import sharding

    out = []
    for spec_kw, tspec_kw, params, steps, mode, model_shards, _shared in cases:
        mesh = sharding.build_mesh(model_shards=model_shards)
        tr = sharding.ShardedTrainer(ModelSpec(**spec_kw), TrainSpec(**tspec_kw), params,
                                     lr=1e-2, warm_up_steps=10**9, mesh=mesh, spmd_mode=mode)
        logs = [{k: float(v) for k, v in tr.one_step(b).items()} for b in steps]
        p, st = tr.checkpoint_state()
        out.append((p, st.m, st.v, logs, tr.padded_rows))
    return out


def eval_worker(rank, cases):
    """Per case ``(spec kwargs, params (numpy), test triples, train, all true,
    model_shards, device_filter, test_batch_size)``: the sharded ranks."""
    from knowledgegraphembedding_torch.config import ModelSpec
    from knowledgegraphembedding_torch.data.filterset import FilterSets
    from knowledgegraphembedding_torch.parallel import eval_sharded, sharding

    out = []
    for spec_kw, params, test, train, all_true, model_shards, device_filter, tb in cases:
        spec = ModelSpec(**spec_kw)
        mesh = sharding.build_mesh(model_shards=model_shards)
        filters = FilterSets.build(train, all_true, spec.nentity, spec.nrelation)
        local = sharding.shard_params(sharding.pad_params(params, sharding.data_size(mesh)),
                                      spec, mesh)
        ranks = eval_sharded.sharded_split_ranks(local, spec, test, filters, mesh,
                                                 test_batch_size=tb, device_filter=device_filter)
        out.append(ranks)
    return out


def jax_train(spec_kw, tspec_kw, params, steps, mode, W, model_shards=1, shared=False):
    """The JAX package's ShardedTrainer on a mesh of the first W (x model)
    of the 8 CPU devices, fed the same init and batches: (params, m, v,
    logs), numpy, padding stripped. Runs in the test process (imports JAX)."""
    import jax.numpy as jnp

    from knowledgegraphembedding_tpu.config import ModelSpec, TrainSpec
    from knowledgegraphembedding_tpu.parallel import sharding

    mesh = sharding.build_mesh(W, model_shards=model_shards)
    tr = sharding.ShardedTrainer(ModelSpec(**spec_kw), TrainSpec(**tspec_kw),
                                 {k: jnp.asarray(v) for k, v in params.items()}, lr=1e-2,
                                 warm_up_steps=10**9, mesh=mesh, shared_negatives=shared,
                                 spmd_mode=mode)
    logs = [{k: float(v) for k, v in tr.one_step(b).items()} for b in steps]
    p, st = tr.checkpoint_state()
    return ({k: np.asarray(v) for k, v in p.items()}, {k: np.asarray(v) for k, v in st.m.items()},
            {k: np.asarray(v) for k, v in st.v.items()}, logs)


def init_params(spec_kw, seed: int = 3) -> dict:
    """Uniform(-range, range) tables (and pRotatE's modulus) from a numpy
    seed, for both packages."""
    from knowledgegraphembedding_torch.config import ModelSpec

    spec = ModelSpec(**spec_kw)
    rng = np.random.default_rng(seed)
    r = spec.embedding_range
    out = {"entity_embedding": rng.uniform(-r, r, (spec.nentity, spec.entity_dim)),
           "relation_embedding": rng.uniform(-r, r, (spec.nrelation, spec.relation_dim))}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    if spec.has_modulus:
        out["modulus"] = np.float32(0.5 * r)
    return out


def spec_kw(model: str, nentity: int, nrelation: int = 5, hidden_dim: int = 8,
            gamma: float = 6.0) -> dict:
    return dict(model_name=model, nentity=nentity, nrelation=nrelation, hidden_dim=hidden_dim,
                gamma=gamma, double_entity_embedding=model in ("RotatE", "ComplEx"),
                double_relation_embedding=model == "ComplEx")


def single_train(spec_kw, tspec_kw, params, steps):
    """The port's single-device Trainer on the CPU, fed the same init and
    batches: (params, m, v, logs), numpy."""
    from knowledgegraphembedding_torch.config import ModelSpec, TrainSpec
    from knowledgegraphembedding_torch.models import kge
    from knowledgegraphembedding_torch.train import Trainer

    tr = Trainer(ModelSpec(**spec_kw), TrainSpec(**tspec_kw), kge.params_from_numpy(params, "cpu"),
                 lr=1e-2, warm_up_steps=10**9)
    logs = []
    for pos, neg, w, mode in steps:
        lg = tr.one_step((torch.from_numpy(pos), torch.from_numpy(neg), torch.from_numpy(w), mode))
        logs.append({k: float(v) for k, v in lg.items()})
    st = tr.opt_state
    return ({k: v.detach().numpy() for k, v in tr.params.items()},
            {k: v.numpy() for k, v in st.m.items()}, {k: v.numpy() for k, v in st.v.items()},
            logs)


def collectives_worker(rank):
    """The gradients of the differentiable collectives: d/dx of the group
    sum of x^2 (x = rank + 1), and of sum(gathered rows * (rank + 1)) for
    this rank's two rows."""
    from knowledgegraphembedding_torch.ops.loss import all_reduce_sum
    from knowledgegraphembedding_torch.parallel.shard_map_step import all_gather_rows

    group = dist.group.WORLD
    x = torch.tensor(float(rank + 1), requires_grad=True)
    all_reduce_sum(x * x, group).backward()
    rows = torch.zeros(2, 3, requires_grad=True)
    gathered = all_gather_rows(rows, group)
    (gathered * (rank + 1)).sum().backward()
    return float(x.grad), rows.grad.numpy(), tuple(gathered.shape)


def fetch_rows_worker(rank, table, ids):
    """routed_step.fetch_rows of global ``ids`` from this rank's rows of
    ``table`` (numpy); returns (rows, fill)."""
    from knowledgegraphembedding_torch.parallel import routed_step

    W = dist.get_world_size()
    per = table.shape[0] // W
    local = torch.from_numpy(table[rank * per:(rank + 1) * per])
    rows, fill = routed_step.fetch_rows(
        local, torch.from_numpy(ids), n_shards=W,
        capacity=routed_step._capacity(len(ids), W), group=dist.group.WORLD, rank=rank)
    return rows.numpy(), int(fill)


# the CLI runs of overflow_worker: where the overflow surfaces
OVERFLOW_RUNS = {
    "poll": ["--log_steps", "100", "--save_checkpoint_steps", "100", "--max_steps", "30"],
    "save": ["--log_steps", "100", "--save_checkpoint_steps", "4", "--max_steps", "30"],
    "final": ["--log_steps", "100", "--save_checkpoint_steps", "100", "--max_steps", "12"],
}


def overflow_worker(rank, root):
    """The CLI's routed training with every bucket's capacity forced to 4
    rows: per run of OVERFLOW_RUNS the RuntimeError's message and the files
    in the save directory after it."""
    import os

    from knowledgegraphembedding_torch import cli
    from knowledgegraphembedding_torch.parallel import routed_step

    routed_step._capacity = lambda *a, **k: 4
    base = ["--do_train", "--data_path", "synthetic:clustered", "--model", "TransE", "-n", "8",
            "-b", "16", "-d", "8", "--platform", "cpu", "--num_shards", "2", "--spmd_mode",
            "routed"]
    out = {}
    for name, flags in OVERFLOW_RUNS.items():
        save = os.path.join(root, name)
        try:
            cli.main(base + flags + ["-save", save])
            out[name] = (None, sorted(os.listdir(save)))
        except RuntimeError as e:
            out[name] = (str(e), sorted(os.listdir(save)))
    return out


def _np(batch):
    return tuple(x.numpy() if isinstance(x, torch.Tensor) else x for x in batch)


def mesh_fused_worker(rank, sampler_args, chi_trains, fused_args):
    """The mesh device sampler and fused mesh blocks on this rank (eager on
    the CPU): (a) two runs of the tail-first mesh iterator, ``steps``
    batches each; (b) per mode the counts of one key's draws (64 x 4,096 a
    draw over the ranks, 4 draws); (c) a FusedMeshTrainer's block of k, k
    blocks of 1 from the same state, and the per-step shardmap trainer fed
    the block's batches: their gathered states, logs and recorded batches."""
    from knowledgegraphembedding_torch.config import ModelSpec, TrainSpec
    from knowledgegraphembedding_torch.fused_train import FusedMeshTrainer
    from knowledgegraphembedding_torch.parallel import sharding
    from knowledgegraphembedding_torch.sampler.device_sampler import (
        MeshDeviceSampler, build_mesh_device_iterator)

    mesh = sharding.build_mesh()
    train, E, R, B, n, seed, steps = sampler_args
    runs = []
    for _ in range(2):
        it = build_mesh_device_iterator(mesh, train, E, R, B, n, seed=seed, depth=1)
        runs.append([_np(next(it)) for _ in range(steps)])
    counts = {}
    for mode, chi_train in chi_trains.items():
        s = MeshDeviceSampler(chi_train, 40, 1, 64, 4096, mode, mesh, seed=11)
        idx = torch.zeros(s.batch_size, dtype=torch.int32)  # every row the same key
        counts[mode] = sum(np.bincount(s.sample(idx, torch.tensor(d))[1].numpy().ravel(),
                                       minlength=40) for d in range(1, 5))

    skw, tkw, p0, ftrain, fseed, k = fused_args
    spec, tspec = ModelSpec(**skw), TrainSpec(**tkw)

    def fused():
        return FusedMeshTrainer(spec, tspec, p0, lr=1e-2, warm_up_steps=10**9, train=ftrain,
                                mesh=mesh, seed=fseed, record_batches=True, block_capacity=k)

    def state(tr):
        p, st = tr.checkpoint_state()
        return p, st.m, st.v

    block = fused()
    block_logs = {key: float(v) for key, v in block.run_block(k).items()}
    recorded = [_np(b) for b in block.recorded()]
    singles = fused()
    single_logs, single_rec = [], []
    for _ in range(k):
        single_logs.append({key: float(v) for key, v in singles.run_block(1).items()})
        single_rec += [_np(b) for b in singles.recorded()]
    eager = sharding.ShardedTrainer(spec, tspec, p0, lr=1e-2, warm_up_steps=10**9, mesh=mesh,
                                    spmd_mode="shardmap")
    for pos, neg, w, mode in block.recorded():
        eager.one_step((pos.long(), neg.long(), w, mode))
    return runs, counts, {"block": (state(block), block_logs, recorded),
                          "singles": (state(singles), single_logs, single_rec),
                          "eager": (state(eager),)}


def restore_guard_worker(rank, skew):
    """verify_consistent_restore on (step, lr, warm-up), rank 1's step
    raised by ``skew``: the message each rank raised, or None."""
    from knowledgegraphembedding_torch.parallel import multihost as mh

    try:
        mh.verify_consistent_restore(100 + (skew if rank == 1 else 0), 1e-4, 500)
    except RuntimeError as e:
        return str(e)
    return None
