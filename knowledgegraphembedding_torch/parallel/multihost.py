"""The fleet: one process per device on ``torch.distributed``, its bring-up,
and the edge-partitioned train stream.

Counterpart of ``knowledgegraphembedding_tpu/parallel/multihost.py``. JAX
runs one process per host, which drives every local chip. Here every rank
is a process of its own that owns one device: ``cuda:{local_rank}`` over
NCCL, or the CPU over gloo. A *host* is one launch of the CLI; it starts its
local ranks with ``launch`` (``torch.multiprocessing``, spawn), and the
ranks of every host meet at one TCP store:

  - ``--num_shards N`` alone: one host of N ranks, its store on a free
    loopback port;
  - ``--multihost --coordinator_address A --num_processes P --process_id
    i``: P hosts, each of ``local`` ranks; host i's local rank l is global
    rank ``i * local + l``, and the store listens at A on host 0.

``process_index``/``process_count`` are the host's index and the number of
hosts (JAX's ``jax.process_index``/``process_count``), ``(0, 1)`` until
``initialize`` sets them. The train stream is edge-partitioned by host
(``host_shard_of_indices``); within a host each rank takes its rows of the
host's batch (``global_batch``).
"""

from __future__ import annotations

import datetime
import os
import socket
import traceback
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

#: seconds a rank waits for the fleet to form, and for a collective
TIMEOUT_S = 600

# the flat collectives (output = the ranks' inputs end to end): named
# *_single since torch 2.12, *_tensor before
all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
reduce_scatter_flat = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

# (host index, host count, ranks per host), set by initialize
_host = [0, 1, 1]


def process_index() -> int:
    """This host's index among the hosts of the fleet."""
    return _host[0]


def process_count() -> int:
    """The number of hosts (CLI launches) in the fleet."""
    return _host[1]


def local_ranks() -> int:
    """Ranks (devices) per host."""
    return _host[2]


def backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, require: bool = False, *,
               local_rank: int = 0, ranks_per_process: int = 1,
               device_type: str = "cpu") -> None:
    """Join the fleet: the default process group of ``num_processes *
    ranks_per_process`` ranks, this one ``process_id * ranks_per_process +
    local_rank``, meeting at ``tcp://coordinator_address``. On CUDA the
    rank owns ``cuda:{local_rank}`` and the NCCL communicator is created
    here, not at the first collective. Without an address the torchrun
    environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``) is used when it
    is set; ``require`` (an explicit ``--multihost``) raises when there is
    neither, so a fleet never degrades to independent processes that would
    each believe they are process 0. A fleet that cannot form raises after
    ``TIMEOUT_S``. No-op when the group exists."""
    if dist.is_initialized():
        return
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if coordinator_address is None and num_processes is None:
        env = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
        if not all(k in os.environ for k in env):
            if require:
                raise ValueError(  # begins as jax.distributed.initialize's
                    "coordinator_address should be defined. --multihost needs "
                    "--coordinator_address, --num_processes and "
                    "--process_id, or a torchrun environment (RANK, WORLD_SIZE, "
                    "MASTER_ADDR, MASTER_PORT)")
            return
        local = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
        rank = int(os.environ["RANK"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank % local))
        _bind(device_type, local_rank)
        dist.init_process_group(backend(device_type), init_method="env://", timeout=timeout,
                                **_device_id(device_type, local_rank))
        _host[:] = [rank // local, int(os.environ["WORLD_SIZE"]) // local, local]
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a fleet needs --coordinator_address, --num_processes and "
                         "--process_id together")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process_id {process_id} outside 0..{num_processes - 1}")
    _bind(device_type, local_rank)
    dist.init_process_group(
        backend(device_type), init_method=f"tcp://{coordinator_address}",
        world_size=num_processes * ranks_per_process,
        rank=process_id * ranks_per_process + local_rank, timeout=timeout,
        **_device_id(device_type, local_rank))
    _host[:] = [process_id, num_processes, ranks_per_process]


def _bind(device_type: str, local_rank: int) -> None:
    if device_type == "cuda":
        torch.cuda.set_device(local_rank)


def _device_id(device_type: str, local_rank: int) -> dict:
    return {"device_id": torch.device("cuda", local_rank)} if device_type == "cuda" else {}


def _rank_entry(local_rank: int, fn, args, results) -> None:
    """A spawned rank: ``fn(local_rank, *args)``. Local rank 0 sends its
    result home; a failure is sent as the exception and raised again, so
    the launcher stops the other ranks."""
    try:
        out = fn(local_rank, *args)
    except BaseException as e:
        try:
            results.put(("error", local_rank, e, traceback.format_exc()))
        except Exception:  # an exception that does not pickle
            results.put(("error", local_rank, None, traceback.format_exc()))
        raise
    if local_rank == 0:
        results.put(("ok", 0, out, ""))


def launch(fn, args: Tuple, n_ranks: int):
    """Run ``fn(local_rank, *args)`` in ``n_ranks`` spawned processes and
    return local rank 0's result. If a rank fails, the others are stopped
    and its exception is raised here (its traceback chained)."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    results = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(_rank_entry, args=(fn, args, results), nprocs=n_ranks,
                             join=False, start_method="spawn")
    got = []

    def drain():  # read while the ranks run: a result larger than the pipe blocks its writer
        while not results.empty():
            got.append(results.get())

    try:
        while not ctx.join(timeout=0.05):
            drain()
    except ProcessException as failure:
        drain()
        for kind, rank, exc, tb in got:
            if kind == "error":
                if exc is None:
                    raise RuntimeError(f"rank {rank} failed:\n{tb}") from failure
                raise exc from RuntimeError(f"rank {rank} failed:\n{tb}")
        raise
    drain()
    for kind, _, out, _ in got:
        if kind == "ok":
            return out
    raise RuntimeError("local rank 0 returned no result")


def host_shard_of_indices(n: int) -> np.ndarray:
    """Row indices of THIS host's edge-partition shard: k, k+P, k+2P, ...
    (round-robin keeps relation and entity marginals even)."""
    return np.arange(n)[process_index()::process_count()]


def host_shard_of_triples(triples: np.ndarray) -> np.ndarray:
    """Edge-partition the training stream (see host_shard_of_indices)."""
    return triples[host_shard_of_indices(len(triples))]


def host_batch_size(global_batch_size: int) -> int:
    n = process_count()
    if global_batch_size % n != 0:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} hosts")
    return global_batch_size // n


def local_rows(mesh, global_batch_size: int) -> slice:
    """This rank's rows of its host's batch: the global batch splits into
    one contiguous block of ``B / data`` rows per data index, hosts in
    order, each host holding whole data rows of the mesh (ranks of one
    model group share their rows)."""
    from .sharding import data_index, data_size

    n_data = data_size(mesh)
    if global_batch_size % n_data:
        raise ValueError(f"global batch {global_batch_size} not divisible by the "
                         f"{n_data}-way data axis")
    per = global_batch_size // n_data
    first = data_index(mesh) - process_index() * (n_data // process_count())
    return slice(first * per, (first + 1) * per)


def global_batch(mesh, local_pos, local_neg, local_weight, device):
    """This rank's part of the global batch from its host's batch (JAX
    assembles the global array from the hosts' slices; here each rank keeps
    its rows): pos/weight rows of ``local_rows``, and the negatives' too,
    unless they are one shared ``[1, n]`` row, which every rank holds."""
    rows = local_rows(mesh, len(local_pos) * process_count())
    neg = local_neg if local_neg.shape[0] == 1 else local_neg[rows]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return put(local_pos[rows]), put(neg), put(local_weight[rows])


def verify_consistent_restore(step: int, lr: float, warm_up_steps: int) -> None:
    """Failure-recovery guard: after a cold resume every rank must hold the
    same (step, lr, warm_up_steps); a torn checkpoint (one host a save
    behind after a crash mid-save) would desynchronize the LR schedule and
    the sampler epoch. An ``all_gather`` of the three as f32 (the JAX
    guard's dtype), compared row against row; raises on every rank on a
    mismatch. No-op without a process group of more than one rank."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    device = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    mine = torch.tensor([float(step), float(lr), float(warm_up_steps)], dtype=torch.float32,
                        device=device)
    everyone = torch.empty(dist.get_world_size() * 3, dtype=torch.float32, device=device)
    all_gather_flat(everyone, mine)
    everyone = everyone.view(-1, 3)
    if not bool((everyone == everyone[0:1]).all()):
        raise RuntimeError(
            f"inconsistent restore across hosts: rank {dist.get_rank()} has "
            f"(step, lr, warm_up)={mine.tolist()}, fleet={everyone.tolist()}")
