"""The row-sharded mesh trainer over a ``torch.distributed`` ``DeviceMesh``.

Counterpart of ``knowledgegraphembedding_tpu/parallel/sharding.py``:

  - a 1-D mesh over ``data`` (one rank per device), or a 2-D ``(data,
    model)`` mesh under ``--model_shards``, whose ``model`` axis shards the
    embedding columns of both tables;
  - the entity table row-sharded over ``data`` (zero rows pad it to a
    multiple of the data size, ``pad_params``), its Adam moments sharded
    alike, so the dense Adam sweep touches only the rank's own rows;
  - the relation table and pRotatE's modulus replicated over ``data``;
  - the batch data-parallel: each data index holds ``B / data`` rows.

Each rank keeps its blocks as plain local tensors (``ShardedTrainer.params``
and ``opt_state``). A step runs one of three schedules (``--spmd_mode``):

  - ``gspmd``: PyTorch's annotate-and-partition. The blocks are wrapped as
    DTensors (entity ``Shard(0)``, and ``Shard(1)`` on ``model``; relation
    ``Replicate()``, ``Shard(1)`` on ``model``); DTensor inserts the
    tables' all-gather, the L3 term's reduction, and the gradients'
    reduce-scatter and all-reduce in the backward. The row lookup is
    redistributed by hand, where DTensor's rule fails
    (``gspmd_train_step``), and the loss runs on the rank's local scores
    (``ops/loss.kge_loss_global`` over ``data``);
  - ``shardmap``: the explicit table all-gather and gradient reduce-scatter
    (``shard_map_step.py``);
  - ``routed``: rows routed to their owners by all-to-all (``routed_step.py``).

All three update the blocks with the same dense Adam on the local tensors.
"""

from __future__ import annotations

import logging
from typing import TYPE_CHECKING, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import optim
from ..config import ModelSpec, TrainSpec
from ..models import kge
from ..ops import loss as loss_ops
from ..train import Trainer, batch_scores, use_dense_scoring
from ..utils import profiling
from . import multihost

if TYPE_CHECKING:  # imported where used: DTensor's modules take a second to import
    from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
MODEL_AXIS = "model"
SPMD_MODES = ("gspmd", "shardmap", "routed")
ENTITY = "entity_embedding"


def build_mesh(n_devices: Optional[int] = None, model_shards: int = 1,
               device_type: str = "cpu") -> DeviceMesh:
    """The device mesh over the ranks of the default process group: 1-D over
    ``data``, or 2-D ``(data, model)`` when ``model_shards > 1``, ranks in
    row-major order. One rank per device, so the mesh spans every rank."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if model_shards > 1:
        data = n_devices if n_devices is not None else world // model_shards
        total = data * model_shards
    else:
        total = n_devices if n_devices is not None else world
    if total <= 0 or total > world:
        raise ValueError(f"requested a {total}-device mesh ({model_shards} model shards) "
                         f"but only {world} devices are available")
    if total != world:
        raise ValueError(f"a {total}-device mesh must span all {world} ranks of the "
                         "process group (one rank per device)")
    if model_shards > 1:
        if multihost.process_count() > 1:
            # a data row straddling hosts would break the host batch layout
            rows = np.arange(total).reshape(-1, model_shards) // multihost.local_ranks()
            check_rows_single_process(rows.tolist())
        return init_device_mesh(device_type, (total // model_shards, model_shards),
                                mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return init_device_mesh(device_type, (total,), mesh_dim_names=(DATA_AXIS,))


def check_rows_single_process(rows_process_indices) -> None:
    """Every 2-D-mesh data row must live on ONE process."""
    for row in rows_process_indices:
        procs = set(row)
        if len(procs) > 1:
            raise ValueError(
                "2-D mesh data-row spans processes "
                f"{sorted(procs)}; choose --model_shards so each "
                "host's devices fill whole rows")


def is_model_sharded(mesh: DeviceMesh) -> bool:
    return MODEL_AXIS in (mesh.mesh_dim_names or ())


def data_size(mesh: DeviceMesh) -> int:
    return mesh.size(0)


def data_index(mesh: DeviceMesh) -> int:
    return mesh.get_local_rank(DATA_AXIS)


def model_size(mesh: DeviceMesh) -> int:
    return mesh.size(1) if is_model_sharded(mesh) else 1


def model_index(mesh: DeviceMesh) -> int:
    return mesh.get_local_rank(MODEL_AXIS) if is_model_sharded(mesh) else 0


def data_group(mesh: DeviceMesh):
    return mesh.get_group(DATA_AXIS)


def model_group(mesh: DeviceMesh):
    return mesh.get_group(MODEL_AXIS)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank owns."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def validate_model_sharding(spec: ModelSpec, mesh: DeviceMesh) -> None:
    """Column sharding must divide both table widths EXACTLY: padding the
    embedding dim would corrupt the re/im half-split the complex-family
    scorers slice at dim//2."""
    if not is_model_sharded(mesh):
        return
    m = model_size(mesh)
    if spec.entity_dim % m or spec.relation_dim % m:
        raise ValueError(
            f"--model_shards {m} must divide entity_dim "
            f"({spec.entity_dim}) and relation_dim ({spec.relation_dim})")


def param_placements(spec: ModelSpec, mesh: DeviceMesh) -> Dict[str, tuple]:
    """DTensor placements of each param, one per mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    if is_model_sharded(mesh):
        out = {ENTITY: (Shard(0), Shard(1)), "relation_embedding": (Replicate(), Shard(1))}
        rep = (Replicate(), Replicate())
    else:
        out = {ENTITY: (Shard(0),), "relation_embedding": (Replicate(),)}
        rep = (Replicate(),)
    if spec.has_modulus:
        out["modulus"] = rep
    return out


def batch_placements(mesh: DeviceMesh, replicated: bool = False) -> tuple:
    """Rows over ``data``, replicated over ``model``; ``replicated``: every
    mesh dim ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    first = Replicate() if replicated else Shard(0)
    return (first, Replicate()) if is_model_sharded(mesh) else (first,)


def pad_params(params, n_shards: int):
    """Zero-pad the entity table's rows up to a multiple of ``n_shards`` so
    the row shard is even. ``spec.nentity`` stays the logical count: the
    samplers draw ids < nentity, evaluation counts candidates < nentity, and
    zero rows add 0 to the L3 term and get 0 gradient, so they stay zero."""
    ent = params[ENTITY]
    E = ent.shape[0]
    Epad = -(-E // n_shards) * n_shards
    if Epad == E:
        return params
    params = dict(params)
    if isinstance(ent, np.ndarray):
        params[ENTITY] = np.pad(ent, ((0, Epad - E), (0, 0)))
    else:
        params[ENTITY] = torch.nn.functional.pad(ent, (0, 0, 0, Epad - E))
    return params


def block_slices(key: str, shape, mesh: DeviceMesh) -> Optional[Tuple[slice, slice]]:
    """This rank's (rows, columns) of the (padded) global array of ``key``
    (a param name), or None for a replicated leaf."""
    name = key.rpartition(".")[2]
    if name == ENTITY:
        per = shape[0] // data_size(mesh)
        rows = slice(data_index(mesh) * per, (data_index(mesh) + 1) * per)
    elif name == "relation_embedding" and is_model_sharded(mesh):
        rows = slice(0, shape[0])
    else:
        return None
    cols = slice(0, shape[1])
    if is_model_sharded(mesh):
        per_c = shape[1] // model_size(mesh)
        cols = slice(model_index(mesh) * per_c, (model_index(mesh) + 1) * per_c)
    return rows, cols


def shard_params(params, spec: ModelSpec, mesh: DeviceMesh) -> kge.Params:
    """This rank's blocks of an unsharded param dict (numpy or tensors; the
    entity rows already padded, ``pad_params``), as contiguous tensors on
    the rank's device. Each rank holds the same full copy (the same init or
    checkpoint), as each JAX host does."""
    device = mesh_device(mesh)
    out = {}
    for k, v in params.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        t = t.detach()
        idx = block_slices(k, tuple(t.shape), mesh)
        if idx is not None:
            t = t[idx]
        out[k] = t.to(device).clone().contiguous()
    return out


def shard_opt_state(state, spec: ModelSpec, mesh: DeviceMesh, count: int) -> optim.AdamState:
    """This rank's blocks of an unsharded Adam state (``m`` and ``v`` dicts,
    entity rows padded), with the step count ``count``."""
    m = shard_params(state.m, spec, mesh)
    v = shard_params(state.v, spec, mesh)
    steps = torch.tensor(int(count), dtype=torch.int32, device=mesh_device(mesh))
    return optim.AdamState(steps=steps, m=m, v=v)


def replicate(local: Dict[str, torch.Tensor], spec: ModelSpec,
              mesh: DeviceMesh) -> Dict[str, torch.Tensor]:
    """The full (padded) tensors from every rank's blocks, on every rank: a
    collective (DTensor's all-gathers), which every rank must call."""
    from torch.distributed.tensor import DTensor

    pl = param_placements(spec, mesh)
    return {k: DTensor.from_local(v.detach(), mesh, pl[k], run_check=False).full_tensor()
            for k, v in local.items()}


def gspmd_train_step(params: kge.Params, opt_state: optim.AdamState, pos, neg, weight,
                     lr: torch.Tensor, *, spec: ModelSpec, tspec: TrainSpec, mesh: DeviceMesh,
                     mode: str) -> Dict[str, torch.Tensor]:
    """One step of the single-device loss on DTensors wrapping this rank's
    blocks; DTensor partitions it. The row lookups and the scores run on the
    rank's batch rows against each table redistributed to ``Replicate()``
    (DTensor's all-gather), whose gradient comes back ``Partial`` over
    ``data`` and is reduced into the blocks' placements by DTensor in the
    backward. The lookup is redistributed explicitly: DTensor's rule for its
    backward (``aten.index_put`` on a replicated table with sharded indices)
    fails in torch 2.11. The scores are the rank's local rows, so the loss
    is ``kge_loss_global`` over ``data`` (a model group's ranks hold the
    same rows); the L3 term on the DTensor tables is a DTensor reduction.
    The dense Adam updates the blocks in place."""
    from torch.distributed.tensor import DTensor, Partial

    pl = param_placements(spec, mesh)
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    dparams = {k: DTensor.from_local(v, mesh, pl[k], run_check=False)
               for k, v in leaves.items()}
    rows = batch_placements(mesh)
    replicated = batch_placements(mesh, replicated=True)
    partial = (Partial(),) + rows[1:]  # the rank's batch rows' share of a table gradient
    full = {k: d.redistribute(mesh, replicated).to_local(grad_placements=partial)
            for k, d in dparams.items()}
    positive_score, negative_score = batch_scores(full, spec, tspec, pos, neg, mode)
    loss, logs = loss_ops.kge_loss_global(positive_score, negative_score, weight, tspec,
                                          data_group(mesh), data_size(mesh))
    if tspec.regularization != 0.0:
        reg = loss_ops.l3_regularization(dparams, tspec.regularization).full_tensor()
        loss = loss + reg
        logs["regularization"] = reg
        logs["loss"] = loss
    grads = torch.autograd.grad(loss, list(leaves.values()))
    optim.apply_update(params, dict(zip(leaves, grads)), opt_state, lr)
    return {k: v.detach() for k, v in logs.items()}


class ShardedTrainer(Trainer):
    """Mesh-parallel ``train.Trainer``: the same step counter, LR decay and
    Adam reset (inherited), with this rank's blocks of the row-sharded
    entity table and its moments, the batch data-parallel, and the step of
    ``spmd_mode``.

    ``one_step`` takes THIS HOST's batch as numpy (the full batch on one
    host; the host's shard of the global batch in a fleet) and keeps the
    rank's rows, or the rank's rows as tensors on its device (the mesh
    device sampler). A shared ``[1, n]`` negative row is every rank's."""

    supports_async_checkpoint = False  # gathering the state is a collective

    def __init__(self, spec: ModelSpec, tspec: TrainSpec, params, lr: float,
                 warm_up_steps: int, mesh: DeviceMesh, init_step: int = 0,
                 spmd_mode: str = "gspmd"):
        if is_model_sharded(mesh):
            if spmd_mode != "gspmd":
                raise ValueError(
                    "2-D (model-sharded) meshes run --spmd_mode gspmd only "
                    "(the hand-scheduled schedules are written for the 1-D "
                    f"row shard); got {spmd_mode!r}")
            validate_model_sharding(spec, mesh)
        if spmd_mode not in SPMD_MODES:
            raise ValueError(f"spmd_mode {spmd_mode!r} not in ('gspmd', 'shardmap', 'routed')")
        self.dense = use_dense_scoring(spec, tspec)
        if spmd_mode == "routed" and self.dense:
            raise ValueError(
                "routed exchange fetches sampled rows; dense scoring computes "
                "against the whole table — use spmd_mode gspmd/shardmap")
        self.spec = spec
        self.tspec = tspec
        self.mesh = mesh
        self.spmd_mode = spmd_mode
        self.device = mesh_device(mesh)
        self.params = {k: v.requires_grad_(True) for k, v in
                       shard_params(pad_params(params, data_size(mesh)), spec, mesh).items()}
        self.opt_state = optim.init_state(self.params)
        self.current_learning_rate = lr
        self.warm_up_steps = warm_up_steps
        self.step = init_step
        if spmd_mode == "shardmap":
            from .shard_map_step import shardmap_train_step as step_fn
        elif spmd_mode == "routed":
            from .routed_step import routed_train_step as step_fn
        else:
            step_fn = gspmd_train_step
        self._step_fn = step_fn

    @property
    def padded_rows(self) -> int:
        return self.params[ENTITY].shape[0] * data_size(self.mesh)

    def local_batch(self, pos, neg, weight):
        """(pos, neg, weight) of this rank on its device: the rank's rows of
        a host batch given as numpy, or the given tensors."""
        if isinstance(pos, np.ndarray):
            return multihost.global_batch(self.mesh, pos, np.asarray(neg),
                                          np.asarray(weight, np.float32), self.device)
        return pos, neg, weight

    def one_step(self, batch) -> Dict[str, torch.Tensor]:
        pos, neg, weight, mode = batch
        with profiling.span("train_step"):
            pos, neg, weight = self.local_batch(pos, neg, weight)
            weight = weight.to(self.params[ENTITY].dtype)
            step_idx = self.step
            logs = self._step_fn(self.params, self.opt_state, pos, neg, weight,
                                 self.lr_tensor, spec=self.spec, tspec=self.tspec,
                                 mesh=self.mesh, mode=mode)
            self.step = step_idx + 1
            self.decay_if_due(step_idx)
        return logs

    # --- checkpoint surface -------------------------------------------------

    def gathered_state(self) -> Tuple[kge.Params, optim.AdamState]:
        """The full params and Adam state, padding rows stripped, on every
        rank (a collective: every rank must call it)."""
        E = self.spec.nentity

        def full(tree):
            out = replicate(tree, self.spec, self.mesh)
            out[ENTITY] = out[ENTITY][:E]
            return out

        st = self.opt_state
        return full(self.params), optim.AdamState(steps=st.steps.clone(), m=full(st.m),
                                                  v=full(st.v))

    def checkpoint_state(self):
        """(params, AdamState) as full host numpy, padding stripped (a
        collective)."""
        p, st = self.gathered_state()

        def host(d):
            return {k: v.cpu().numpy() for k, v in d.items()}

        return host(p), optim.AdamState(steps=st.steps.cpu(), m=host(st.m), v=host(st.v))

    def host_params(self) -> Dict[str, np.ndarray]:
        """Unsharded host copy with padding rows stripped (a collective)."""
        return self.checkpoint_state()[0]

    def load_host_state(self, params, opt_state, step: int, lr: float,
                        warm_up_steps: int) -> None:
        """Restore from an unsharded state (numpy or tensors; ``opt_state``
        with ``count``, ``m`` and ``v``) onto the mesh."""
        n = data_size(self.mesh)
        self.params = {k: v.requires_grad_(True) for k, v in
                       shard_params(pad_params(params, n), self.spec, self.mesh).items()}
        st = optim.AdamState(steps=None, m=pad_params(dict(opt_state.m), n),
                             v=pad_params(dict(opt_state.v), n))
        self.opt_state = shard_opt_state(st, self.spec, self.mesh, int(opt_state.count))
        self.step = step
        self.current_learning_rate = lr
        self.warm_up_steps = warm_up_steps

    def row_blocks(self):
        """This rank's blocks for ``checkpoint.save_model_sharded(blocks=)``:
        per sharded key its global (padded) shape and ``[(block, [r0, r1,
        c0, c1])]``."""
        st = self.opt_state
        out = {}
        for prefix, tree in (("param", self.params), ("adam_m", st.m), ("adam_v", st.v)):
            for name, t in tree.items():
                shape = list(t.shape)
                if name == ENTITY:
                    shape[0] *= data_size(self.mesh)
                if is_model_sharded(self.mesh) and t.dim() == 2:
                    shape[1] *= model_size(self.mesh)
                idx = block_slices(name, shape, self.mesh)
                if idx is None:
                    continue
                r, c = idx
                out[f"{prefix}.{name}"] = (tuple(shape), [(t.detach(),
                                                           [r.start, r.stop, c.start, c.stop])])
        return out


def log_mesh(config, mesh: DeviceMesh) -> None:
    """The JAX CLI's mesh lines."""
    if is_model_sharded(mesh):
        logging.info("SPMD mesh: (%d data x %d model) devices", data_size(mesh),
                     model_size(mesh))
    else:
        logging.info("SPMD mesh: %d devices on axis 'data'", data_size(mesh))
    if config.multihost:
        logging.info("multihost: process %d/%d, %d local devices", multihost.process_index(),
                     multihost.process_count(), multihost.local_ranks())
