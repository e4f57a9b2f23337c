"""Fused multi-step training: blocks of k steps (device draw, forward,
backward, Adam), replayed from captured CUDA graphs
(``--steps_per_dispatch k``).

Counterpart of the single-device half of
``knowledgegraphembedding_tpu/fused_train.py`` (reference: codes/run.py
§main ≈L280-340). JAX scans k steps inside one compiled program; here one
train step per corruption mode is captured as a CUDA graph, covering the
sampler's draw, the forward pass, the loss, autograd's backward, Adam in
place and the log sums added into a device buffer. A block then

  - copies its ``[k, B]`` epoch indices into a static device buffer, once,
    from pinned memory without blocking;
  - replays the tail and head graphs in the JAX order (tail at even global
    steps), each replay reading its row of the buffer through a device slot
    counter and advancing the device step counter itself;
  - reads nothing back: the summed logs stay on the device;
  - bumps, after each replay, the autograd version of what it wrote, and
    counts what the captured step counted (``cuda_graphs.Graph.replay``),
    so caches keyed on the versions see the new weights.

So the host does O(1) work a step. The draw index of step s comes from the
global step (``device_sampler.draw_index``, the rule of JAX's
``_step_key``), so block(k) draws what k blocks of 1 and a resumed run
draw. The graphs share one memory pool, so the activations are held once.

Capture goes through the trainer's ``cuda_graphs.Capturer``, the one its
per-step graphs use: at a mode's first replay, one eager warm-up step on a
side stream whose writes (params, moments, count, step, slot, log sums) are
undone, so capture leaves the trainer as it was. On CUDA a failed capture or
replay raises; nothing runs eagerly in the graphs' place. On the CPU there
are no graphs, and the same step function runs eagerly.

The caller clips k so that a block never crosses the warm-up decay
(``Trainer.max_block``); the decay after a block sets the device lr and
zeroes the moments and count in place (``Trainer.decay_if_due``), so the
graphs keep updating the live state.

``FusedMeshTrainer`` runs the same blocks on a 1-D mesh (JAX
``fused_train.py:300-489``): each rank draws its rows of the global batch
(``MeshDeviceSampler``) and its graphs capture the hand-scheduled table
all-gather step (``parallel/shard_map_step.py``) with its NCCL collectives;
the eager warm-up before the capture creates the communicators. gspmd runs
this schedule too in fused blocks (the two are equal, as the tests hold).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .config import ModelSpec, TrainSpec
from .parallel.shard_map_step import shardmap_train_step
from .parallel.sharding import ShardedTrainer, is_model_sharded
from .sampler.device_sampler import DeviceSampler, draw_index
from .sampler.negative import HEAD_BATCH, TAIL_BATCH
from .train import Trainer, train_step

# fixed log-key order of the summed log vector a block returns
_LOG_KEYS = ("loss", "negative_sample_loss", "positive_sample_loss")


def _log_keys(tspec: TrainSpec) -> Tuple[str, ...]:
    return _LOG_KEYS + ("regularization",) if tspec.regularization != 0.0 else _LOG_KEYS


def step_mode(step: int) -> str:
    """Tail-first alternation: even global steps draw tail-batch."""
    return TAIL_BATCH if step % 2 == 0 else HEAD_BATCH


class FusedDeviceTrainer(Trainer):
    """A ``Trainer`` that also runs fused k-step blocks fed by the device
    sampler. Single-step semantics (``one_step``, the decay, checkpoints) are
    inherited; ``run_block(k)`` advances k steps.

    ``block_capacity`` sizes the static index buffer (a larger block grows
    it and recaptures). ``record_batches`` keeps each block's drawn batches
    on the device (``recorded``) for comparisons. Its graphs are tallied as
    ``cuda_graphs`` kind "block"."""

    def __init__(self, spec: ModelSpec, tspec: TrainSpec, params, lr: float,
                 warm_up_steps: int, train: np.ndarray, seed: int = 0, init_step: int = 0,
                 negative_sharing: str = "none", block_capacity: int = 16,
                 record_batches: bool = False):
        super().__init__(spec, tspec, params, lr=lr, warm_up_steps=warm_up_steps,
                         init_step=init_step)
        self.device = self.params["entity_embedding"].device

        def sampler(mode, seed, shared_state):
            return DeviceSampler(train, spec.nentity, spec.nrelation, tspec.batch_size,
                                 tspec.negative_sample_size, mode, seed=seed,
                                 negative_sharing=negative_sharing, shared_state=shared_state,
                                 device=self.device)

        self._init_blocks(sampler, seed, negative_sharing, block_capacity, record_batches)

    def _init_blocks(self, sampler, seed: int, negative_sharing: str, block_capacity: int,
                     record_batches: bool) -> None:
        """The samplers (``sampler(mode, seed, shared_state)``), counters,
        log sums and block buffers."""
        p = self.params["entity_embedding"]
        # the two samplers hold the resident state and the host index
        # streams (head seed, tail seed + 1, as the per-step iterator)
        self._head = sampler(HEAD_BATCH, seed, None)
        # the weights in the params' dtype: f32 as drawn, except in f64 runs,
        # where a weight sum in f32 would seed f32 noise into the loss
        self._head.weights = self._head.weights.to(p.dtype)
        self._tail = sampler(TAIL_BATCH, seed + 1, (self._head.triples, self._head.weights))
        self._samplers = {HEAD_BATCH: self._head, TAIL_BATCH: self._tail}
        self.negative_sharing = negative_sharing
        self._keys = _log_keys(self.tspec)
        self._step_t = torch.zeros((), dtype=torch.int64, device=self.device)
        self._slot = torch.zeros(1, dtype=torch.int64, device=self.device)
        self._log_sum = torch.zeros(len(self._keys), dtype=p.dtype, device=self.device)
        self._record = record_batches
        self._block0 = None  # (first step, k) of the last block
        self._grow(block_capacity)

    def _grow(self, capacity: int) -> None:
        """Static per-block buffers for ``capacity`` steps."""
        B = self._head.batch_size  # this rank's rows on a mesh
        neg_shape = tuple(self._head.counter.shape)  # [B, n], or [1, n] when shared
        self._idx = torch.zeros((capacity, B), dtype=torch.int32, device=self.device)
        if self._record:
            self._rec = (torch.zeros((capacity, B, 3), dtype=torch.int32, device=self.device),
                         torch.zeros((capacity, *neg_shape), dtype=torch.int32,
                                     device=self.device),
                         torch.zeros((capacity, B), dtype=self._head.weights.dtype,
                                     device=self.device))

    def _step(self, mode: str) -> None:
        """One fused step of ``mode``: the draw for the global step held on
        the device, then ``train.train_step``; no host read. The body of
        each captured graph."""
        idx = self._idx.index_select(0, self._slot).view(-1)
        pos, neg, w = self._samplers[mode].sample(idx, draw_index(self._step_t, mode))
        if self._record:
            for buf, x in zip(self._rec, (pos, neg, w)):
                buf.index_copy_(0, self._slot, x.unsqueeze(0))
        logs = self._train(pos, neg, w, mode)
        self._log_sum.add_(torch.stack([logs[k] for k in self._keys]).to(self._log_sum.dtype))
        self._slot.add_(1)
        self._step_t.add_(1)

    def _train(self, pos, neg, w, mode: str) -> Dict[str, torch.Tensor]:
        return train_step(self.params, self.opt_state, pos, neg, w, self.lr_tensor,
                          spec=self.spec, tspec=self.tspec, mode=mode)

    def _state(self) -> List[torch.Tensor]:
        """Every tensor a step writes, bar the recorded batches."""
        return [*self._written(), self._step_t, self._slot, self._log_sum]

    def _graph_inputs(self) -> Tuple[torch.Tensor, ...]:
        return (*self._state(), self.lr_tensor, self._idx, *(self._rec if self._record else ()))

    def _block_graph(self, mode: str):
        """The graph of one fused step of ``mode``, captured at its first use."""
        graphs = self._live_graphs()
        key = ("block", mode)
        if key not in graphs:
            graphs[key] = self._capturer.capture("block", lambda: self._step(mode),
                                                 written=self._state())
        return graphs[key]

    def run_block(self, k: int) -> Dict[str, torch.Tensor]:
        """Advance k fused steps; returns the SUMMED logs as 0-d device
        tensors (the caller divides by its window count, exactly like
        per-step accumulation)."""
        if k < 1 or k > self.max_block(k):
            raise ValueError(
                f"run_block(k={k}) would cross the LR-decay boundary: "
                f"step={self.step}, warm_up_steps={self.warm_up_steps}; "
                f"clip with max_block() first")
        step0 = self.step
        idx = np.stack([self._samplers[step_mode(step0 + i)]._next_indices()
                        for i in range(k)])
        if k > len(self._idx):
            self._grow(k)
        cuda = self.device.type == "cuda"
        host = torch.from_numpy(idx)
        if cuda:  # the caching host allocator keeps the pinned block until the copy is done
            self._idx[:k].copy_(host.pin_memory(), non_blocking=True)
        else:
            self._idx[:k].copy_(host)
        self._slot.zero_()
        self._step_t.fill_(step0)
        self._log_sum.zero_()
        for i in range(k):
            mode = step_mode(step0 + i)
            if cuda:
                self._block_graph(mode).replay()
            else:
                self._step(mode)
        self.step = step0 + k
        self._block0 = (step0, k)
        self.decay_if_due(self.step - 1)
        return dict(zip(self._keys, self._log_sum.clone()))

    def recorded(self) -> list:
        """The last block's batches as ``(pos, neg, weight, mode)`` device
        tensors, in step order (``record_batches=True``)."""
        if not self._record or self._block0 is None:
            raise RuntimeError("no recorded block: construct with record_batches=True")
        step0, k = self._block0
        return [(*(buf[i].clone() for buf in self._rec), step_mode(step0 + i))
                for i in range(k)]


class FusedMeshTrainer(FusedDeviceTrainer, ShardedTrainer):
    """Fused k-step blocks on a 1-D mesh (``--steps_per_dispatch`` with
    ``--num_shards``): the blocks, graphs and counters of
    ``FusedDeviceTrainer``, the rank's blocks and checkpoint surface of
    ``ShardedTrainer``; each step draws the rank's rows on its device and
    runs the explicit all-gather/reduce-scatter schedule. The host ships
    one ``[k, B / W]`` index block per dispatch. Eager on the CPU."""

    def __init__(self, spec: ModelSpec, tspec: TrainSpec, params, lr: float,
                 warm_up_steps: int, train: np.ndarray, mesh, seed: int = 0,
                 init_step: int = 0, negative_sharing: str = "none", block_capacity: int = 16,
                 record_batches: bool = False):
        from .parallel import multihost
        from .sampler.device_sampler import MeshDeviceSampler

        if is_model_sharded(mesh):
            raise ValueError("--steps_per_dispatch > 1 is written for the 1-D row "
                             "shard; use per-step training with --model_shards")
        ShardedTrainer.__init__(self, spec, tspec, params, lr=lr, warm_up_steps=warm_up_steps,
                                mesh=mesh, init_step=init_step, spmd_mode="shardmap")
        index_subset = (multihost.host_shard_of_indices(len(train))
                        if multihost.process_count() > 1 else None)

        def sampler(mode, seed, shared_state):
            return MeshDeviceSampler(train, spec.nentity, spec.nrelation, tspec.batch_size,
                                     tspec.negative_sample_size, mode, mesh, seed=seed,
                                     negative_sharing=negative_sharing,
                                     index_subset=index_subset, shared_state=shared_state)

        self._init_blocks(sampler, seed, negative_sharing, block_capacity, record_batches)

    def _train(self, pos, neg, w, mode: str) -> Dict[str, torch.Tensor]:
        return shardmap_train_step(self.params, self.opt_state, pos, neg, w, self.lr_tensor,
                                   spec=self.spec, tspec=self.tspec, mesh=self.mesh, mode=mode)
