"""The training step and the trainer that carries its state.

Counterpart of ``knowledgegraphembedding_tpu/train.py`` (reference:
codes/model.py §train_step ≈L267-330, codes/run.py §main ≈L280-340). A step
is forward (row gathers and scores), the loss, autograd's backward, which
gives the dense gradients of the gathers as the reference's index_select
does, and dense Adam in place. The learning rate is a runtime value held in a
0-d tensor on the params' device, and the one-shot decay (÷10 at
warm_up_steps, a fresh Adam, warm_up×3) happens in ``Trainer.one_step``,
setting that tensor and zeroing the Adam state in place, so captured CUDA
graphs (the per-step ones here, the fused trainer's in ``fused_train.py``)
see the live values. Logs stay on the device; nothing in a step reads a
device value on the host.

On a CUDA device ``Trainer.one_step`` replays ``train_step`` from a CUDA
graph captured for the batch's corruption mode (``cuda_graphs``): the same
kernels in the same order, without the host's launches and autograd work of
an eager step. On the CPU the step runs eagerly.

DistMult and ComplEx score their negatives through one dense matmul against
the whole entity table where the JAX package does (``use_dense_scoring``,
``ops/matmul_scoring.py``); the other models gather rows. ``--precision
bf16`` computes the scores from bf16 casts of the f32 tables (f32 sums, f32
scores, gradients into the f32 masters); ``--negative_sharing batch`` scores
one shared ``[1, n]`` negative row against the whole batch. RotatE's
per-row negatives on a plain f32 CUDA table are scored by the hand-written
kernels of ``ops/rotate_score.py`` (forward and backward, reading each
gathered row from the table); every other case runs the chain of
``models/scorers.py``.
"""

from __future__ import annotations

import logging
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from . import cuda_graphs, optim
from .config import ModelSpec, TrainSpec
from .models import kge, scorers
from .ops import loss as loss_ops
from .ops import matmul_scoring, rotate_score
from .utils import profiling


def use_dense_scoring(spec: ModelSpec, tspec: TrainSpec) -> bool:
    """The JAX package's rule: dense (one matmul against the whole table)
    for a bilinear model when ``--scoring dense``, or with ``auto`` when
    E <= 100 n (the product's B E d multiply-adds then cost less than
    gathering B n random rows); never for the other models, and
    ``--scoring dense`` on them is an error."""
    if tspec.scoring == "gather":
        return False
    if not matmul_scoring.supports_dense(spec.model_name):
        if tspec.scoring == "dense":
            raise ValueError(f"{spec.model_name} has no dense bilinear form")
        return False
    if tspec.scoring == "dense":
        return True
    return spec.nentity <= 100 * tspec.negative_sample_size


def batch_scores(params: kge.Params, spec: ModelSpec, tspec: TrainSpec, pos: torch.Tensor,
                 neg: torch.Tensor, mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(positive [B, 1], negative [B, n]) scores of one batch: pos [B, 3],
    neg [B, n] or one shared row [1, n]."""
    compute_dtype = torch.bfloat16 if tspec.precision == "bf16" else None
    if use_dense_scoring(spec, tspec):
        # in the params' dtype unless bf16 is asked for, as the JAX package
        negative_score = matmul_scoring.dense_negative_scores(spec, params, pos, neg, mode,
                                                              compute_dtype)
    elif rotate_score.takes(spec, params, pos, neg, compute_dtype):
        # RotatE's per-row negatives: the hand-written score kernels
        profiling.count("train_step.gather_scored")
        profiling.count("train_step.score_kernel")
        negative_score = rotate_score.rotate_negative_scores(params, spec, pos, neg, mode)
    elif neg.shape[0] == 1 and pos.shape[0] > 1:
        # shared negatives: the backward recomputes the negative forward
        # rather than keep its [B, n, d] intermediates, as the JAX package's
        # jax.checkpoint does (the recompute gathers only n rows). No RNG is
        # drawn in the forward, and reading the generator's state is not
        # allowed inside a CUDA graph capture, so none is saved.
        profiling.count("train_step.gather_scored")
        negative_score = checkpoint(
            lambda p: kge.forward(p, spec, (pos, neg), mode, compute_dtype), params,
            use_reentrant=False, preserve_rng_state=False)
    else:
        profiling.count("train_step.gather_scored")
        negative_score = kge.forward(params, spec, (pos, neg), mode, compute_dtype)
    return kge.forward(params, spec, pos, scorers.SINGLE, compute_dtype), negative_score


def loss_and_logs(params: kge.Params, spec: ModelSpec, tspec: TrainSpec,
                  pos: torch.Tensor, neg: torch.Tensor, weight: torch.Tensor,
                  mode: str) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The loss of one batch: pos [B, 3], neg [B, n] (or one shared row
    [1, n]), weight [B]."""
    positive_score, negative_score = batch_scores(params, spec, tspec, pos, neg, mode)
    loss, logs = loss_ops.kge_loss(positive_score, negative_score, weight, tspec)
    if tspec.regularization != 0.0:
        reg = loss_ops.l3_regularization(params, tspec.regularization)
        loss = loss + reg
        logs["regularization"] = reg
        logs["loss"] = loss  # the reference logs the regularized total
    return loss, logs


def train_step(params: kge.Params, opt_state: optim.AdamState, pos, neg, weight,
               lr: torch.Tensor, *, spec: ModelSpec, tspec: TrainSpec,
               mode: str) -> Dict[str, torch.Tensor]:
    """Loss, gradients and one Adam update of ``params`` and ``opt_state``
    in place; returns the detached logs. The gradients are taken with
    respect to fresh leaves that share the params' storage, so no autograd
    node outlives the step: a leaf's accumulator remembers the CUDA stream
    it was made on, and one kept from an earlier step on another stream
    would make a graph capture (``fused_train.py``) wait on that stream."""
    leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
    with profiling.span("train_step.forward"):
        loss, logs = loss_and_logs(leaves, spec, tspec, pos, neg, weight, mode)
    with profiling.span("train_step.backward"):
        grads = torch.autograd.grad(loss, list(leaves.values()))
    with profiling.span("train_step.adam"):
        optim.apply_update(params, dict(zip(leaves, grads)), opt_state, lr)
    return {k: v.detach() for k, v in logs.items()}


class _StepGraph(NamedTuple):
    key: tuple  # the batch's shapes and dtypes
    graph: cuda_graphs.Graph  # its output: the captured step's logs
    inputs: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # static pos, neg, weight


class Trainer:
    """Step counter, learning-rate schedule with the Adam reset, and the
    params and optimizer state it updates (the loop state of codes/run.py
    §main)."""

    # checkpoint.save_model may snapshot the state on the device and write
    # it from a background thread
    supports_async_checkpoint = True
    # the capturer of the trainer's CUDA graphs, made at its first graph;
    # ``_graphs`` holds them by key from then on (``_live_graphs``)
    _capturer: Optional[cuda_graphs.Capturer] = None

    def __init__(self, spec: ModelSpec, tspec: TrainSpec, params, lr: float,
                 warm_up_steps: int, init_step: int = 0):
        self.dense = use_dense_scoring(spec, tspec)  # raises for dense on a non-bilinear model
        self.spec = spec
        self.tspec = tspec
        self.params = kge.trainable(params)
        self.opt_state = optim.init_state(self.params)
        self.current_learning_rate = lr
        self.warm_up_steps = warm_up_steps
        self.step = init_step

    @property
    def current_learning_rate(self) -> float:
        return self._lr_value

    @current_learning_rate.setter
    def current_learning_rate(self, value: float) -> None:
        """The host value, and ``lr_tensor``: the same in the params' dtype
        on their device (as the JAX trainer passes it), set in place while
        the params keep their dtype and device."""
        self._lr_value = value
        p = self.params["entity_embedding"]
        lr = getattr(self, "lr_tensor", None)
        if lr is None or lr.dtype != p.dtype or lr.device != p.device:
            self.lr_tensor = torch.tensor(value, dtype=p.dtype, device=p.device)
        else:
            self.lr_tensor.fill_(value)

    @classmethod
    def from_jax_state(cls, spec: ModelSpec, tspec: TrainSpec, params, opt_state,
                       step: int, lr: float, warm_up_steps: int, device) -> "Trainer":
        """A trainer seeded from the JAX package's trainer state as numpy:
        ``params`` and ``opt_state`` (anything with the ``count``, ``m`` and
        ``v`` of a JAX ``AdamState``) as the JAX ``Trainer`` holds them, with
        its step, learning rate and warm-up."""
        trainer = cls(spec, tspec, kge.params_from_numpy(params, device), lr,
                      warm_up_steps, init_step=step)
        trainer.opt_state = optim.state_from_numpy(opt_state.count, opt_state.m,
                                                   opt_state.v, device)
        return trainer

    def one_step(self, batch) -> Dict[str, torch.Tensor]:
        """One step of ``batch`` (pos, neg, weight, mode): replayed from the
        mode's CUDA graph on a CUDA device (``_step_from_graph``), eager on
        the CPU; then the decay if due. Returns the step's logs."""
        pos, neg, weight, mode = batch
        with profiling.span("train_step"):
            step_idx = self.step
            if self.params["entity_embedding"].is_cuda:
                logs = self._step_from_graph(pos, neg, weight, mode)
            else:
                profiling.count("train_step.eager")
                logs = train_step(self.params, self.opt_state, pos, neg, weight,
                                  self.lr_tensor, spec=self.spec, tspec=self.tspec, mode=mode)
            self.step = step_idx + 1
            self.decay_if_due(step_idx)
        return logs

    def _written(self) -> List[torch.Tensor]:
        """Every tensor a step writes."""
        st = self.opt_state
        return [*self.params.values(), *st.m.values(), *st.v.values(), st.steps]

    def _graph_inputs(self) -> Tuple[torch.Tensor, ...]:
        """The tensors the trainer's graphs are captured on."""
        return (*self._written(), self.lr_tensor)

    def _live_graphs(self) -> dict:
        """The trainer's graphs by key, in one pool; none once the trainer
        holds other tensors than they were captured on
        (``checkpoint.restore_trainer`` replaces them)."""
        if self._capturer is None:
            self._capturer = cuda_graphs.Capturer(self.params["entity_embedding"].device)
        if self._capturer.stale(self._graph_inputs()):
            self._graphs: dict = {}
        return self._graphs

    def _step_from_graph(self, pos, neg, weight, mode: str) -> Dict[str, torch.Tensor]:
        """``train_step`` on the batch, replayed from the mode's graph, which
        reads static ``pos``, ``neg`` and ``weight`` buffers. The graph is
        captured at the mode's first step and again when the batch's shapes
        or dtypes change; later steps copy their batch into its buffers on
        the current stream, so the wait on the prefetch upload's event still
        orders the copy. The lr and the Adam state are set in place between
        steps (``decay_if_due``), so the graphs see the live values. The logs
        returned are clones: the next replay overwrites the graph's."""
        key = tuple((tuple(t.shape), t.dtype) for t in (pos, neg, weight))
        graphs = self._live_graphs()
        entry = graphs.get(("step", mode))
        if entry is None or entry.key != key:
            inputs = tuple(x.clone() for x in (pos, neg, weight))
            graph = self._capturer.capture(
                "step", lambda: train_step(self.params, self.opt_state, *inputs, self.lr_tensor,
                                           spec=self.spec, tspec=self.tspec, mode=mode),
                written=self._written())
            profiling.count("train_step.captured")
            entry = graphs["step", mode] = _StepGraph(key, graph, inputs)
        else:
            for buf, x in zip(entry.inputs, (pos, neg, weight)):
                buf.copy_(x)
        logs = entry.graph.replay()
        profiling.count("train_step.replayed")
        return {k: v.clone() for k, v in logs.items()}

    def max_block(self, k: int) -> int:
        """Largest advance of at most k steps from the current step that
        keeps lr constant: the decay fires after step_idx >= warm_up_steps,
        so the boundary step itself may close an advance but not be
        crossed."""
        return max(1, min(k, self.warm_up_steps + 1 - self.step))

    def decay_if_due(self, step_idx: int) -> None:
        """codes/run.py ≈L300: checked after step ``step_idx``, so the step
        at warm_up_steps still trains at the old rate; the next one sees
        lr/10, a fresh Adam (zeroed in place) and warm_up_steps*3."""
        if step_idx < self.warm_up_steps:
            return
        with profiling.span("train_step.decay"):
            self.current_learning_rate = self.current_learning_rate / 10.0
            logging.info("Change learning_rate to %f at step %d",
                         self.current_learning_rate, step_idx)
            optim.reset_(self.opt_state)
            self.warm_up_steps = self.warm_up_steps * 3
