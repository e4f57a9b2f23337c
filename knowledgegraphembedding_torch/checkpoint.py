"""Checkpoint IO in the JAX package's single-file layout.

``config.json`` is the run configuration (codes/run.py §override_config
semantics) and ``checkpoint.npz`` holds ``step``, ``current_learning_rate``,
``warm_up_steps``, ``adam_count`` and the ``param.*``, ``adam_m.*`` and
``adam_v.*`` arrays (``knowledgegraphembedding_tpu/checkpoint.py``
§_flatten), beside the two ``.npy`` table exports of codes/run.py
§save_model. A checkpoint written by either package loads and resumes in
the other, bit for bit. Saves are synchronous: sharded and asynchronous
checkpoints are not ported yet (ROADMAP Queue 1, item 15), and
``--async_checkpoint`` writes the same files synchronously.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict

import numpy as np
import torch

from . import optim
from .config import RunConfig
from .models import kge
from .train import trainable

# args whose saved values override the CLI on resume (codes/run.py
# §override_config ≈L83-100), plus gamma, which the reference restores with
# the model state. data_path is not here: an explicit --data_path wins, the
# saved one is only the fallback.
OVERRIDE_KEYS = (
    "countries",
    "model",
    "double_entity_embedding",
    "double_relation_embedding",
    "hidden_dim",
    "gamma",
    "test_batch_size",
)


def override_config(config: RunConfig) -> RunConfig:
    """Apply the saved model hyperparameters on resume while keeping the
    rest of the CLI args (codes/run.py §override_config)."""
    with open(os.path.join(config.init_checkpoint, "config.json")) as f:
        saved = json.load(f)
    for k in OVERRIDE_KEYS:
        if k in saved:
            setattr(config, k, saved[k])
    if config.data_path is None:
        config.data_path = saved.get("data_path")
    return config


@dataclasses.dataclass
class Checkpoint:
    params: kge.Params
    adam_m: Dict[str, np.ndarray]
    adam_v: Dict[str, np.ndarray]
    adam_count: int
    step: int
    current_learning_rate: float
    warm_up_steps: int


def _atomic_write(path: str, write_fn) -> None:
    """Temp file + os.replace: a crash mid-save never leaves a truncated
    artifact, so the last checkpoint is always a complete one."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write_fn(f)
    os.replace(tmp, path)


def save_config(config: RunConfig, save_path: str) -> None:
    os.makedirs(save_path, exist_ok=True)
    payload = json.dumps(dataclasses.asdict(config), indent=2).encode()
    _atomic_write(os.path.join(save_path, "config.json"), lambda f: f.write(payload))


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _flatten(params, opt_state: optim.AdamState, step: int, lr: float,
             warm_up_steps: int) -> dict:
    """The checkpoint's key layout and dtypes, as the JAX package's
    ``_flatten`` writes them."""
    arrays = {
        "step": np.int64(step),
        "current_learning_rate": np.float64(lr),
        "warm_up_steps": np.int64(warm_up_steps),
        "adam_count": np.asarray(opt_state.count, np.int32),
    }
    for name, val in params.items():
        arrays[f"param.{name}"] = _host(val)
    for name, val in opt_state.m.items():
        arrays[f"adam_m.{name}"] = _host(val)
    for name, val in opt_state.v.items():
        arrays[f"adam_v.{name}"] = _host(val)
    return arrays


def _write_artifacts(arrays: dict, config: RunConfig, save_path: str) -> None:
    save_config(config, save_path)
    _atomic_write(os.path.join(save_path, "checkpoint.npz"),
                  lambda f: np.savez(f, **arrays))
    for name in ("entity_embedding", "relation_embedding"):
        _atomic_write(os.path.join(save_path, f"{name}.npy"),
                      lambda f, a=arrays[f"param.{name}"]: np.save(f, a))


def save_model(trainer, config: RunConfig, save_path: str) -> None:
    """config.json, checkpoint.npz and the two .npy table exports of the
    trainer's current state (codes/run.py §save_model)."""
    _write_artifacts(
        _flatten(trainer.params, trainer.opt_state, trainer.step,
                 trainer.current_learning_rate, trainer.warm_up_steps),
        config, save_path)


def save_initial_checkpoint(params: kge.Params, config: RunConfig,
                            save_path: str, warm_up_steps: int) -> None:
    """The artifacts of a step-0 save: the params, zero Adam moments and
    ``adam_count`` 0, as the JAX trainer would save before its first step."""
    _write_artifacts(_flatten(params, optim.init_state(params), 0, config.learning_rate,
                              warm_up_steps), config, save_path)


def load_checkpoint(path: str, device) -> Checkpoint:
    """Read ``<path>/checkpoint.npz``; params go to ``device``."""
    with np.load(os.path.join(path, "checkpoint.npz")) as z:
        if "sharded_shards" in z.files:
            raise NotImplementedError(
                "sharded checkpoints are not ported yet (ROADMAP Queue 1, item 15)")
        groups: Dict[str, Dict[str, np.ndarray]] = {"param": {}, "adam_m": {}, "adam_v": {}}
        for key in z.files:
            prefix, _, name = key.partition(".")
            if prefix in groups and name:
                groups[prefix][name] = z[key]
        return Checkpoint(
            params=kge.params_from_numpy(groups["param"], device),
            adam_m=groups["adam_m"],
            adam_v=groups["adam_v"],
            adam_count=int(z["adam_count"]),
            step=int(z["step"]),
            current_learning_rate=float(z["current_learning_rate"]),
            warm_up_steps=int(z["warm_up_steps"]),
        )


def restore_trainer(trainer, path: str):
    """Restore a ``train.Trainer`` in place from a checkpoint directory (the
    reference's ``-init``: model, optimizer state, step, lr and warm-up)."""
    device = trainer.params["entity_embedding"].device
    ck = load_checkpoint(path, device)
    trainer.params = trainable(ck.params)
    trainer.opt_state = optim.state_from_numpy(ck.adam_count, ck.adam_m, ck.adam_v, device)
    trainer.step = ck.step
    trainer.current_learning_rate = ck.current_learning_rate
    trainer.warm_up_steps = ck.warm_up_steps
    return trainer
