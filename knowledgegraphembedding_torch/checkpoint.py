"""Checkpoint IO in the JAX package's single-file layout.

``config.json`` is the run configuration (codes/run.py §override_config
semantics) and ``checkpoint.npz`` holds ``step``, ``current_learning_rate``,
``warm_up_steps``, ``adam_count`` and the ``param.*``, ``adam_m.*`` and
``adam_v.*`` arrays (``knowledgegraphembedding_tpu/checkpoint.py``
§_flatten). A checkpoint written by either package loads in the other.
Sharded and asynchronous checkpoints are not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict

import numpy as np

from .config import RunConfig
from .models import kge

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
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write_fn(f)
    os.replace(tmp, path)


def save_initial_checkpoint(params: kge.Params, config: RunConfig,
                            save_path: str, warm_up_steps: int) -> None:
    """Write ``config.json`` and a step-0 ``checkpoint.npz``: the params,
    zero Adam moments and ``adam_count`` 0, as the JAX trainer saves before
    its first step."""
    os.makedirs(save_path, exist_ok=True)
    payload = json.dumps(dataclasses.asdict(config), indent=2).encode()
    _atomic_write(os.path.join(save_path, "config.json"), lambda f: f.write(payload))
    arrays = {
        "step": np.int64(0),
        "current_learning_rate": np.float64(config.learning_rate),
        "warm_up_steps": np.int64(warm_up_steps),
        "adam_count": np.asarray(0, np.int32),
    }
    for name, val in params.items():
        host = val.detach().cpu().numpy()
        arrays[f"param.{name}"] = host
        arrays[f"adam_m.{name}"] = np.zeros_like(host)
        arrays[f"adam_v.{name}"] = np.zeros_like(host)
    _atomic_write(os.path.join(save_path, "checkpoint.npz"),
                  lambda f: np.savez(f, **arrays))


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
