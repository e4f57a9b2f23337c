"""The measured program, knowledgegraphembedding_torch, as the harness drives
it: its entries (``Trainer.one_step``, ``sampler.build_train_iterator``,
``eval.split_ranks``), its filter build and its counters. Nothing else of
the benchmark imports the package.
"""

from __future__ import annotations

import numpy as np
import torch


def model_spec(cfg: dict):
    from knowledgegraphembedding_torch.config import ModelSpec

    g = cfg["graph"]
    return ModelSpec(model_name=cfg["model"], nentity=g["nentity"], nrelation=g["nrelation"],
                     hidden_dim=cfg["hidden_dim"], gamma=cfg["gamma"],
                     double_entity_embedding=cfg["double_entity_embedding"],
                     double_relation_embedding=cfg["double_relation_embedding"])


def train_spec(cfg: dict, precision: str):
    from knowledgegraphembedding_torch.config import TrainSpec

    return TrainSpec(negative_sample_size=cfg["negative_sample_size"],
                     batch_size=cfg["batch_size"],
                     negative_adversarial_sampling=cfg["negative_adversarial_sampling"],
                     adversarial_temperature=cfg["adversarial_temperature"],
                     uni_weight=cfg["uni_weight"], regularization=cfg["regularization"],
                     scoring=cfg["scoring"], precision=precision)


def trainer(cfg: dict, weights: dict, precision: str):
    """The per-step trainer of the CLI (``--steps_per_dispatch 1``), its LR
    decay at ``max_steps // 2`` as the CLI sets it."""
    from knowledgegraphembedding_torch.train import Trainer

    return Trainer(model_spec(cfg), train_spec(cfg, precision), weights,
                   lr=cfg["learning_rate"], warm_up_steps=cfg["max_steps"] // 2)


def train_iterator(cfg: dict, train: np.ndarray, seed: int, device: torch.device):
    """The CLI's feed for the configuration's pinned sampler backend: the
    host sampler behind the prefetch queue (uploading on CUDA), or the
    device sampler."""
    from knowledgegraphembedding_torch import native
    from knowledgegraphembedding_torch.sampler import build_train_iterator

    backend = cfg["sampler_backend"]
    if backend == "native":
        if not native.available():
            raise RuntimeError("the native sampler library did not build")
        native.set_threads(cfg["cpu_num"])
    g = cfg["graph"]
    return build_train_iterator(
        train, g["nentity"], g["nrelation"], cfg["batch_size"], cfg["negative_sample_size"],
        seed=seed, prefetch_depth=cfg["prefetch_depth"], backend=backend,
        device=device if device.type == "cuda" else None,
        negative_sharing=cfg["negative_sharing"])


def on_device(batch, device: torch.device):
    """A batch as device tensors (the CLI's ``to_device``)."""
    pos, neg, w, mode = batch
    return tuple(x if isinstance(x, torch.Tensor) else torch.from_numpy(x).to(device)
                 for x in (pos, neg, w)) + (mode,)


def filters(graph: dict, cfg: dict):
    from knowledgegraphembedding_torch.data.filterset import FilterSets

    g = cfg["graph"]
    all_true = np.concatenate([graph["train"], graph["valid"], graph["test"]])
    return FilterSets.build(graph["train"], all_true, g["nentity"], g["nrelation"])


def split_ranks(weights: dict, cfg: dict, spec, triples: np.ndarray, filter_sets) -> np.ndarray:
    """i64 [2, n] ranks (head-batch, tail-batch) as the CLI's test_step
    asks for them, its defaults kept."""
    from knowledgegraphembedding_torch import eval as eval_mod

    return eval_mod.split_ranks(weights, spec, triples, filter_sets,
                                test_batch_size=cfg["test_batch_size"],
                                eval_chunk_size=cfg["eval_chunk_size"],
                                test_log_steps=cfg["test_log_steps"], logger=None)


def rank_launches() -> int:
    """Rank-kernel launches that ran (``rank_counts.launches``)."""
    from knowledgegraphembedding_torch.ops import rank_kernel

    return rank_kernel.rank_counts.launches

