"""Command-line entry point, flag for flag the JAX package's CLI (reference:
codes/run.py §parse_args ≈L27-80, §main ≈L180-360).

This port evaluates: ``--do_valid``, ``--do_test`` and ``--evaluate_train``
on a checkpoint (``-init``) or a random init. Flags of work not ported yet
are parsed, so a saved ``config.json`` loads, and refused with
``NotImplementedError`` naming the ROADMAP item. It runs on CUDA unless
``--platform cpu`` is given.

Usage:
  python -m knowledgegraphembedding_torch.cli --do_test \
      -init models/RotatE_FB15k-237_0 --test_batch_size 16
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import zlib

import numpy as np
import torch

from .config import RunConfig


def parse_args(argv=None) -> RunConfig:
    p = argparse.ArgumentParser(
        description="Training and Testing Knowledge Graph Embedding Models (PyTorch/CUDA)",
        usage="cli.py [<args>] [-h | --help]",
    )
    p.add_argument("--cuda", action="store_true", help="run on the GPU (the default)")
    p.add_argument("--do_train", action="store_true")
    p.add_argument("--do_valid", action="store_true")
    p.add_argument("--do_test", action="store_true")
    p.add_argument("--evaluate_train", action="store_true",
                   help="Evaluate on training data")
    p.add_argument("--countries", action="store_true",
                   help="Use Countries S1/S2/S3 datasets")
    p.add_argument("--regions", type=int, nargs="+", default=None,
                   help="Region Id for Countries S1/S2/S3 datasets, DO NOT MANUALLY SET")
    p.add_argument("--data_path", type=str, default=None)
    p.add_argument("--model", default="TransE", type=str)
    p.add_argument("-de", "--double_entity_embedding", action="store_true")
    p.add_argument("-dr", "--double_relation_embedding", action="store_true")
    p.add_argument("-n", "--negative_sample_size", default=128, type=int)
    p.add_argument("-d", "--hidden_dim", default=500, type=int)
    p.add_argument("-g", "--gamma", default=12.0, type=float)
    p.add_argument("-adv", "--negative_adversarial_sampling", action="store_true")
    p.add_argument("-a", "--adversarial_temperature", default=1.0, type=float)
    p.add_argument("-b", "--batch_size", default=1024, type=int)
    p.add_argument("-r", "--regularization", default=0.0, type=float)
    p.add_argument("--test_batch_size", default=4, type=int,
                   help="valid/test batch size")
    p.add_argument("--uni_weight", action="store_true",
                   help="Otherwise use subsampling weighting like word2vec")
    p.add_argument("-lr", "--learning_rate", default=0.0001, type=float)
    p.add_argument("-cpu", "--cpu_num", default=10, type=int)
    p.add_argument("-init", "--init_checkpoint", default=None, type=str)
    p.add_argument("-save", "--save_path", default=None, type=str)
    p.add_argument("--max_steps", default=100000, type=int)
    p.add_argument("--warm_up_steps", default=None, type=int)
    p.add_argument("--save_checkpoint_steps", default=10000, type=int)
    p.add_argument("--valid_steps", default=10000, type=int)
    p.add_argument("--log_steps", default=100, type=int, help="train log every xx steps")
    p.add_argument("--test_log_steps", default=1000, type=int,
                   help="valid/test log every xx steps")
    p.add_argument("--nentity", type=int, default=0, help="DO NOT MANUALLY SET")
    p.add_argument("--nrelation", type=int, default=0, help="DO NOT MANUALLY SET")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval_chunk_size", type=int, default=4096,
                   help="candidate chunk of the plain (non-kernel) ranker")
    p.add_argument("--num_shards", type=int, default=1)
    p.add_argument("--model_shards", type=int, default=1)
    p.add_argument("--use_pallas", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="rank through the hand-written CUDA kernel "
                        "(default: on CUDA; --no-use_pallas forces the plain ranker)")
    p.add_argument("--prefetch_depth", type=int, default=4)
    p.add_argument("--scoring", type=str, default="auto",
                   choices=["auto", "gather", "dense"])
    p.add_argument("--precision", type=str, default="f32", choices=["f32", "bf16"])
    p.add_argument("--sampler_backend", type=str, default="auto",
                   choices=["auto", "native", "numpy", "device"])
    p.add_argument("--profile_dir", type=str, default=None)
    p.add_argument("--eval_filter", type=str, default="auto",
                   choices=["auto", "host", "device"],
                   help="filter masks painted on the host or built on the "
                        "device from a resident CSR (auto = device on CUDA)")
    p.add_argument("--spmd_mode", type=str, default="gspmd",
                   choices=["gspmd", "shardmap", "routed"])
    p.add_argument("--negative_sharing", type=str, default="none",
                   choices=["none", "batch"])
    p.add_argument("--async_checkpoint", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--sharded_checkpoint", action="store_true")
    p.add_argument("--steps_per_dispatch", type=int, default=1)
    p.add_argument("--platform", type=str, default="auto",
                   choices=["auto", "cpu", "gpu"],
                   help="auto and gpu run on CUDA (an error if it is absent); "
                        "cpu runs on the CPU")
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--coordinator_address", type=str, default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    ns = p.parse_args(argv)
    return RunConfig(**vars(ns))


def resolve_device(config: RunConfig) -> torch.device:
    """``--platform cpu`` -> CPU; ``auto``/``gpu`` (and ``--cuda``) -> CUDA,
    an error when CUDA is absent."""
    if config.platform == "cpu":
        if config.cuda:
            raise ValueError("--cuda conflicts with --platform cpu")
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"--platform {config.platform}: CUDA is not available "
            "(torch.cuda.is_available() is False); pass --platform cpu to "
            "run on the CPU")
    return torch.device("cuda")


def refuse_unported(config: RunConfig) -> None:
    """Flags whose work is not ported yet fail loudly, naming the ROADMAP item."""
    refused = (
        (config.do_train, "--do_train: training is not ported yet "
                          "(ROADMAP Queue 1, items 5-8)"),
        (config.countries, "--countries: AUC-PR evaluation is not ported yet "
                           "(ROADMAP Queue 1, item 10)"),
        (config.num_shards > 1 or config.model_shards > 1,
         "--num_shards/--model_shards > 1: multi-device schedules are not "
         "ported yet (ROADMAP Queue 1, item 14)"),
        (config.multihost, "--multihost: multi-host runs are not ported yet "
                           "(ROADMAP Queue 1, item 14)"),
        (config.precision == "bf16", "--precision bf16 is not ported yet "
                                     "(ROADMAP Queue 1, item 11)"),
    )
    for cond, msg in refused:
        if cond:
            raise NotImplementedError(msg)


def main(argv=None) -> dict:
    """The evaluation flow of codes/run.py §main; returns the metrics dicts
    keyed by split."""
    from . import checkpoint as ckpt_mod
    from . import eval as eval_mod
    from .data import registry
    from .data.filterset import FilterSets
    from .models import kge
    from .utils.logging import log_metrics, set_logger

    config = parse_args(argv)
    # --- validation (codes/run.py §main ≈L182-190) ---
    if not (config.do_train or config.do_valid or config.do_test):
        raise ValueError("one of train/val/test mode must be chosen")
    if config.init_checkpoint:
        config = ckpt_mod.override_config(config)
    elif config.data_path is None:
        raise ValueError("one of init_checkpoint/data_path must be chosen")
    if config.do_train and config.save_path is None:
        raise ValueError("Where do you want to save your trained model?")
    refuse_unported(config)
    device = resolve_device(config)

    set_logger(config.save_path, config.do_train)

    # --- data (codes/run.py §main ≈L190-235) ---
    ds = registry.load(config.data_path, countries=config.countries)
    config.nentity = ds.nentity
    config.nrelation = ds.nrelation
    config.data_fingerprint = int(zlib.crc32(
        np.ascontiguousarray(ds.train, dtype=np.int32).tobytes()))
    if config.init_checkpoint:
        try:
            with open(os.path.join(config.init_checkpoint, "config.json")) as f:
                saved_fp = json.load(f).get("data_fingerprint", 0)
        except (OSError, ValueError, AttributeError):
            saved_fp = 0  # advisory only: a missing/odd config.json never blocks
        if saved_fp and saved_fp != config.data_fingerprint:
            logging.warning(
                "dataset fingerprint mismatch: checkpoint trained on crc32 "
                "%08x, current data is %08x — metrics will be computed "
                "against a DIFFERENT graph", saved_fp, config.data_fingerprint,
            )

    logging.info("Model: %s", config.model)
    logging.info("Data Path: %s", config.data_path)
    logging.info("#entity: %d", ds.nentity)
    logging.info("#relation: %d", ds.nrelation)
    logging.info("#train: %d", len(ds.train))
    logging.info("#valid: %d", len(ds.valid))
    logging.info("#test: %d", len(ds.test))

    spec = config.model_spec()
    filters = FilterSets.build(ds.train, ds.all_true_triples, ds.nentity, ds.nrelation)
    logging.info("Model Parameter Configuration:")
    shapes = {"entity_embedding": (spec.nentity, spec.entity_dim),
              "relation_embedding": (spec.nrelation, spec.relation_dim)}
    if spec.has_modulus:
        shapes["modulus"] = ()
    for name, shape in shapes.items():
        logging.info("Parameter %s: %s, require_grad = True", name, shape)

    step = 0
    if config.init_checkpoint:
        logging.info("Loading checkpoint %s...", config.init_checkpoint)
        ckpt = ckpt_mod.load_checkpoint(config.init_checkpoint, device)
        params, step = ckpt.params, ckpt.step
    else:
        logging.info("Randomly Initializing %s Model...", config.model)
        gen = torch.Generator(device=device).manual_seed(config.seed)
        params = kge.init_params(spec, gen, device=device)

    logging.info("Start Training...")
    logging.info("init_step = %d", step)
    logging.info("batch_size = %d", config.batch_size)
    logging.info("negative_adversarial_sampling = %s", config.negative_adversarial_sampling)
    logging.info("hidden_dim = %d", config.hidden_dim)
    logging.info("gamma = %f", config.gamma)
    if config.negative_adversarial_sampling:
        logging.info("adversarial_temperature = %f", config.adversarial_temperature)

    def evaluate(triples):
        return eval_mod.test_step(
            params, spec, triples, filters,
            test_batch_size=config.test_batch_size,
            eval_chunk_size=config.eval_chunk_size,
            test_log_steps=config.test_log_steps,
            logger=logging.getLogger(),
            use_kernel=config.use_pallas,
            device_filter={"auto": None, "host": False, "device": True}[config.eval_filter],
        )

    final_metrics = {}
    if config.do_valid:
        logging.info("Evaluating on Valid Dataset...")
        final_metrics["valid"] = evaluate(ds.valid)
        log_metrics("Valid", step, final_metrics["valid"])
    if config.do_test:
        logging.info("Evaluating on Test Dataset...")
        final_metrics["test"] = evaluate(ds.test)
        log_metrics("Test", step, final_metrics["test"])
    if config.evaluate_train:
        logging.info("Evaluating on Training Dataset...")
        final_metrics["train"] = evaluate(ds.train)
        log_metrics("Test", step, final_metrics["train"])
    return final_metrics


if __name__ == "__main__":
    main(sys.argv[1:])
