"""Logging setup and metric lines in the reference's formats (reference:
codes/run.py §set_logger ≈L148-170, §log_metrics ≈L173-177), identical to
the JAX package's, so logs of the two packages diff cleanly."""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional


def set_logger(save_path: Optional[str], do_train: bool) -> None:
    """Root logger -> <save_path>/train.log (test.log when not training)
    and the console, format '%(asctime)s %(levelname)s %(message)s'."""
    handlers = []
    if save_path:
        os.makedirs(save_path, exist_ok=True)
        log_file = os.path.join(save_path, "train.log" if do_train else "test.log")
        handlers.append(logging.FileHandler(log_file, mode="a"))
    root = logging.getLogger()
    root.setLevel(logging.INFO)
    for h in list(root.handlers):
        root.removeHandler(h)
        h.close()
    fmt = logging.Formatter(
        "%(asctime)s %(levelname)s %(message)s", datefmt="%Y-%m-%d %H:%M:%S"
    )
    for h in handlers + [logging.StreamHandler()]:
        h.setFormatter(fmt)
        root.addHandler(h)


def log_metrics(mode: str, step: int, metrics: Dict[str, float]) -> None:
    """'<mode> <metric> at step <step>: <value>' per metric (codes/run.py §log_metrics)."""
    for metric, value in metrics.items():
        logging.info("%s %s at step %d: %f", mode, metric, step, value)
