"""Shared pieces of the benchmark's own tests: the checkout on the import
path, and the cells shrunk to a size that a CPU test can hold."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: every cell at a CPU test's size: published shapes, fewer and narrower
#: rows, an init range near the published one's
TINY = {
    "rotate_fb15k237": {"hidden_dim": 32, "batch_size": 32, "negative_sample_size": 16,
                        "cpu_num": 2,
                        "graph": {"nentity": 400, "nrelation": 7, "ntrain": 4000,
                                  "nvalid": 100, "ntest": 150}},
    "distmult_fb15k237": {"hidden_dim": 32, "gamma": 1.25, "batch_size": 32,
                          "negative_sample_size": 16, "cpu_num": 2,
                          "graph": {"nentity": 400, "nrelation": 7, "ntrain": 4000,
                                    "nvalid": 100, "ntest": 150}},
}
CELLS = ("rotate_fb15k237.train", "rotate_fb15k237.eval", "distmult_fb15k237.train",
         "distmult_fb15k237.eval")


def tiny_run(cell, seed=2147483999, **kw):
    """One run of ``cell`` on the CPU at its tiny size, the chip's look
    skipped."""
    import time

    import torch

    from kge_bench import run

    return run.run(cell, seed, 0.5, kw.pop("trace", False), torch.device("cpu"),
                   overrides=TINY[cell.split(".")[0]], t0=time.perf_counter(), **kw)


@pytest.fixture(scope="session")
def root():
    return ROOT
