"""The whole training step's share of the card's float32 peak: the
operations a step requires (``counts/ops.py::train_step_ops``: B (n + 1)
candidates forward and backward, Adam over every parameter) times the
untraced window's steps, over its seconds and the peak of
``counts/peaks.json``."""

from kge_bench.counts import ops

UNIT = "%"
BETTER = "higher"
LAYER = "whole train step"
MOVES = "train_triples_per_s"
SOURCE = "host_clock"


def read(ctx):
    w = ctx.window
    if not w.get("units"):
        return None
    flops = ops.train_step_ops(ctx.cfg, ctx.counts) * w["units"] / w["seconds"]
    return 100.0 * flops / ctx.peaks["f32_flops_per_s"]
