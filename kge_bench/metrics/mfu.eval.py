"""The whole evaluation pass's share of the card's float32 peak: the
operations filtered ranking requires (``counts/ops.py::ranking_ops``: every
query of the pass against all E entities), times the untraced window's
passes, over its seconds and the peak of ``counts/peaks.json``."""

UNIT = "%"
BETTER = "higher"
LAYER = "whole eval pass"
MOVES = "eval_queries_per_s"
SOURCE = "host_clock"


def read(ctx):
    w = ctx.window
    if not w.get("units") or "pass_ops" not in ctx.extra:
        return None
    flops = ctx.extra["pass_ops"] * w["units"] / w["seconds"]
    return 100.0 * flops / ctx.peaks["f32_flops_per_s"]
