"""Device time of a whole-split pass spent outside the scoring kernel (the
rank kernel, or the dense GEMM, named in ``counts/models/<model>.json``):
the mask's fill and scatter, the input gathers, the count corrections. The
traced window's busy time less the scoring kernel's, over its passes."""

import re

UNIT = "ms"
BETTER = "lower"
LAYER = "eval driver"
MOVES = "eval_queries_per_s"
SOURCE = "device_trace"


def read(ctx):
    tr = ctx.traced
    if tr is None or not tr.device_events or not tr.units:
        return None
    events, kernel_s = tr.kernel_s(re.compile(ctx.counts["scoring_kernel"], re.IGNORECASE))
    if not events:
        return None
    return 1e3 * (tr.busy_s - kernel_s) / tr.units
