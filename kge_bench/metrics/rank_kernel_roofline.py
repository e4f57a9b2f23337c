"""The rank kernel's share of its roofline: the least time of its traced
launches over their device time. A launch's least time is the larger of its
bytes over the HBM rate and its operations over the float32 peak
(``counts/ops.py``: the table, the query rows, the filter's ids of those
rows and the counts written, each once; 7 operations a complex element for
RotatE), averaged over the launches of a pass as the yardstick plans them.
The trace's launches are held against the kernel's own counter
(``rank_counts.launches``); where the trace lost some, the share is of the
launches it holds."""

import re
import sys

UNIT = "%"
BETTER = "higher"
LAYER = "rank kernel"
MOVES = "eval_queries_per_s"
SOURCE = "device_trace"

KERNEL = re.compile("rank_counts")


def read(ctx):
    tr = ctx.traced
    least = ctx.extra.get("least_per_launch_s")
    if tr is None or least is None:
        return None
    events, device_s = tr.kernel_s(KERNEL)
    if not events:
        return None
    counted = ctx.extra.get("launches")
    if counted != events:
        print(f"kge_bench: the trace holds {events} rank-kernel launches, the counter "
              f"{counted}", file=sys.stderr)
    return 100.0 * events * least / device_s
