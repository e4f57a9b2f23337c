"""Share of the traced evaluation window in which no kernel or copy ran on
the card."""

UNIT = "%"
BETTER = "lower"
LAYER = "device"
MOVES = "eval_queries_per_s"
SOURCE = "device_trace"


def read(ctx):
    tr = ctx.traced
    if tr is None or not tr.device_events:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
