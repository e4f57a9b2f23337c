"""Device time a training step keeps the card busy: the union of the
traced window's kernel and copy intervals over its steps."""

UNIT = "ms"
BETTER = "lower"
LAYER = "train step"
MOVES = "train_triples_per_s"
SOURCE = "device_trace"


def read(ctx):
    tr = ctx.traced
    if tr is None or not tr.device_events or not tr.units:
        return None
    return 1e3 * tr.busy_s / tr.units
