"""The host's wait for each step's batch: the harness's host-clock span
around the call that yields it (``next`` on ``sampler.build_train_iterator``'s
iterator, and the CLI's upload of a host batch), averaged over the untraced
window's steps. A feed that keeps ahead of the step reads near nothing."""

UNIT = "ms"
BETTER = "lower"
LAYER = "sampler"
MOVES = "train_triples_per_s"
SOURCE = "host_clock"


def read(ctx):
    w = ctx.window
    if not w.get("units") or "wait_s" not in w:
        return None
    return 1e3 * w["wait_s"] / w["units"]
