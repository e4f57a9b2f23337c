"""The consumer's time in the feed a step, on the program's own clock: the
main thread's ``sampler.next`` spans (each iterator's ``__next__``: the wait
on the prefetch queue, or the device sampler's host half) over the traced
window's steps (``harness/program_trace.py``)."""

from kge_bench.harness import program_trace

UNIT = "ms"
BETTER = "lower"
LAYER = "sampler"
MOVES = "train_triples_per_s"
SOURCE = "program_span"


def read(ctx):
    w = program_trace.window(ctx)
    return None if w is None else w.ms_per_unit("sampler.next")
