"""How often the step found the prefetch queue empty: 100 x the program's
``sampler.starved`` counter over its ``sampler.batches``, in the traced
window (``harness/program_trace.py``). A feed that keeps ahead reads 0."""

from kge_bench.harness import program_trace

UNIT = "%"
BETTER = "lower"
LAYER = "sampler"
MOVES = "train_triples_per_s"
SOURCE = "program_counter"


def read(ctx):
    w = program_trace.window(ctx)
    return None if w is None else w.share("sampler.starved", "sampler.batches")
