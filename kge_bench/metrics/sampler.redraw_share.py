"""The host sampler's wasted draws: 100 x the program's ``sampler.rejected``
counter (candidates drawn and dropped as train-true) over its
``sampler.kept`` (B n a batch), in the traced window
(``harness/program_trace.py``)."""

from kge_bench.harness import program_trace

UNIT = "%"
BETTER = "lower"
LAYER = "sampler"
MOVES = "train_triples_per_s"
SOURCE = "program_counter"


def read(ctx):
    w = program_trace.window(ctx)
    return None if w is None else w.share("sampler.rejected", "sampler.kept")
