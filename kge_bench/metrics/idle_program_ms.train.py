"""Device idle that the program's host work causes in training: the traced
window's device-idle milliseconds that lie inside the union of the main
thread's program spans (the feed's ``sampler.next``, ``train_step``), less
those under the profiler's own buffer requests, over its steps
(``harness/program_trace.py``)."""

from kge_bench.harness import program_trace

UNIT = "ms"
BETTER = "lower"
LAYER = "device"
MOVES = "train_triples_per_s"
SOURCE = "program_span"


def read(ctx):
    return program_trace.idle_program_ms(ctx)
