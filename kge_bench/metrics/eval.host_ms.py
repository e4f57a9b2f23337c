"""The host's own work in a whole-split pass: the program's ``eval.pass``
spans (around ``split_ranks``) less their ``eval.pull`` and less the time
inside CUDA runtime calls and the profiler's own work, over the traced
window's passes (``harness/program_trace.host_ms``): the Python and ATen
work of the triple upload, the lookups, the chunk loops and the captures.
Under CUPTI each graph launch waits until its kernels are recorded; that
wait is the runtime call's, so it is left out."""

from kge_bench.harness import program_trace

UNIT = "ms"
BETTER = "lower"
LAYER = "eval driver"
MOVES = "eval_queries_per_s"
SOURCE = "program_span"


def read(ctx):
    return program_trace.host_ms(ctx, "eval.pass", leave_out=("eval.pull",))
