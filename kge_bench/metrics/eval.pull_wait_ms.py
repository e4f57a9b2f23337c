"""The host's wait for a pass's ranks: the program's ``eval.pull`` spans
(the final copy to the host, which waits for the device to finish the pass)
over the traced window's passes (``harness/program_trace.py``)."""

from kge_bench.harness import program_trace

UNIT = "ms"
BETTER = "lower"
LAYER = "eval driver"
MOVES = "eval_queries_per_s"
SOURCE = "program_span"


def read(ctx):
    w = program_trace.window(ctx)
    return None if w is None else w.ms_per_unit("eval.pull")
