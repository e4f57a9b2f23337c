"""Device idle that the program's host work causes in evaluation: the
traced window's device-idle milliseconds inside the main thread's program
spans (``eval.pass`` and its children), less the final ``eval.pull`` (the
host waits there, and the card's last gap is its own) and the profiler's own
buffer requests, over its passes (``harness/program_trace.py``)."""

from kge_bench.harness import program_trace

UNIT = "ms"
BETTER = "lower"
LAYER = "device"
MOVES = "eval_queries_per_s"
SOURCE = "program_span"


def read(ctx):
    return program_trace.idle_program_ms(ctx, leave_out=("eval.pull",))
