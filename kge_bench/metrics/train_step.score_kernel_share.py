"""How much of the train step's gathered negative scoring went through the
hand-written RotatE score kernels: 100 x the program's
``train_step.score_kernel`` counter over its ``train_step.gather_scored``,
in the traced window (``harness/program_trace.py``): 0 where every such
score took the chain. A program without the counters reads nothing."""

from kge_bench.harness import program_trace

UNIT = "%"
BETTER = "higher"
LAYER = "train step"
MOVES = "train_triples_per_s"
SOURCE = "program_counter"


def read(ctx):
    w = program_trace.window(ctx)
    whole = None if w is None else w.total("train_step.gather_scored")
    if not whole:
        return None
    return 100.0 * (w.total("train_step.score_kernel") or 0) / whole
