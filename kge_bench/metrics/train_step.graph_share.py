"""How many of the traced window's train steps were replayed from captured
CUDA graphs: 100 x the program's ``train_step.replayed`` counter over its
``train_step.replayed`` and ``train_step.eager`` together
(``harness/program_trace.py``). A step run eagerly, as on the CPU, counts
against it; a program without the counters reads nothing."""

from kge_bench.harness import program_trace

UNIT = "%"
BETTER = "higher"
LAYER = "train step"
MOVES = "train_triples_per_s"
SOURCE = "program_counter"


def read(ctx):
    w = program_trace.window(ctx)
    if w is None:
        return None
    replayed, eager = w.total("train_step.replayed") or 0, w.total("train_step.eager") or 0
    if not replayed + eager:
        return None
    return 100.0 * replayed / (replayed + eager)
