"""The fastest whole-split pass of the untraced window, on the host's
clock (each pass ends with its ranks on the host). On the H100 a pass runs
at one of two speeds, about 6 % apart, with the clocks unchanged; this is
the faster one, steadier than the window's rate, which mixes them."""

UNIT = "ms"
BETTER = "lower"
LAYER = "whole eval pass"
MOVES = "eval_queries_per_s"
SOURCE = "host_clock"


def read(ctx):
    pass_s = ctx.window.get("pass_s")
    if pass_s is None or not len(pass_s):
        return None
    return 1e3 * float(min(pass_s))
