"""Evaluation traffic: whole-split filtered ranking through ``eval.split_ranks``,
pass after pass, as the CLI's Valid and Test ask for it.

Set-up builds the program's filter and ranks the split ``warmup_passes``
times (the chunk graphs are captured there). The window runs passes for
``--seconds``: it ends with the last pass begun inside it and holds the
host's work between passes. A traced run then traces ``trace_passes`` more.
Once the window has closed, a sample of the window's answers drawn from the
seed, the split's last batch among them, is held against the reference.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from kge_bench.counts import ops
from kge_bench.harness import graph as graph_mod
from kge_bench.harness import program
from kge_bench.harness import trace as trace_mod
from kge_bench.harness import weights as weights_mod
from kge_bench.harness.context import Ctx, sync
from kge_bench.reference import rank as ref_rank

MODES = (ref_rank.HEAD, ref_rank.TAIL)  # the order of split_ranks' rows
#: the sample's own random stream of the seed
SAMPLE_STREAM = 2


def sample(seed: int, n: int, passes: int, size: int, last_rows: int) -> list:
    """(pass, mode, index) of the answers to check: ``size`` drawn without
    replacement over both modes, and the split's last ``last_rows`` rows in
    both modes, each from a pass drawn from the seed."""
    rng = np.random.default_rng([seed, SAMPLE_STREAM])
    picks = set(rng.choice(2 * n, size=min(size, 2 * n), replace=False).tolist())
    picks |= {m * n + i for m in range(2) for i in range(max(0, n - last_rows), n)}
    picks = sorted(picks)
    which = rng.integers(0, passes, size=len(picks))
    return [(int(p), int(q // n), int(q % n)) for p, q in zip(which, picks)]


def launch_plan(cfg: dict, triples: np.ndarray, sets) -> list:
    """The rank kernel's launches of one pass as the yardstick counts them:
    per mode, batches of ``test_batch_size`` rows (at least 16), each with
    the filter ids of its rows."""
    E, R = cfg["graph"]["nentity"], cfg["graph"]["nrelation"]
    rows = max(16, cfg["test_batch_size"])
    plan = []
    for mode in MODES:
        enc = sets[mode]
        keys = ref_rank._keys(triples, mode, E, R)
        ids = np.searchsorted(enc, (keys + 1) * E) - np.searchsorted(enc, keys * E)
        for s in range(0, len(triples), rows):
            plan.append((len(ids[s:s + rows]), int(ids[s:s + rows].sum())))
    return plan


def run(ctx: Ctx) -> dict:
    cfg, mix, device = ctx.cfg, ctx.mix, ctx.device
    g = graph_mod.from_config(cfg, ctx.seed)
    ctx.mark("graph")
    weights = weights_mod.make(cfg, ctx.model_ref.shapes(cfg), ctx.seed, device)
    spec = program.model_spec(cfg)
    filter_sets = program.filters(g, cfg)
    triples = g[mix["split"]]
    ctx.mark("build")

    def one_pass() -> np.ndarray:
        return program.split_ranks(weights, cfg, spec, triples, filter_sets)

    for _ in range(mix["warmup_passes"]):
        one_pass()
    sync(device)
    setup_s = time.perf_counter() - ctx.t0
    ctx.mark("setup")

    passes, ends = [], []
    t0 = time.perf_counter()
    while not passes or ends[-1] - t0 < ctx.seconds:
        passes.append(one_pass())  # its ranks are on the host: the pass is done
        ends.append(time.perf_counter())
    sync(device)
    window_s = time.perf_counter() - t0
    queries = len(passes) * 2 * len(triples)
    pass_s = np.diff([t0] + ends)
    ctx.window = {"units": len(passes), "seconds": window_s, "queries": queries,
                  "pass_s": pass_s}
    print(f"kge_bench: {len(passes)} passes, seconds a pass min {pass_s.min():.4f} "
          f"median {np.median(pass_s):.4f} max {pass_s.max():.4f}", file=sys.stderr)
    ctx.mark("window")
    if ctx.trace:
        before = program.rank_launches()

        def traced_passes() -> int:
            for _ in range(mix["trace_passes"]):
                with trace_mod.span("eval_pass"):
                    one_pass()
            return mix["trace_passes"]
        ctx.traced = trace_mod.traced(traced_passes, device)
        ctx.extra["launches"] = program.rank_launches() - before
    ctx.mark("trace")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del filter_sets

    E, R = cfg["graph"]["nentity"], cfg["graph"]["nrelation"]
    all_true = np.concatenate([g["train"], g["valid"], g["test"]])
    sets = ref_rank.true_sets(all_true, E, R)
    ctx.extra["pass_ops"] = ops.ranking_ops(cfg, ctx.counts, 2 * len(triples))
    if ctx.counts["scoring_kernel"] == "rank_counts":
        plan = launch_plan(cfg, triples, sets)
        least = [ops.least_s(ops.rank_kernel_ops(cfg, ctx.counts, rows),
                             ops.rank_kernel_bytes(cfg, rows, ids), ctx.peaks)
                 for rows, ids in plan]
        ctx.extra["least_per_launch_s"] = sum(least) / len(least)

    shape_faults = sum(int(p.shape != (2, len(triples))) for p in passes)
    picks = sample(ctx.seed, len(triples), len(passes), mix["check_queries"],
                   max(16, cfg["test_batch_size"]))
    queries_checked = [(MODES[m], i) for _, m, i in picks]
    if shape_faults:
        gaps = np.full(len(picks), ref_rank.IMPOSSIBLE)
    else:
        answers = np.array([passes[p][m, i] for p, m, i in picks])
        gaps = ref_rank.gaps(ctx.model_ref, cfg, weights, triples, queries_checked, answers,
                             sets)
    readings = {"rank_gap": float(gaps.max()), "shape_faults": shape_faults}
    control = cfg["control"]["eval"]
    if ctx.controls and control["side"] == "reference":
        low = ref_rank.ranks_in(ctx.model_ref, cfg, weights, triples, queries_checked, sets,
                                control["precision"])
        readings["control.rank_gap"] = float(ref_rank.gaps(
            ctx.model_ref, cfg, weights, triples, queries_checked, low, sets).max())
    ctx.mark("check")
    limit = ctx.limits.get("rank_gap")
    failed = int(np.sum(gaps > limit)) if limit is not None else 0
    if failed:
        print(f"kge_bench: {failed} of {len(picks)} checked answers over the rank_gap limit",
              file=sys.stderr)
    return {
        "setup_s": setup_s,
        "e2e": {"eval_queries_per_s": queries / window_s},
        "attempted": queries,
        "failed": failed,
        "memory_peak_bytes": peak,
        "readings": readings,
    }
