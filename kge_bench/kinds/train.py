"""Training traffic: the CLI's per-step loop, one ``Trainer.one_step`` a
batch from ``sampler.build_train_iterator``, the step logs summed on the
device and read every ``log_steps`` steps.

Set-up builds the trainer and its feed once, drives them through the
mix's first ``check_steps`` steps (the output check's) and its warm-up
steps, and hands the same two objects to the window. The window runs steps
for ``--seconds``; every step begun in it counts, and it ends at the
synchronization after the last one. A traced run then traces
``trace_steps`` more. Once the program is freed, the reference follows the
first steps from the same weights and batches.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import time

import torch

from kge_bench.harness import graph as graph_mod
from kge_bench.harness import program
from kge_bench.harness import trace as trace_mod
from kge_bench.harness import weights as weights_mod
from kge_bench.harness.context import Ctx, sync
from kge_bench.reference import train as ref_train

BETA1 = 0.9  # Adam's, to read the first gradient from the first moment
#: leaves whose reference gradient is under this share of the median
#: leaf's move by round-off alone, and are left out of the change
QUIET_LEAF = 1e-3


class Loop:
    """The CLI's step loop around the trainer and its feed."""

    def __init__(self, trainer, it, device: torch.device, log_steps: int):
        self.trainer, self.it, self.device, self.log_steps = trainer, it, device, log_steps
        self.keys, self.acc, self.n = None, None, 0
        self.wait_s = 0.0

    def step(self, spans: bool = False):
        span = trace_mod.span if spans else (lambda _: contextlib.nullcontext())
        with span("sampler"):
            t = time.perf_counter()
            batch = program.on_device(next(self.it), self.device)
            self.wait_s += time.perf_counter() - t
        with span("train_step"):
            logs = self.trainer.one_step(batch)
        if self.keys is None:
            self.keys = sorted(logs)
            self.acc = torch.zeros(len(self.keys), dtype=torch.float32, device=self.device)
        self.acc = self.acc + torch.stack([logs[k] for k in self.keys])
        self.n += 1
        if self.n % self.log_steps == 0:
            with span("log_read"):
                self.acc.cpu()  # the CLI's one read a log window
                self.acc = torch.zeros_like(self.acc)
        return batch, logs

    def steps(self, count: int, spans: bool = False) -> int:
        for _ in range(count):
            self.step(spans)
        return count


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def numbers(losses, grad1: dict, after: dict, ref: dict, init: dict) -> dict:
    """The compared numbers of a run whose first steps gave ``losses``,
    first gradient ``grad1`` and weights ``after``, against ``ref``."""
    out = {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, ref["loss"]))}
    g_ref = _norms(ref["grad1"])
    g_med = statistics.median(g_ref.values())
    g_prog = _norms(grad1)
    out["grad_gap"] = max(abs(g_prog[k] - g_ref[k]) / max(g_ref[k], g_med) for k in g_ref)
    out["grad_diff"] = max(
        float(torch.linalg.vector_norm(grad1[k].double() - ref["grad1"][k].double()))
        / max(g_ref[k], g_med) for k in g_ref)
    moved = [k for k in g_ref if g_ref[k] >= QUIET_LEAF * g_med]
    d_ref = {k: ref["params"][k].double() - init[k].double() for k in moved}
    d_prog = {k: after[k].double() - init[k].double() for k in moved}
    n_ref, n_prog = _norms(d_ref), _norms(d_prog)
    d_med = statistics.median(n_ref.values())
    out["change_gap"] = max(abs(n_prog[k] - n_ref[k]) / max(n_ref[k], d_med) for k in moved)
    return out


def run(ctx: Ctx) -> dict:
    cfg, mix, device = ctx.cfg, ctx.mix, ctx.device
    g = graph_mod.from_config(cfg, ctx.seed)
    ctx.mark("graph")
    init = weights_mod.make(cfg, ctx.model_ref.shapes(cfg), ctx.seed, device)
    trainer = program.trainer(cfg, init, cfg["precision"])  # trains copies of init
    it = program.train_iterator(cfg, g["train"], ctx.seed, device)
    ctx.mark("build")
    try:
        loop = Loop(trainer, it, device, mix["log_steps"])
        first, losses, grad1 = [], [], None
        for k in range(mix["check_steps"]):
            batch, logs = loop.step()
            first.append(tuple(x.clone() if isinstance(x, torch.Tensor) else x for x in batch))
            losses.append(logs["loss"].clone())
            if k == 0:  # Adam's first moment after one step is (1 - beta1) g
                grad1 = {n: m / (1 - BETA1) for n, m in trainer.opt_state.m.items()}
        after = {n: p.detach().clone() for n, p in trainer.params.items()}
        loop.steps(mix["warmup_steps"])
        sync(device)
        setup_s = time.perf_counter() - ctx.t0
        ctx.mark("setup")

        loop.wait_s, n0 = 0.0, loop.n
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            loop.step()
        sync(device)
        window_s = time.perf_counter() - t0
        steps = loop.n - n0
        ctx.window = {"units": steps, "seconds": window_s, "wait_s": loop.wait_s}
        ctx.mark("window")
        if ctx.trace:
            ctx.traced = trace_mod.traced(lambda: loop.steps(mix["trace_steps"], spans=True),
                                         device)
        ctx.mark("trace")
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    finally:
        it.close()
    losses = [float(x) for x in losses]
    del trainer, loop, it
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = ref_train.follow(ctx.model_ref, cfg, init, first, g["train"])
    readings = numbers(losses, grad1, after, ref, init)
    faults = ref_train.draw_faults(
        g["train"], cfg["graph"]["nentity"], cfg["graph"]["nrelation"],
        [tuple(x.cpu().numpy() if isinstance(x, torch.Tensor) else x for x in b) for b in first])
    readings["draw_faults"] = sum(faults.values())
    control = cfg["control"]["train"]
    if ctx.controls and control["side"] == "reference":
        ctl = ref_train.follow(ctx.model_ref, cfg, init, first, g["train"], dtype=torch.float32,
                               precision=control["precision"])
        for k, v in numbers(ctl["loss"], ctl["grad1"], ctl["params"], ref, init).items():
            readings["control." + k] = v
    ctx.mark("check")
    B = cfg["batch_size"]
    return {
        "setup_s": setup_s,
        "e2e": {"train_triples_per_s": steps * B / window_s},
        "attempted": steps,
        "failed": 0,
        "memory_peak_bytes": peak,
        "readings": readings,
    }
