"""Measured per-instruction issue rates and the rank kernels' op roofline.

Counterpart of ``knowledgegraphembedding_tpu/utils/vpu_probe.py``. The rank
kernels (``csrc/rank_counts.cu``) issue more instructions per streamed
element than the table's bytes pay for, so their honest floor is a computed
one: the instructions per element, counted off the compiled kernel, over
issue rates measured independently on the same card. This module supplies
both halves; ``knowledgegraphembedding_torch.vpu_roofline`` prints them.

Method, as in the JAX package: time the chain probe (K4,
``ops/chain_probe.py``) at three chain lengths, three times each, with the
two-point rep fence of ``loop_time``; adjacent-K slopes cancel the load,
the store, the loop and the launch and leave the issue time per link. The
per-link estimate is the median within each K-pair, then the min across
pairs (``op_rate``). On the card a pass of the 262,144-element block takes
microseconds, so the reps run inside one launch (the kernel's own loop) and
are raised until each timed launch lasts milliseconds.

Counts are instructions per thread, not flops: an FFMA counts once, and an
``fabsf`` folded into an FADD's operand counts nothing.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Tuple

import torch

from ..ops.chain_probe import LINKS, SHAPE, chain

#: per (row, candidate, streamed element) FP32 instructions of each
#: rank-kernel family, read off ``cuobjdump -sass`` of ``csrc/rank_counts.cu``
#: (``utils/sass.py``; the ``sass`` phase of ``chip_smoke.py`` checks them),
#: not copied from the TPU kernel's fused-op counts. Per element, as compiled
#: for sm_90a:
#:   RotatE  (per complex element): FADD x4 (two differences, the sum of
#:           squares, the accumulate), FMUL x2 = 6, plus one correctly
#:           rounded sqrt. ``roofline_seconds_per_batch`` charges the sqrt at
#:           the measured cost of the chain probe's sqrtf link, as the JAX
#:           model does; the peak bound of ``chip_smoke.py`` at the kernel's
#:           own grouped sqrt, ``KERNEL_SQRT`` (6.25 instructions), and its
#:           historical column at sqrtf's 10 fast-path instructions
#:           (MUFU.RSQ, 2 FMUL.FTZ, 2 FFMA, IADD3, ISETP, a branch,
#:           BSSY/BSYNC);
#:   TransE: FADD x2 (the difference, the accumulate with |.| as an operand
#:           modifier) = 2;
#:   pRotatE (per sin | cos pair): FMUL x2, FADD x2 (the difference, the
#:           accumulate of its |.|) = 4.
#: Beyond these the register tile (4 rows x 4 candidates a thread) issues
#: 0.30 shared-memory loads (LDS.128, and 3 never-taken LDS per chunk) and
#: under 1 other instruction per element (the first version: 2 LDS and
#: ~3.4 integer address instructions); like the JAX model, the roofline
#: counts the FP32 pipe and the sqrt only.
KERNEL_MIX = {
    "RotatE": {"alu": 6, "special": ("sqrt", 1)},
    "TransE": {"alu": 2, "special": None},
    "pRotatE": {"alu": 4, "special": None},
}

#: the rank kernel's own sqrt per root (``sqrt_group`` in csrc/rank_counts.cu):
#: sqrtf's fast path (MUFU.RSQ, 2 FMUL.FTZ, 2 FFMA) for 16 roots at once
#: behind sqrtf's range test, folded into a running maximum (one VIADDMNMX a
#: root) and one ISETP, BSSY, branch and BSYNC a group of 16
KERNEL_SQRT = {"fp32": 4, "mufu": 1, "other": 1 + 4 / 16}


def host_clock(fn: Callable[[], object]) -> float:
    """Seconds of ``fn()`` on the host clock."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def cuda_clock(fn: Callable[[], object]) -> float:
    """Device seconds of the work ``fn()`` enqueues, by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def loop_time(run: Callable[[int], object], reps: int = 30, trials: int = 1,
              clock: Callable[[Callable[[], object]], float] = host_clock) -> float:
    """Seconds per rep of ``run(r)``, which does r reps (the counterpart of
    the JAX ``fori_time``): a warm call, then the best of ``trials`` timed
    calls at r = reps and at 2 * reps; the difference cancels the fixed
    cost of a call, and ``0.25 * t(reps)`` fences a difference that noise
    drove to or below zero. The min over trials, because stalls only ever
    add time."""

    def timed(r):
        run(r)
        return min(clock(lambda: run(r)) for _ in range(trials))

    t1, t2 = timed(reps), timed(2 * reps)
    return max(t2 - t1, 0.25 * t1) / reps


def _device(device) -> torch.device:
    return torch.device(device if device is not None else "cuda")


def _timed_chain(link: str, K: int, reps: int = 30, trials: int = 3,
                 device=None) -> Tuple[float, int]:
    """(seconds per rep, elements) of the K-link chain ``link`` on the JAX
    kernel's f32[2048, 128] block: K4 on the card, its plain version on the
    CPU."""
    dev = _device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    z0, w0 = (torch.randn(SHAPE, generator=gen, device=dev).abs_() + 0.1 for _ in range(2))
    clock = cuda_clock if dev.type == "cuda" else host_clock
    t = loop_time(lambda r: chain(link, z0, w0, K, r), reps=reps, trials=trials, clock=clock)
    return t, z0.numel()


def op_rate(link: str, ops_per_link: int, Ks=(64, 128, 256), repeats: int = 3, **kw):
    """(instructions/s, debug) for one chain link: ``repeats`` K-sweeps;
    per-link time = the median of each adjacent K-pair's slopes, then the
    min across pairs (longer unrolled chains schedule no better per link,
    and a rank kernel's per-element chain is short); if every slope is
    non-increasing, the secant t(K0) / K0. Debug carries the raw times and
    every pair's median, so the spread stays visible."""
    by_pair = [[] for _ in range(len(Ks) - 1)]
    t_us = []
    n = None
    t0_raw = None
    for _ in range(repeats):
        ts = [_timed_chain(link, K, **kw) for K in Ks]
        n = ts[0][1]
        t0_raw = ts[0][0]
        t_us.append({K: round(t * 1e6, 1) for K, (t, _) in zip(Ks, ts)})
        for i in range(len(Ks) - 1):
            by_pair[i].append((ts[i + 1][0] - ts[i][0]) / (Ks[i + 1] - Ks[i]))
    pair_medians = []
    for sl in by_pair:
        pos = sorted(s for s in sl if s > 0)
        if pos:
            pair_medians.append(pos[len(pos) // 2])
    if not pair_medians:  # every pair non-increasing: secant fallback
        per_link = t0_raw / Ks[0]  # raw seconds, not the rounded debug
    else:
        per_link = min(pair_medians)
    spread = (round(max(pair_medians) / min(pair_medians), 2)
              if len(pair_medians) > 1 else None)
    return (ops_per_link * n) / per_link, {
        "t_us": t_us,
        "pair_median_slopes_ns": [round(s * 1e9, 2) for s in pair_medians],
        "pair_spread": spread,
    }


def hbm_bandwidth(mbytes: int = 512, reps: int = 20, trials: int = 2, device=None):
    """(bytes/s, debug): sequential read bandwidth of a full reduction over
    an ``mbytes`` f32 table (ten times the H100's 50 MB L2), ``torch.sum``
    ``reps`` times per timed call, best of ``trials``."""
    dev = _device(device)
    n = (mbytes << 20) // 4
    gen = torch.Generator(device=dev).manual_seed(7)
    tab = torch.randn((n // 1024, 1024), generator=gen, device=dev)
    clock = cuda_clock if dev.type == "cuda" else host_clock

    def run(r):
        for _ in range(r):
            torch.sum(tab)

    best, times = 0.0, []
    for _ in range(trials):
        t = loop_time(run, reps=reps, clock=clock)
        times.append(round(t * 1e3, 3))
        best = max(best, (mbytes << 20) / t)
    return best, {"stream_ms_per_pass": times, "mbytes": mbytes}


def measure_rates(fast: bool = False, device=None) -> Dict[str, Tuple[float, dict]]:
    """Issue rates (instructions/s) of the chain links, keyed as the JAX
    package keys them. ``fast`` keeps the two the roofline needs (alu,
    sqrt). On the card the chains run in K4 with reps enough for launches
    of milliseconds; on the CPU in the plain version, briefly (a CPU rate
    says nothing of the card)."""
    dev = _device(device)
    card = dev.type == "cuda"
    cheap = dict(reps=2000 if card else 3, trials=3 if card else 1, device=dev)
    special = dict(reps=500 if card else 3, trials=3 if card else 1, device=dev)
    rates: Dict[str, Tuple[float, dict]] = {}
    rates["alu"] = op_rate("alu", LINKS["alu"]["ops"], Ks=(64, 128, 256), **cheap)
    if not fast:
        rates["mul_add"] = op_rate("mul_add", LINKS["mul_add"]["ops"], Ks=(64, 128, 256),
                                   **cheap)
        rates["guard_mix"] = op_rate("guard_mix", LINKS["guard_mix"]["ops"],
                                     Ks=(32, 64, 128), **cheap)
        rates["rsqrt_chain"] = op_rate("rsqrt", LINKS["rsqrt"]["ops"], Ks=(32, 64, 128),
                                       **special)
        # diagnostic only: no KERNEL_MIX entry uses sin
        rates["sin_chain"] = op_rate("sin", LINKS["sin"]["ops"], Ks=(8, 16, 32), **special)
    rates["sqrt_chain"] = op_rate("sqrt", LINKS["sqrt"]["ops"], Ks=(32, 64, 128), **special)
    return rates


def roofline_seconds_per_batch(model: str, B: int, Epad: int, elems_per_row: int,
                               rates: Dict[str, Tuple[float, dict]]) -> float:
    """Computed op roofline (s) of one rank-kernel launch: B rows x Epad
    candidates x elems_per_row streamed elements (RotatE: complex elements,
    half the row; pRotatE: sin | cos pairs). The FP32 instructions of
    ``KERNEL_MIX`` at the measured alu rate; each sqrt at its chain's
    measured time per link less the link's own FADDs at the alu rate."""
    mix = KERNEL_MIX[model]
    n_elem = B * Epad * elems_per_row
    alu_rate = rates["alu"][0]
    t = mix["alu"] * n_elem / alu_rate
    if mix["special"]:
        name, cnt = mix["special"]
        link = LINKS[name]
        chain_rate = rates[f"{name}_chain"][0]  # counted link["ops"] per link
        t_special = (link["ops"] / chain_rate) - (link["adds"] / alu_rate)
        t += cnt * n_elem * max(t_special, 0.0)
    return t
