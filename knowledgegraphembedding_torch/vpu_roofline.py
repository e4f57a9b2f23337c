"""Measured issue rates, HBM bandwidth and the rank kernels' floors.

Counterpart of ``tools/vpu_roofline.py`` of the JAX package (the logic is in
``utils/vpu_probe.py``). Runs the chain probe (K4) and the HBM reduction on
the card, and prints one JSON line: the platform and card, ``hbm_gbps``,
the per-link rates and probe times, and for each rank-kernel family at the
YAGO3-10 eval shape (B=16, E=123,182, d=500, with none of the TPU's
padding) and at the main-path shape (B=16, E=14,541, d=1000) the
table-stream time at the measured bandwidth, the op roofline at the
measured rates, and their max, as the JAX bench's eval floor computes them.

    python -m knowledgegraphembedding_torch.vpu_roofline              # on the card
    python -m knowledgegraphembedding_torch.vpu_roofline --platform cpu  # plain chain

On the CPU the chain runs in its plain PyTorch version: its rates are the
CPU's and say nothing of the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from typing import Dict

import torch

from .utils import vpu_probe

#: (B, E, d) of the shapes the floors are computed at
SHAPES = {"yago3_10_b16": (16, 123182, 500), "fb15k237_main_b16": (16, 14541, 1000)}
#: stored floats per entity row at base dim d: RotatE -de re | im, pRotatE's
#: sin | cos table, TransE d
ROW_FLOATS = {"RotatE": 2, "TransE": 1, "pRotatE": 2}


def launch_bytes(model: str, B: int, E: int, d: int) -> int:
    """Bytes one rank-kernel launch must move, each read or written once:
    the table, the B L rows, the filter mask's E candidate bytes a row, the
    true scores and ids, pRotatE's modulus; the counts written. The JAX
    bench counts the table and the mask only; the rest is 0.1 % of it at
    B=16."""
    row_bytes = ROW_FLOATS[model] * d * 4
    return (E * row_bytes + B * row_bytes + B * E + B * 8 + B * 4
            + (4 if model == "pRotatE" else 0))


def floor(model: str, B: int, E: int, d: int, rates, hbm_bytes_per_s: float) -> dict:
    """One rank-kernel launch's floor, in ms: ``launch_bytes`` over the HBM
    rate, and the op roofline at ``rates``, with the larger as the bound.
    With the measured rates and bandwidth it is the measured roofline; with
    the card's peak rates it is the least time the card could take."""
    t_stream = launch_bytes(model, B, E, d) / hbm_bytes_per_s
    t_ops = vpu_probe.roofline_seconds_per_batch(model, B, E, d, rates)
    return {"table_stream_ms": t_stream * 1e3, "op_roofline_ms": t_ops * 1e3,
            "bound_ms": max(t_stream, t_ops) * 1e3,
            "bound_by": "bytes" if t_stream >= t_ops else "operations"}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def run(platform: str = "gpu") -> Dict[str, object]:
    """The probes on ``platform`` ('gpu': CUDA, an error without it; 'cpu':
    the plain chain); returns the dict that ``main`` prints."""
    if platform == "cpu":
        device = torch.device("cpu")
        name, card = "cpu", None
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("--platform gpu: CUDA is not available; pass --platform cpu "
                               "to run the plain chain on the CPU")
        device = torch.device("cuda")
        name, card = torch.cuda.get_device_name(0), card_line()
    rates = vpu_probe.measure_rates(device=device)
    # ten times the H100's 50 MB L2 on the card; a brief pass on the CPU
    bw = vpu_probe.hbm_bandwidth(mbytes=512 if device.type == "cuda" else 64, device=device)
    return {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "device": name,
        "card": card,
        "hbm_gbps": bw[0] / 1e9,
        "hbm_parts": bw[1],
        "rates_gops": {k: v[0] / 1e9 for k, v in rates.items()},
        "probe_times": {k: v[1] for k, v in rates.items()},
        "floors": {shape: {m: floor(m, B, E, d, rates, bw[0]) for m in vpu_probe.KERNEL_MIX}
                   for shape, (B, E, d) in SHAPES.items()},
    }


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--platform", choices=["gpu", "cpu"], default="gpu")
    args = ap.parse_args(argv)
    out = run(args.platform)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
