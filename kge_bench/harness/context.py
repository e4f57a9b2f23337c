"""What a run knows: the cell's files, its arguments, and what its window and
trace measured. The runner of a traffic kind fills ``window``, ``traced``
and ``extra``; the per-layer metrics read them."""

from __future__ import annotations

import dataclasses
import time
from types import ModuleType
from typing import Any, Dict

import torch


@dataclasses.dataclass
class Ctx:
    root: str
    cell: str
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float  # the host clock at process start
    model_ref: ModuleType  # reference/models/<model>.py
    counts: dict  # counts/models/<model>.json
    peaks: dict  # counts/peaks.json
    limits: Dict[str, float] = dataclasses.field(default_factory=dict)  # limits/<cell>.json
    controls: bool = False  # also read the control's numbers (readings)
    window: Dict[str, Any] = dataclasses.field(default_factory=dict)
    traced: Any = None  # harness.trace.Trace of the traced window
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
    marks: Dict[str, float] = dataclasses.field(default_factory=dict)

    def mark(self, name: str) -> None:
        """Seconds since process start at the end of phase ``name``."""
        self.marks[name] = time.perf_counter() - self.t0


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
