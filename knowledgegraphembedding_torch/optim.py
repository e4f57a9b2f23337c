"""Dense Adam with the reference's optimizer lifecycle.

Counterpart of ``knowledgegraphembedding_tpu/optim.py``. The reference uses
``torch.optim.Adam`` with default betas and eps on *dense* gradients
(codes/run.py §main ≈L250): every row's moments decay and every warm row
moves every step. The LR decay builds a fresh Adam (codes/run.py §main
≈L300), so moments and the bias-correction count reset; here ``reset_``
zeroes them in place, so a captured CUDA graph that updates these tensors
keeps updating the live state.

``apply_update`` keeps the JAX package's arithmetic order, with the bias
correction computed on the params' device in their dtype, rather than
``torch.optim.Adam``'s ``lr/bc1 * m / (sqrt(v)/sqrt(bc2) + eps)``, which
rounds differently. It updates params, moments and the count in place and
reads nothing back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

BETA1 = 0.9
BETA2 = 0.999
EPS = 1e-8  # torch.optim.Adam defaults


@dataclasses.dataclass
class AdamState:
    steps: torch.Tensor  # i32[] steps taken by this optimizer instance, on the params' device
    m: Dict[str, torch.Tensor]  # first moments, keyed as the params
    v: Dict[str, torch.Tensor]  # second moments

    @property
    def count(self) -> int:
        """The step count read to the host (the JAX ``AdamState.count``)."""
        return int(self.steps)


def init_state(params: Mapping[str, torch.Tensor]) -> AdamState:
    device = next(iter(params.values())).device
    return AdamState(
        steps=torch.zeros((), dtype=torch.int32, device=device),
        m={k: torch.zeros_like(p, requires_grad=False) for k, p in params.items()},
        v={k: torch.zeros_like(p, requires_grad=False) for k, p in params.items()},
    )


@torch.no_grad()
def reset_(state: AdamState) -> None:
    """A fresh optimizer in place: moments and count to zero."""
    state.steps.zero_()
    for d in (state.m, state.v):
        for t in d.values():
            t.zero_()


def state_from_numpy(count, m: Mapping[str, np.ndarray], v: Mapping[str, np.ndarray],
                     device) -> AdamState:
    """The JAX package's ``AdamState`` as numpy (``count``, ``m``, ``v``, or
    the ``adam_*`` entries of its ``checkpoint.npz``) -> the port's state on
    ``device``, dtypes kept."""
    def load(d):
        return {k: torch.from_numpy(np.array(a)).to(device) for k, a in d.items()}

    return AdamState(steps=torch.tensor(int(count), dtype=torch.int32, device=device),
                     m=load(m), v=load(v))


@torch.no_grad()
def apply_update(params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
                 state: AdamState, lr: torch.Tensor) -> None:
    """One torch-semantics Adam step, in place on ``params`` and ``state``:
    m <- b1 m + (1-b1) g;  v <- b2 v + (1-b2) g^2;
    p <- p - lr * (m / (1-b1^t)) / (sqrt(v / (1-b2^t)) + eps).
    ``lr`` is a 0-d tensor in the params' dtype on their device."""
    state.steps.add_(1)
    corrections = {}  # (bc1, bc2) per dtype, on the device
    for name, p in params.items():
        g, m, v = grads[name], state.m[name], state.v[name]
        if p.dtype not in corrections:
            t = state.steps.to(p.dtype)
            corrections[p.dtype] = (1.0 - BETA1 ** t, 1.0 - BETA2 ** t)
        bc1, bc2 = corrections[p.dtype]
        m.mul_(BETA1).add_(g * (1.0 - BETA1))
        v.mul_(BETA2).add_((g * g) * (1.0 - BETA2))
        m_hat = m / bc1
        v_hat = v / bc2
        p.sub_(lr * m_hat / (torch.sqrt(v_hat) + EPS))
