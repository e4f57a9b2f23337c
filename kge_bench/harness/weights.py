"""The benchmark's weights, made on the device from the seed.

Uniform in [-embedding_range, embedding_range] with ``embedding_range =
(gamma + 2) / hidden_dim``, as the RotatE codebase initializes both tables
(``codes/model.py`` §KGEModel.__init__), one call a table from one
``torch.Generator`` on the device, in float32, the type they are trained and
served in. The program and the reference are handed the same tensors.
"""

from __future__ import annotations

import torch

EPSILON = 2.0


def make(cfg: dict, shapes: dict, seed: int, device: torch.device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    bound = (cfg["gamma"] + EPSILON) / cfg["hidden_dim"]
    return {name: torch.empty(shape, dtype=torch.float32, device=device)
            .uniform_(-bound, bound, generator=gen) for name, shape in shapes.items()}
