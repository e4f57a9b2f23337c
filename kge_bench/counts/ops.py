"""Operations and bytes that the work requires, counted from shapes.

These are the counts of the algorithm, whatever path computes it: a train
step scores B (n + 1) candidates, forward and backward, and Adam updates
every parameter; a filtered ranking scores every query against all E
entities. DistMult's dense training scores every entity, but only the
B (n + 1) candidates are counted. The per-element constants are in
``models/<model>.json``. Left out as below a thousandth of a step: the loss's
own arithmetic (a few operations a candidate, against d of them).
"""

from __future__ import annotations

#: forward and backward of the score chain: the backward costs two forwards
FWD_BWD = 3
#: Adam per parameter: m (3), v (4), the two corrections, the root, eps,
#: the division, the rate and the subtraction (7)
ADAM_OPS_PER_PARAM = 14
#: the L3 term per parameter, forward (|x|, two products, the sum) and
#: backward (the three-factor product and its add into the gradient)
L3_OPS_PER_PARAM = 8
F32_BYTES = 4
I32_BYTES = 4


def elements(cfg: dict) -> int:
    """Elements a score reduces over: complex elements for a complex model."""
    return cfg["hidden_dim"]


def n_params(cfg: dict) -> int:
    g = cfg["graph"]
    de = cfg["hidden_dim"] * (2 if cfg["double_entity_embedding"] else 1)
    dr = cfg["hidden_dim"] * (2 if cfg["double_relation_embedding"] else 1)
    return g["nentity"] * de + g["nrelation"] * dr


def train_step_ops(cfg: dict, counts: dict) -> float:
    B, n, d = cfg["batch_size"], cfg["negative_sample_size"], elements(cfg)
    forward = B * (n + 1) * d * counts["score_ops_per_element"] \
        + B * d * counts["row_ops_per_element"]
    ops = FWD_BWD * forward + ADAM_OPS_PER_PARAM * n_params(cfg)
    if cfg.get("regularization", 0.0):
        ops += L3_OPS_PER_PARAM * n_params(cfg)
    return float(ops)


def ranking_ops(cfg: dict, counts: dict, queries: int) -> float:
    """Filtered ranking of ``queries`` against all E entities."""
    d, E = elements(cfg), cfg["graph"]["nentity"]
    return float(queries * (E * d * counts["score_ops_per_element"]
                            + d * counts["row_ops_per_element"]))


def rank_kernel_bytes(cfg: dict, rows: int, filter_ids: int) -> float:
    """One rank-kernel launch over ``rows`` query rows: the entity table,
    the query rows, the filter's ids for those rows and the counts written,
    each once."""
    width = cfg["hidden_dim"] * (2 if cfg["double_entity_embedding"] else 1)
    E = cfg["graph"]["nentity"]
    return float(E * width * F32_BYTES + rows * width * F32_BYTES
                 + filter_ids * I32_BYTES + rows * I32_BYTES)


def rank_kernel_ops(cfg: dict, counts: dict, rows: int) -> float:
    return float(rows * cfg["graph"]["nentity"] * elements(cfg)
                 * counts["score_ops_per_element"])


def least_s(ops: float, nbytes: float, peaks: dict) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(ops / peaks["f32_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"])
