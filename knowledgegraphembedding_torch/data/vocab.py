"""Dataset IO: entity/relation dictionaries and triple files.

Mirrors the reference's on-disk format exactly (reference: codes/run.py
§read_triple ≈L133-145 and §main ≈L190-220): each dataset directory holds
``entities.dict`` / ``relations.dict`` (``id\\tname`` per line) and
``train.txt`` / ``valid.txt`` / ``test.txt`` (``head\\trelation\\ttail`` as
*names*). The countries datasets add ``regions.list`` (one region entity
name per line).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

Triple = Tuple[int, int, int]


def read_dict(path: str) -> Dict[str, int]:
    """Parse an ``id\\tname`` TSV into name->id (codes/run.py §main ≈L195).

    Validates that names are unique and ids form exactly 0..N-1: a
    duplicate name or gapped id would size the embedding table below the
    max triple id, and a CUDA gather past the table end faults or reads
    garbage instead of raising."""
    out: Dict[str, int] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()  # reference uses strip(): tolerate CRLF files
            if not line:
                continue
            eid, name = line.split("\t")
            if name in out:
                raise ValueError(f"{path}: duplicate name {name!r}")
            out[name] = int(eid)
    ids = sorted(out.values())
    if ids != list(range(len(ids))):
        raise ValueError(
            f"{path}: ids must be exactly 0..{len(ids) - 1} "
            "(gapped or duplicate ids would silently corrupt gathers)"
        )
    return out


def read_triple(path: str, entity2id: Dict[str, int], relation2id: Dict[str, int]) -> List[Triple]:
    """Name triples -> id triples (codes/run.py §read_triple ≈L133-145)."""
    triples: List[Triple] = []
    with open(path) as f:
        for line in f:
            line = line.strip()  # reference uses strip(): tolerate CRLF files
            if not line:
                continue
            h, r, t = line.split("\t")
            triples.append((entity2id[h], relation2id[r], entity2id[t]))
    return triples


@dataclass
class Dataset:
    """A fully-loaded KGE dataset: vocab sizes, the three splits as int32
    ``[N, 3]`` arrays, and (countries only) the region entity ids."""

    nentity: int
    nrelation: int
    train: np.ndarray
    valid: np.ndarray
    test: np.ndarray
    regions: Optional[List[int]] = None
    name: str = ""
    entity2id: Dict[str, int] = field(default_factory=dict)
    relation2id: Dict[str, int] = field(default_factory=dict)

    @property
    def all_true_triples(self) -> np.ndarray:
        """train ∪ valid ∪ test — the filter set for evaluation
        (codes/run.py §main ≈L230 ``all_true_triples``)."""
        return np.concatenate([self.train, self.valid, self.test], axis=0)


def _as_array(triples: List[Triple]) -> np.ndarray:
    if not triples:
        return np.zeros((0, 3), np.int32)
    return np.asarray(triples, np.int32)


def load_dataset(data_path: str, countries: bool = False) -> Dataset:
    """Load a reference-format dataset directory (codes/run.py §main ≈L190-230)."""
    entity2id = read_dict(os.path.join(data_path, "entities.dict"))
    relation2id = read_dict(os.path.join(data_path, "relations.dict"))
    splits = {
        s: _as_array(read_triple(os.path.join(data_path, f"{s}.txt"), entity2id, relation2id))
        for s in ("train", "valid", "test")
    }
    regions = None
    if countries:
        regions = []
        with open(os.path.join(data_path, "regions.list")) as f:
            for line in f:
                line = line.strip()
                if line:
                    regions.append(entity2id[line])
    return Dataset(
        nentity=len(entity2id),
        nrelation=len(relation2id),
        train=splits["train"],
        valid=splits["valid"],
        test=splits["test"],
        regions=regions,
        name=os.path.basename(os.path.normpath(data_path)),
        entity2id=entity2id,
        relation2id=relation2id,
    )


def save_dataset(ds: Dataset, data_path: str) -> None:
    """Write a dataset back out in the reference TSV format (used by the
    synthetic generator so the CLI path exercises real file IO)."""
    os.makedirs(data_path, exist_ok=True)
    id2e = {v: k for k, v in ds.entity2id.items()} if ds.entity2id else {
        i: f"e{i}" for i in range(ds.nentity)
    }
    id2r = {v: k for k, v in ds.relation2id.items()} if ds.relation2id else {
        i: f"r{i}" for i in range(ds.nrelation)
    }
    with open(os.path.join(data_path, "entities.dict"), "w") as f:
        for i in range(ds.nentity):
            f.write(f"{i}\t{id2e[i]}\n")
    with open(os.path.join(data_path, "relations.dict"), "w") as f:
        for i in range(ds.nrelation):
            f.write(f"{i}\t{id2r[i]}\n")
    for split in ("train", "valid", "test"):
        arr = getattr(ds, split)
        with open(os.path.join(data_path, f"{split}.txt"), "w") as f:
            for h, r, t in arr:
                f.write(f"{id2e[int(h)]}\t{id2r[int(r)]}\t{id2e[int(t)]}\n")
    if ds.regions is not None:
        with open(os.path.join(data_path, "regions.list"), "w") as f:
            for rid in ds.regions:
                f.write(f"{id2e[int(rid)]}\n")
