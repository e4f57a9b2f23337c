"""The reference's .npy serving tables from any checkpoint (counterpart of
the JAX package's ``tools/export_tables.py``).

The reference writes ``entity_embedding.npy`` and ``relation_embedding.npy``
at every save (codes/run.py §save_model ≈L103-130), its de-facto serving
artifact. A sharded save never gathers the table, so it writes no such
files (``checkpoint.save_model_sharded``); this tool reassembles them from
the shard files, or reads them from a single-file checkpoint. It reads the
two tables only, in numpy, and places nothing on any device.

Usage:
    python -m knowledgegraphembedding_torch.export_tables SAVE_DIR [--out DIR]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from . import checkpoint as ckpt

TABLES = ("entity_embedding", "relation_embedding")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("save_dir")
    ap.add_argument("--out", default=None, help="output dir (default: SAVE_DIR)")
    args = ap.parse_args(argv)
    out = args.out or args.save_dir

    layout = "sharded" if ckpt.is_sharded_checkpoint(args.save_dir) else "single-file"
    arrays = ckpt.read_arrays(args.save_dir, keys=("step", *(f"param.{t}" for t in TABLES)))
    os.makedirs(out, exist_ok=True)
    for name in TABLES:
        path = os.path.join(out, f"{name}.npy")
        arr = arrays[f"param.{name}"]
        ckpt._atomic_write(path, lambda f: np.save(f, arr))
        print(f"wrote {path} {arr.shape} (step {int(arrays['step'])}, {layout} checkpoint)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
