"""Checkpoint IO in the JAX package's layouts: one file or a file per
process, written on the caller's thread or by a background writer.

Single-file layout (``save_model``): ``config.json`` is the run
configuration (codes/run.py §override_config semantics) and
``checkpoint.npz`` holds ``step``, ``current_learning_rate``,
``warm_up_steps``, ``adam_count`` and the ``param.*``, ``adam_m.*`` and
``adam_v.*`` arrays (``knowledgegraphembedding_tpu/checkpoint.py``
§_flatten), beside the two ``.npy`` table exports of codes/run.py
§save_model. A checkpoint written by either package loads and resumes in
the other, bit for bit.

Asynchronous saves (``asynchronous=True``, the CLI's ``--async_checkpoint``
for periodic saves). The trainer writes its params, Adam moments and step
count in place (``optim.apply_update``, and the graph replays of
``fused_train``), so a save cannot hand the live tensors to a thread as the
JAX package hands its immutable arrays. It clones them on the current
stream, which orders the clones after the step that produced the state and
before any later step or replay; the writer thread pulls the clones into
pinned host buffers on a side stream that waits on an event recorded after
them, waits for that copy, and writes the same files as a synchronous save.
The trainer keeps its own tensors: its CUDA graphs were captured on them.
On the CPU the clones are the host copies. At most one save is in flight:
the next save, ``wait_for_pending_save`` and interpreter exit join it, and a
failed write raises there or at ``check_pending_save``.

Sharded layout (``save_model_sharded``): each process writes its row blocks
of the entity table and its moments to ``checkpoint.shard{p}-of-{n}.npz``,
each block beside its ``[r0, r1, c0, c1]`` bounds and the step stamped into
every file; process 0 writes ``config.json`` and a meta ``checkpoint.npz``
(the scalars, the replicated leaves and each sharded array's global shape).
No process gathers the table, and no ``.npy`` export is written
(``export_tables`` makes them). ``load_checkpoint`` reassembles a fleet on
one process, and refuses shard files of another step or blocks that do not
cover an array.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import optim
from .config import RunConfig
from .models import kge

# args whose saved values override the CLI on resume (codes/run.py
# §override_config ≈L83-100), plus gamma, which the reference restores with
# the model state. data_path is not here: an explicit --data_path wins, the
# saved one is only the fallback.
OVERRIDE_KEYS = (
    "countries",
    "model",
    "double_entity_embedding",
    "double_relation_embedding",
    "hidden_dim",
    "gamma",
    "test_batch_size",
)
# the leaf whose rows (and its moments' rows) the shard files split
ROW_SHARDED = "entity_embedding"


def override_config(config: RunConfig) -> RunConfig:
    """Apply the saved model hyperparameters on resume while keeping the
    rest of the CLI args (codes/run.py §override_config)."""
    with open(os.path.join(config.init_checkpoint, "config.json")) as f:
        saved = json.load(f)
    for k in OVERRIDE_KEYS:
        if k in saved:
            setattr(config, k, saved[k])
    if config.data_path is None:
        config.data_path = saved.get("data_path")
    return config


@dataclasses.dataclass
class Checkpoint:
    params: kge.Params
    adam_m: Dict[str, np.ndarray]
    adam_v: Dict[str, np.ndarray]
    adam_count: int
    step: int
    current_learning_rate: float
    warm_up_steps: int


def _atomic_write(path: str, write_fn) -> None:
    """Temp file + os.replace: a crash mid-save never leaves a truncated
    artifact, so the last checkpoint is always a complete one."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write_fn(f)
    os.replace(tmp, path)


def save_config(config: RunConfig, save_path: str) -> None:
    os.makedirs(save_path, exist_ok=True)
    payload = json.dumps(dataclasses.asdict(config), indent=2).encode()
    _atomic_write(os.path.join(save_path, "config.json"), lambda f: f.write(payload))


def _host(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Host copies now, on the calling thread (a synchronous save)."""
    return {k: t.detach().cpu().numpy() for k, t in tensors.items()}


def _state_tensors(params, opt_state: optim.AdamState) -> Dict[str, torch.Tensor]:
    """Every tensor of a save under its npz key, in the npz order; the Adam
    step count, a device tensor, is ``adam_count``."""
    out = {"adam_count": opt_state.steps}
    for prefix, tree in (("param", params), ("adam_m", opt_state.m), ("adam_v", opt_state.v)):
        for name, t in tree.items():
            out[f"{prefix}.{name}"] = t
    return out


def _flatten(host: Dict[str, np.ndarray], step: int, lr: float, warm_up_steps: int) -> dict:
    """The checkpoint's key layout and dtypes, as the JAX package's
    ``_flatten`` writes them, from the host copies of ``_state_tensors``."""
    return {"step": np.int64(step), "current_learning_rate": np.float64(lr),
            "warm_up_steps": np.int64(warm_up_steps), **host}


def _write_artifacts(arrays: dict, config: RunConfig, save_path: str) -> None:
    save_config(config, save_path)
    _atomic_write(os.path.join(save_path, "checkpoint.npz"),
                  lambda f: np.savez(f, **arrays))
    for name in ("entity_embedding", "relation_embedding"):
        _atomic_write(os.path.join(save_path, f"{name}.npy"),
                      lambda f, a=arrays[f"param.{name}"]: np.save(f, a))


class _Snapshot:
    """Clones of tensors as they stand on the current stream at
    construction, bound for the host. ``pull`` runs on the writer thread."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self._clones = {k: t.detach().clone() for k, t in tensors.items()}
        self._ready = None
        self._device = next(iter(tensors.values())).device
        if self._device.type == "cuda":
            self._ready = torch.cuda.Event()
            self._ready.record(torch.cuda.current_stream(self._device))

    def pull(self) -> Dict[str, np.ndarray]:
        """The clones on the host. On CUDA a side stream waits for the
        clones, copies them into pinned buffers and marks the clones used on
        it, so the caching allocator hands their memory out again only after
        the copies."""
        clones, self._clones = self._clones, None
        if self._ready is None:
            return {k: c.numpy() for k, c in clones.items()}
        with torch.cuda.device(self._device):
            side = torch.cuda.Stream()
            side.wait_event(self._ready)
            host = {}
            with torch.cuda.stream(side):
                for k, c in clones.items():
                    host[k] = torch.empty(c.shape, dtype=c.dtype, pin_memory=True)
                    host[k].copy_(c, non_blocking=True)
                    c.record_stream(side)
                done = torch.cuda.Event()
                done.record(side)
        del clones
        done.synchronize()
        return {k: h.numpy() for k, h in host.items()}


class _PendingSave:
    """A background write: its thread, the error it raised, and its wall
    time in seconds once done."""

    def __init__(self, write):
        self.error: Optional[BaseException] = None
        self.seconds: Optional[float] = None
        self.thread = threading.Thread(target=self._run, args=(write,), name="kge-ckpt-writer")
        self.thread.start()

    def _run(self, write) -> None:
        t0 = time.perf_counter()
        try:
            write()
        except BaseException as e:  # surfaced by wait_for_pending_save / check_pending_save
            self.error = e
        self.seconds = time.perf_counter() - t0


# at most one save in flight; the next save (or interpreter exit, or an
# explicit wait) joins it first, so artifacts are always written in order
_pending: Optional[_PendingSave] = None


def wait_for_pending_save() -> Optional[float]:
    """Join the in-flight background save, if any, and re-raise its failure:
    a swallowed ENOSPC or permission error would let training run on
    believing checkpoints exist. Returns the write's wall time in seconds
    (None when nothing was in flight)."""
    global _pending
    pending, _pending = _pending, None
    if pending is None:
        return None
    pending.thread.join()
    if pending.error is not None:
        raise RuntimeError("background checkpoint write failed") from pending.error
    return pending.seconds


def check_pending_save() -> None:
    """Raise a background save's failure at once, without joining a healthy
    write still in flight. The train loops poll it at every log window, so a
    failed write aborts within one log interval."""
    global _pending
    pending = _pending
    if pending is not None and pending.error is not None:
        _pending = None
        raise RuntimeError("background checkpoint write failed") from pending.error


atexit.register(wait_for_pending_save)


def _start_write(write) -> None:
    global _pending
    _pending = _PendingSave(write)


def save_model(trainer, config: RunConfig, save_path: str, asynchronous: bool = False) -> None:
    """config.json, checkpoint.npz and the two .npy table exports of the
    trainer's current state (codes/run.py §save_model). ``asynchronous``
    (a trainer with ``supports_async_checkpoint``): snapshot on the device
    and return; the pull and the writes run on a background thread, and the
    artifacts equal a synchronous save's at the same step, bit for bit."""
    wait_for_pending_save()  # serialize with any in-flight save
    # host values now; the Adam count travels in the snapshot (reading it
    # here would wait for the device)
    step, lr, warm_up = trainer.step, trainer.current_learning_rate, trainer.warm_up_steps
    if getattr(trainer, "mesh", None) is not None:
        # a mesh trainer gathers its state on every rank (a collective);
        # global rank 0 writes it, as the JAX package's process 0 does
        params, opt_state = trainer.gathered_state()
        if process_layout()[0] != 0:
            return
    else:
        params, opt_state = trainer.params, trainer.opt_state
    tensors = _state_tensors(params, opt_state)
    if not (asynchronous and getattr(trainer, "supports_async_checkpoint", False)):
        _write_artifacts(_flatten(_host(tensors), step, lr, warm_up), config, save_path)
        return
    snap, config = _Snapshot(tensors), dataclasses.replace(config)
    _start_write(lambda: _write_artifacts(_flatten(snap.pull(), step, lr, warm_up),
                                          config, save_path))


def save_initial_checkpoint(params: kge.Params, config: RunConfig,
                            save_path: str, warm_up_steps: int) -> None:
    """The artifacts of a step-0 save: the params, zero Adam moments and
    ``adam_count`` 0, as the JAX trainer would save before its first step."""
    tensors = _state_tensors(params, optim.init_state(params))
    _write_artifacts(_flatten(_host(tensors), 0, config.learning_rate, warm_up_steps),
                     config, save_path)


# ---------------------------------------------------------------------------
# Sharded checkpoints (JAX checkpoint.py §save_model_sharded, §_load_sharded,
# §_BlockCatalog): per-process block files, no gather on save; any process
# count reassembles them, a single process included.

Bounds = Sequence[int]  # [r0, r1, c0, c1] of a block in its global array
# per sharded key: (global shape, [(block, bounds), ...] of this process)
Blocks = Dict[str, Tuple[Tuple[int, ...], List[Tuple[torch.Tensor, Bounds]]]]


def _shard_suffix(p: int, n: int) -> str:
    return f"shard{p:05d}-of-{n:05d}.npz"


def _index_bounds(index, shape) -> np.ndarray:
    """(slice, slice) -> [r0, r1, c0, c1] with Nones resolved."""
    r, c = index
    return np.asarray(
        [r.start or 0, shape[0] if r.stop is None else r.stop,
         c.start or 0, shape[1] if c.stop is None else c.stop], np.int64)


def process_layout(process_index: Optional[int] = None,
                   process_count: Optional[int] = None) -> Tuple[int, int]:
    """(p, n): rank and world size of the initialized ``torch.distributed``
    group, else 0 and 1; an explicit argument overrides either."""
    p, n = 0, 1
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        p, n = torch.distributed.get_rank(), torch.distributed.get_world_size()
    return (p if process_index is None else process_index,
            n if process_count is None else process_count)


def row_blocks(trainer, p: int, n: int) -> Blocks:
    """Process p's block of a single-device trainer: rows
    [p ceil(E/n), (p+1) ceil(E/n)) of the entity table and of its two
    moments (none when p's range lies past the last row)."""
    st = trainer.opt_state
    out: Blocks = {}
    for prefix, t in (("param", trainer.params[ROW_SHARDED]), ("adam_m", st.m[ROW_SHARDED]),
                      ("adam_v", st.v[ROW_SHARDED])):
        per = -(-t.shape[0] // n)
        r0, r1 = min(p * per, t.shape[0]), min((p + 1) * per, t.shape[0])
        idx = (slice(r0, r1), slice(None))
        out[f"{prefix}.{ROW_SHARDED}"] = (tuple(t.shape),
                                          [(t[idx], _index_bounds(idx, t.shape))] if r1 > r0
                                          else [])
    return out


def _sharded_state_arrays(host: Dict[str, np.ndarray], keys: Sequence[str],
                          shapes: Dict[str, Tuple[int, ...]], bounds: Dict[str, list],
                          step: int, lr: float, warm_up: int, nentity: int,
                          n: int) -> Tuple[dict, dict]:
    """(local, meta) as JAX's ``_sharded_state_arrays`` lays them out. The
    step is stamped into every shard file as well as the meta npz: a file
    replace is atomic, a multi-file save is not, so a fleet stopped mid-save
    can leave files of two saves, which the load path refuses."""
    local: dict = {"step": np.int64(step)}
    meta: dict = {
        "sharded_shards": np.int64(n),
        "nentity": np.int64(nentity),
        "step": np.int64(step),
        "current_learning_rate": np.float64(lr),
        "warm_up_steps": np.int64(warm_up),
        "adam_count": host["adam_count"],
    }
    for key in keys:
        if key in shapes:
            meta[f"shape:{key}"] = np.asarray(shapes[key], np.int64)
            for i, b in enumerate(bounds[key]):
                local[f"{key}:block{i}"] = host[f"{key}:block{i}"]
                local[f"{key}:index{i}"] = np.asarray(b, np.int64)
        else:
            meta[key] = host[key]
    return local, meta


def _write_sharded_files(local: dict, meta: dict, config: RunConfig, save_path: str,
                         p: int, n: int) -> None:
    os.makedirs(save_path, exist_ok=True)
    _atomic_write(os.path.join(save_path, "checkpoint." + _shard_suffix(p, n)),
                  lambda f: np.savez(f, **local))
    if p == 0:
        save_config(config, save_path)
        _atomic_write(os.path.join(save_path, "checkpoint.npz"),
                      lambda f: np.savez(f, **meta))


def save_model_sharded(trainer, config: RunConfig, save_path: str, asynchronous: bool = False,
                       *, blocks: Optional[Blocks] = None, process_index: Optional[int] = None,
                       process_count: Optional[int] = None) -> None:
    """This process's shard file, and on process 0 the meta npz and
    config.json. ``blocks`` are the row blocks this process holds, per
    sharded key (``param.entity_embedding``, ``adam_m.*``, ``adam_v.*``) its
    global shape and ``(tensor, [r0, r1, c0, c1])`` pairs; by default a
    mesh trainer's own (``ShardedTrainer.row_blocks``), else ``row_blocks``. Every other leaf is replicated and goes to the meta npz.
    ``process_index``/``process_count`` default to ``process_layout()``.
    ``asynchronous`` snapshots the blocks and leaves on the device and
    writes on the background thread, as ``save_model`` does; no collective
    is involved either way."""
    wait_for_pending_save()
    p, n = process_layout(process_index, process_count)
    if blocks is None:
        blocks = (trainer.row_blocks() if getattr(trainer, "mesh", None) is not None
                  else row_blocks(trainer, p, n))
    step, lr, warm_up = trainer.step, trainer.current_learning_rate, trainer.warm_up_steps
    state = _state_tensors(trainer.params, trainer.opt_state)
    keys = [k for k in state if k != "adam_count"]
    tensors = {k: t for k, t in state.items() if k not in blocks}
    for key, (_, pairs) in blocks.items():
        for i, (t, _) in enumerate(pairs):
            tensors[f"{key}:block{i}"] = t
    shapes = {k: tuple(int(x) for x in shape) for k, (shape, _) in blocks.items()}
    bounds = {k: [b for _, b in pairs] for k, (_, pairs) in blocks.items()}
    nentity, cfg = trainer.spec.nentity, dataclasses.replace(config)

    def write(host):
        local, meta = _sharded_state_arrays(host, keys, shapes, bounds, step, lr, warm_up,
                                            nentity, n)
        _write_sharded_files(local, meta, cfg, save_path, p, n)

    if not asynchronous:
        write(_host(tensors))
        return
    snap = _Snapshot(tensors)
    _start_write(lambda: write(snap.pull()))


def is_sharded_checkpoint(path: str) -> bool:
    try:
        with np.load(os.path.join(path, "checkpoint.npz")) as z:
            return "sharded_shards" in z.files
    except OSError:
        return False


class _BlockCatalog:
    """Lazy index over a sharded checkpoint's block files. npz members
    decompress on access, so building the catalog reads only the ``:index``
    arrays and the step stamps; ``fill_slice`` reads the blocks a slice
    intersects. Closes its files on ``close`` or at the end of a ``with``."""

    def __init__(self, path: str, n: int, expect_step: int):
        self._files: dict = {}
        self._entries: dict = {}  # key -> [(r0, r1, c0, c1, fname, blockkey)]
        try:
            for p in range(n):
                fname = os.path.join(path, "checkpoint." + _shard_suffix(p, n))
                z = self._files[fname] = np.load(fname)
                if int(z["step"]) != expect_step:
                    raise RuntimeError(
                        f"sharded checkpoint is inconsistent: {fname} is from step "
                        f"{int(z['step'])} but checkpoint.npz says step {expect_step}; "
                        "a process was likely stopped mid-save: resume from an older "
                        "consistent checkpoint instead of mixing saves")
                for bk in z.files:
                    if ":block" not in bk:
                        continue
                    key, bi = bk.rsplit(":block", 1)
                    r0, r1, c0, c1 = (int(x) for x in z[f"{key}:index{bi}"])
                    self._entries.setdefault(key, []).append((r0, r1, c0, c1, fname, bk))
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        for z in self._files.values():
            z.close()
        self._files = {}

    def __enter__(self) -> "_BlockCatalog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def validate_coverage(self, key: str, saved_shape) -> None:
        """Index-only completeness check (no payload reads): the disjoint
        blocks must tile the saved array exactly."""
        total = sum((r1 - r0) * (c1 - c0) for r0, r1, c0, c1, _, _ in self._entries.get(key, []))
        want = int(np.prod(saved_shape))
        if total != want:
            raise RuntimeError(
                f"sharded checkpoint block coverage for {key}: {total} of {want} elements "
                "indexed across the shard files; a shard file is missing blocks (corrupt "
                "or layout-mismatched save)")

    def fill_slice(self, key: str, idx, out_shape, dtype=None) -> np.ndarray:
        """The slice ``idx`` (two slices) of the global array of shape
        ``out_shape``, from the blocks it intersects; rows beyond the saved
        extent are zeros (mesh padding rows are zero by contract). ``dtype``
        defaults to the blocks' own."""
        r, c = idx
        r0t, r1t = r.start or 0, out_shape[0] if r.stop is None else r.stop
        c0t, c1t = c.start or 0, out_shape[1] if c.stop is None else c.stop
        out = None if dtype is None else np.zeros((r1t - r0t, c1t - c0t), dtype)
        for br0, br1, bc0, bc1, fname, bk in self._entries.get(key, []):
            ir0, ir1 = max(br0, r0t), min(br1, r1t)
            ic0, ic1 = max(bc0, c0t), min(bc1, c1t)
            if ir0 < ir1 and ic0 < ic1:
                block = self._files[fname][bk]
                if out is None:
                    out = np.zeros((r1t - r0t, c1t - c0t), block.dtype)
                out[ir0 - r0t:ir1 - r0t, ic0 - c0t:ic1 - c0t] = (
                    block[ir0 - br0:ir1 - br0, ic0 - bc0:ic1 - bc0])
        if out is None:
            raise ValueError(f"no saved block of {key} meets rows {r0t}:{r1t}, columns "
                             f"{c0t}:{c1t}; pass dtype")
        return out


def _load_sharded(path: str, meta, keys: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    """A sharded checkpoint's arrays in the single-file key layout, the
    entity rows cut to ``nentity`` (mesh padding stripped). Every shard
    file's step stamp is checked; ``keys`` limits the arrays read."""
    n, nentity, step = int(meta["sharded_shards"]), int(meta["nentity"]), int(meta["step"])
    out: Dict[str, np.ndarray] = {}
    with _BlockCatalog(path, n, step) as cat:
        for mk in meta.files:
            key = mk[len("shape:"):] if mk.startswith("shape:") else mk
            if key in ("sharded_shards", "nentity") or (keys is not None and key not in keys):
                continue
            if mk.startswith("shape:"):
                shape = tuple(int(x) for x in meta[mk])
                cat.validate_coverage(key, shape)
                val = cat.fill_slice(key, (slice(None), slice(None)), shape)
            else:
                val = meta[mk]
            if key.partition(".")[2] == ROW_SHARDED:
                val = val[:nentity]
            out[key] = val
    return out


def read_arrays(path: str, keys: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    """The arrays of the checkpoint in ``path`` as numpy, keyed as the
    single-file ``checkpoint.npz``, from either layout (a sharded one
    reassembled). ``keys`` limits what is read; nothing goes to a device."""
    with np.load(os.path.join(path, "checkpoint.npz")) as z:
        if "sharded_shards" in z.files:
            return _load_sharded(path, z, keys)
        return {k: z[k] for k in z.files if keys is None or k in keys}


def load_checkpoint(path: str, device) -> Checkpoint:
    """Read the checkpoint in ``path``, single-file or sharded; params go
    to ``device``."""
    arrays = read_arrays(path)
    groups: Dict[str, Dict[str, np.ndarray]] = {"param": {}, "adam_m": {}, "adam_v": {}}
    for key, val in arrays.items():
        prefix, _, name = key.partition(".")
        if prefix in groups and name:
            groups[prefix][name] = val
    return Checkpoint(
        params=kge.params_from_numpy(groups["param"], device),
        adam_m=groups["adam_m"],
        adam_v=groups["adam_v"],
        adam_count=int(arrays["adam_count"]),
        step=int(arrays["step"]),
        current_learning_rate=float(arrays["current_learning_rate"]),
        warm_up_steps=int(arrays["warm_up_steps"]),
    )


def restore_trainer_sharded(trainer, path: str):
    """PROCESS-LOCAL restore of a mesh trainer (``parallel.sharding.
    ShardedTrainer``, ``FusedMeshTrainer``) from a sharded checkpoint (JAX
    ``checkpoint.py:482-565``): each rank reads only the blocks its own
    rows and columns intersect (``_BlockCatalog.fill_slice``); no rank holds
    or reads the full table. The saved process count and padding may differ
    from the mesh's: blocks are addressed by global bounds, and rows past
    the saved extent are zeros (padding rows are zero by contract)."""
    from .parallel.sharding import ENTITY, block_slices, data_size, is_model_sharded, model_size

    mesh = trainer.mesh
    device = trainer.params[ENTITY].device
    with np.load(os.path.join(path, "checkpoint.npz")) as meta:
        if "sharded_shards" not in meta.files:
            raise ValueError(f"{path} is not a sharded checkpoint; use load_checkpoint")
        step = int(meta["step"])
        with _BlockCatalog(path, int(meta["sharded_shards"]), step) as cat:
            def restore(prefix, tree):
                out = {}
                for name, t in tree.items():
                    key = f"{prefix}.{name}"
                    shape = list(t.shape)
                    if name == ENTITY:
                        shape[0] *= data_size(mesh)
                    if is_model_sharded(mesh) and t.dim() == 2:
                        shape[1] *= model_size(mesh)
                    idx = block_slices(name, shape, mesh)
                    if f"shape:{key}" in meta.files:
                        cat.validate_coverage(key, tuple(int(x) for x in meta[f"shape:{key}"]))
                        arr = cat.fill_slice(key, idx or (slice(None), slice(None)), shape,
                                             torch.empty(0, dtype=t.dtype).numpy().dtype)
                    else:
                        arr = np.asarray(meta[key])
                        arr = arr[idx] if idx is not None else arr
                    out[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
                return out

            params = restore("param", trainer.params)
            m, v = restore("adam_m", trainer.opt_state.m), restore("adam_v", trainer.opt_state.v)
            count = int(meta["adam_count"])
            lr, warm_up = float(meta["current_learning_rate"]), int(meta["warm_up_steps"])
    trainer.params = {k: p.requires_grad_(True) for k, p in params.items()}
    trainer.opt_state = optim.AdamState(
        steps=torch.tensor(count, dtype=torch.int32, device=device), m=m, v=v)
    trainer.step = step
    trainer.current_learning_rate = lr
    trainer.warm_up_steps = warm_up
    return trainer


def restore_trainer(trainer, path: str):
    """Restore a ``train.Trainer`` in place from a checkpoint directory (the
    reference's ``-init``: model, optimizer state, step, lr and warm-up)."""
    device = trainer.params["entity_embedding"].device
    ck = load_checkpoint(path, device)
    trainer.params = kge.trainable(ck.params)
    trainer.opt_state = optim.state_from_numpy(ck.adam_count, ck.adam_m, ck.adam_v, device)
    trainer.step = ck.step
    trainer.current_learning_rate = ck.current_learning_rate
    trainer.warm_up_steps = ck.warm_up_steps
    return trainer
