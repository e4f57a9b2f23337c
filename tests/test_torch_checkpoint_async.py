"""Asynchronous saves of the port (knowledgegraphembedding_torch/checkpoint.py)
on the CPU: an async save followed at once by more in-place steps writes the
artifacts of a synchronous save at the same step, bit for bit, for the eager
Trainer and the FusedDeviceTrainer; a failed background write surfaces
through wait_for_pending_save, check_pending_save and the CLI's train loop;
the port's async artifacts load in the JAX package's load_checkpoint with
equal arrays and equal the files the JAX async writer makes of the same
state; and the CLI's async and sync periodic saves leave equal artifacts."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from knowledgegraphembedding_torch import checkpoint as t_ckpt
from knowledgegraphembedding_torch import cli as t_cli
from knowledgegraphembedding_torch.config import RunConfig as TRunConfig
from knowledgegraphembedding_torch.fused_train import FusedDeviceTrainer
from knowledgegraphembedding_torch.models import kge as t_kge
from knowledgegraphembedding_torch.train import Trainer
from knowledgegraphembedding_tpu import checkpoint as j_ckpt
from knowledgegraphembedding_tpu import train as j_train
from knowledgegraphembedding_tpu.config import RunConfig as JRunConfig
from knowledgegraphembedding_tpu.data.filterset import FilterSets
from knowledgegraphembedding_tpu.data.synthetic import make_clustered_kg
from knowledgegraphembedding_tpu.sampler import build_train_iterator

CFG = dict(model="RotatE", double_entity_embedding=True, hidden_dim=8, gamma=6.0,
           negative_sample_size=4, batch_size=16, negative_adversarial_sampling=True,
           learning_rate=0.01, data_path="synthetic:clustered")


@pytest.fixture(scope="module")
def setup():
    """(the dataset, host batches, the JAX and port configs, numpy params)."""
    ds = make_clustered_kg(n_clusters=4, entities_per_cluster=6, nrelation=2, seed=2)
    filters = FilterSets.build(ds.train, ds.all_true_triples, ds.nentity, ds.nrelation)
    it = build_train_iterator(ds.train, ds.nentity, ds.nrelation, 16, 4, filters,
                              seed=0, prefetch_depth=0, backend="numpy")
    batches = [next(it) for _ in range(10)]
    cfgs = []
    for cls in (JRunConfig, TRunConfig):
        cfg = cls(**CFG)
        cfg.nentity, cfg.nrelation = ds.nentity, ds.nrelation
        cfgs.append(cfg)
    rng = np.random.default_rng(0)
    r = cfgs[1].model_spec().embedding_range
    p0 = {"entity_embedding": rng.uniform(-r, r, (ds.nentity, 16)).astype(np.float32),
          "relation_embedding": rng.uniform(-r, r, (ds.nrelation, 8)).astype(np.float32)}
    return ds, batches, cfgs[0], cfgs[1], p0


@pytest.fixture(autouse=True)
def no_save_left_pending():
    yield
    t_ckpt.wait_for_pending_save()


def _eager(tcfg, p0, batches):
    tr = Trainer(tcfg.model_spec(), tcfg.train_spec(), t_kge.params_from_numpy(p0, "cpu"),
                 lr=tcfg.learning_rate, warm_up_steps=10**9)

    def advance(bs):
        for pos, neg, w, mode in bs:
            tr.one_step((torch.from_numpy(pos), torch.from_numpy(neg), torch.from_numpy(w),
                         mode))
    return tr, advance


def _fused(ds, tcfg, p0):
    tr = FusedDeviceTrainer(tcfg.model_spec(), tcfg.train_spec(),
                            t_kge.params_from_numpy(p0, "cpu"), lr=tcfg.learning_rate,
                            warm_up_steps=10**9, train=ds.train, seed=0, block_capacity=5)

    def advance(bs):
        tr.run_block(len(bs))
    return tr, advance


def _files(path):
    """{name: {member: array}} of every artifact but config.json."""
    out = {}
    for f in sorted(os.listdir(path)):
        if f.endswith(".npz"):
            with np.load(os.path.join(path, f)) as z:
                out[f] = {k: z[k] for k in z.files}
        elif f.endswith(".npy"):
            out[f] = {"": np.load(os.path.join(path, f))}
    return out


def assert_same_files(a_dir, b_dir):
    """Members in order, dtypes, shapes and bytes."""
    a, b = _files(a_dir), _files(b_dir)
    assert list(a) == list(b)
    for f in a:
        assert list(a[f]) == list(b[f]), f
        for k in a[f]:
            x, y = a[f][k], b[f][k]
            assert (x.dtype, x.shape) == (y.dtype, y.shape), (f, k)
            assert x.tobytes() == y.tobytes(), (f, k)


@pytest.mark.parametrize("kind", ["eager", "fused"])
def test_async_save_then_in_place_steps_equals_sync_save(setup, tmp_path, kind):
    ds, batches, _, tcfg, p0 = setup
    tr, advance = _eager(tcfg, p0, batches) if kind == "eager" else _fused(ds, tcfg, p0)
    advance(batches[:5])
    t_ckpt.save_model(tr, tcfg, str(tmp_path / "sync"))
    state = {k: v.detach().clone() for k, v in tr.params.items()}
    t_ckpt.save_model(tr, tcfg, str(tmp_path / "async"), asynchronous=True)
    advance(batches[5:])  # in place while the writer runs
    seconds = t_ckpt.wait_for_pending_save()
    assert seconds is not None and seconds > 0
    assert not all(torch.equal(state[k], tr.params[k]) for k in state)  # the state moved on
    assert_same_files(str(tmp_path / "sync"), str(tmp_path / "async"))
    with np.load(tmp_path / "async" / "checkpoint.npz") as z:
        assert int(z["step"]) == 5 and int(z["adam_count"]) == 5
        for k, v in state.items():
            np.testing.assert_array_equal(z[f"param.{k}"], v.numpy())
    assert t_ckpt.wait_for_pending_save() is None  # nothing left in flight


def _write_into_a_file(tr, tcfg, tmp_path):
    """An async save whose directory is a file: the write fails on the
    writer thread."""
    blocker = tmp_path / "blocker"
    blocker.write_text("")
    t_ckpt.save_model(tr, tcfg, str(blocker / "sub"), asynchronous=True)


def test_writer_failure_raises_at_wait(setup, tmp_path):
    _, batches, _, tcfg, p0 = setup
    tr, _ = _eager(tcfg, p0, batches)
    _write_into_a_file(tr, tcfg, tmp_path)
    with pytest.raises(RuntimeError, match="background checkpoint write failed"):
        t_ckpt.wait_for_pending_save()
    assert t_ckpt.wait_for_pending_save() is None  # the error is consumed


def test_check_pending_save_raises_without_joining(setup, tmp_path):
    _, batches, _, tcfg, p0 = setup
    tr, _ = _eager(tcfg, p0, batches)
    t_ckpt.check_pending_save()  # nothing pending: a no-op
    t_ckpt.save_model(tr, tcfg, str(tmp_path / "ok"), asynchronous=True)
    t_ckpt.check_pending_save()  # a healthy write in flight is not joined, nor raised
    t_ckpt.wait_for_pending_save()
    _write_into_a_file(tr, tcfg, tmp_path)
    t_ckpt._pending.thread.join(timeout=60)  # let the failure land
    assert not t_ckpt._pending.thread.is_alive()
    with pytest.raises(RuntimeError, match="background checkpoint write failed"):
        t_ckpt.check_pending_save()
    t_ckpt.check_pending_save()  # consumed
    assert t_ckpt.wait_for_pending_save() is None


def test_async_artifacts_load_in_jax_and_equal_its_async_files(setup, tmp_path):
    ds, batches, jcfg, tcfg, p0 = setup
    tr, advance = _eager(tcfg, p0, batches)
    advance(batches[:4])
    port = str(tmp_path / "port")
    at_save = {k: [t.detach().clone() for t in (tr.params[k], tr.opt_state.m[k],
                                                 tr.opt_state.v[k])] for k in p0}
    t_ckpt.save_model(tr, tcfg, port, asynchronous=True)
    advance(batches[4:])
    t_ckpt.wait_for_pending_save()

    params, state, step, lr, warm_up = j_ckpt.load_checkpoint(port)
    assert (step, lr, warm_up, int(state.count)) == (4, 0.01, 10**9, 4)
    for k, (p, m, v) in at_save.items():
        np.testing.assert_array_equal(np.asarray(params[k]), p.numpy())
        np.testing.assert_array_equal(np.asarray(state.m[k]), m.numpy())
        np.testing.assert_array_equal(np.asarray(state.v[k]), v.numpy())

    # the JAX package's own async writer on the same state: the same files
    jt = j_train.Trainer(jcfg.model_spec(), jcfg.train_spec(),
                         {k: jnp.zeros_like(jnp.asarray(v)) for k, v in p0.items()},
                         lr=1.0, warm_up_steps=0)
    j_ckpt.restore_trainer(jt, port)
    j_ckpt.save_model(jt, jcfg, str(tmp_path / "jax"), asynchronous=True)
    j_ckpt.wait_for_pending_save()
    assert_same_files(port, str(tmp_path / "jax"))


@pytest.mark.parametrize("extra", [[], ["--steps_per_dispatch", "4",
                                        "--sampler_backend", "device"]],
                         ids=["per-step", "fused"])
def test_cli_async_and_sync_saves_leave_equal_artifacts(tmp_path, extra):
    """Periodic saves every 8 steps, async by default: the same final
    artifacts and metrics as --no-async_checkpoint."""
    argv = ["--do_train", "--do_test", "--data_path", "synthetic:clustered", "--model",
            "RotatE", "-de", "-n", "4", "-b", "16", "-d", "8", "-g", "4.0", "-adv", "-lr",
            "0.01", "--max_steps", "24", "--log_steps", "8", "--save_checkpoint_steps", "8",
            "--test_batch_size", "8", "--platform", "cpu", *extra]
    got = {}
    for mode in ("--async_checkpoint", "--no-async_checkpoint"):
        got[mode] = t_cli.main(argv + [mode, "-save", str(tmp_path / mode)])
    assert got["--async_checkpoint"] == got["--no-async_checkpoint"]
    assert_same_files(str(tmp_path / "--async_checkpoint"),
                      str(tmp_path / "--no-async_checkpoint"))


def test_cli_aborts_on_a_failed_background_write(tmp_path, monkeypatch):
    """A periodic async save whose write fails stops the train loop at the
    next log window (check_pending_save) or save, before the final save."""
    calls = []

    def failing(arrays, config, save_path):
        calls.append(int(arrays["step"]))
        raise OSError("disk full")

    monkeypatch.setattr(t_ckpt, "_write_artifacts", failing)
    with pytest.raises(RuntimeError, match="background checkpoint write failed"):
        t_cli.main(["--do_train", "--data_path", "synthetic:clustered", "--model", "TransE",
                    "-n", "4", "-b", "16", "-d", "8", "--max_steps", "40", "--log_steps", "10",
                    "--save_checkpoint_steps", "5", "--platform", "cpu",
                    "-save", str(tmp_path / "s")])
    assert calls == [5]  # the save at step 10 joined the failed one and raised


def test_back_to_back_async_saves_under_thread_switching(setup, tmp_path):
    """Twenty async saves, each followed at once by an in-place step, with
    the interpreter switching threads every microsecond: every save holds
    the state of its own step (a torn or reordered snapshot would not)."""
    import sys

    _, batches, _, tcfg, p0 = setup
    tr, advance = _eager(tcfg, p0, batches)
    want = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for i in range(20):
            want[i] = tr.params["entity_embedding"].detach().clone()
            t_ckpt.save_model(tr, tcfg, str(tmp_path / str(i)), asynchronous=True)
            advance(batches[i % len(batches):][:1])
        t_ckpt.wait_for_pending_save()
    finally:
        sys.setswitchinterval(interval)
    for i, table in want.items():
        with np.load(tmp_path / str(i) / "checkpoint.npz") as z:
            assert int(z["step"]) == i and int(z["adam_count"]) == i
            np.testing.assert_array_equal(z["param.entity_embedding"], table.numpy())
