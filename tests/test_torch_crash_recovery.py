"""Failure recovery through the port's CLI (the counterpart of
tests/test_crash_recovery.py): a training process with asynchronous
periodic saves is killed with SIGKILL once its first checkpoint exists; the
checkpoint on disk is complete (saves replace files atomically), and a
``-init`` rerun resumes at its step and finishes, for the per-step and the
fused loop. The killed run's checkpoint also loads in the JAX package."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from knowledgegraphembedding_torch import checkpoint as t_ckpt
from knowledgegraphembedding_tpu import checkpoint as j_ckpt

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("extra,model", [([], ["--model", "TransE"]),
                                         (["--steps_per_dispatch", "8",
                                           "--sampler_backend", "device"],
                                          ["--model", "RotatE", "-de"])],
                         ids=["per-step", "fused"])
def test_sigkill_after_an_async_save_then_resume(tmp_path, extra, model):
    save_dir = str(tmp_path / "save")
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="1")
    args = [sys.executable, "-m", "knowledgegraphembedding_torch.cli", "--do_train",
            "--data_path", "synthetic:clustered", *model, "-n", "4", "-b", "16", "-d", "8",
            "-g", "4.0", "-lr", "0.01", "--platform", "cpu", "--log_steps", "20",
            "--save_checkpoint_steps", "40", "-save", save_dir, *extra]
    proc = subprocess.Popen(args + ["--max_steps", "100000"], env=env,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    ckpt = os.path.join(save_dir, "checkpoint.npz")
    deadline = time.time() + 120
    try:
        while not os.path.exists(ckpt):
            assert proc.poll() is None, "the trainer died before its first checkpoint"
            assert time.time() < deadline, "no checkpoint within 120 s"
            time.sleep(0.2)
    finally:
        proc.kill()  # SIGKILL: no cleanup, no atexit join of the writer
        proc.wait(timeout=30)

    saved = t_ckpt.load_checkpoint(save_dir, "cpu")  # complete, whatever the kill hit
    assert saved.step % 40 == 0 and saved.step >= 40
    assert saved.adam_count == saved.step  # no decay before step 50000
    assert j_ckpt.load_checkpoint(save_dir)[2] == saved.step

    out = subprocess.run(args + ["--max_steps", str(saved.step + 24), "--do_test",
                                 "--test_batch_size", "8", "-init", save_dir],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    log = out.stderr + out.stdout
    assert f"init_step = {saved.step}" in log  # resumed, not restarted
    assert "Test MRR" in log
    with np.load(ckpt) as z:
        assert int(z["step"]) == saved.step + 24
