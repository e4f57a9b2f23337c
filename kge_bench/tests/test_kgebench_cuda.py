"""The output check on the card at the cells' own sizes: sound runs are
correct, and each control fails. Needs a CUDA card (``-m cuda``); skips
without one.

    python -m pytest -p no:cacheprovider -m cuda kge_bench/tests/test_kgebench_cuda.py
"""

import time

import pytest

from conftest import CELLS


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _run(card, cell, **kw):
    from kge_bench import run

    return run.run(cell, 2147486001, 1.0, False, card, t0=time.perf_counter(), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_the_reference_control_fails(card, cell):
    r = _run(card, cell, controls=True)
    assert r["correct"], r["checks"]
    control = {k[len("control."):]: v for k, v in r["readings"].items()
               if k.startswith("control.")}
    if control:  # the reference in the lower precision, read beside the run
        assert any(control[k] > c["limit"] for k, c in r["checks"].items() if k in control)


@pytest.mark.cuda
def test_rotate_train_bf16_control_is_not_correct(card):
    r = _run(card, "rotate_fb15k237.train", overrides={"precision": "bf16"})
    assert not r["correct"], r["checks"]
