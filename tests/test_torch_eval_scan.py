"""The port's whole-evaluation scan driver (``eval.split_ranks`` with the
device-resident filter: batches stacked on the device and ranked in chunks
of up to ``_SCAN_CHUNK``; eagerly on the CPU, from CUDA graphs on the card)
against the JAX package's scan drivers on the same numpy inputs (CPU):

  - the chunks: the port ranks the same [SC, B, 3] chunks, pad batches
    included, that JAX's ``test_step`` hands ``_eval_scan_xla``;
  - the ranks, exactly: ``_eval_scan_plain`` against ``_eval_scan_xla``
    called per chunk, and for the distance family ``_eval_scan_kernel``
    (the rank kernel's plain version here) against ``_eval_scan_pallas``
    on a ``PallasRanker(TE=32, interpret=True)``;
  - the metrics within 1e-9 of JAX's ``test_step(device_filter=True)``, and
    the same "Evaluating the model..." lines in the same order.

Split sizes give nb in {1, 31, 32, 33, 65} batches (the last one ragged),
crossed with --test_log_steps in {0, 1, 5, 1000}, which bounds the chunk,
and --test_batch_size in {5, 16}, below the distance family's floor of 16
and the bilinear models' 128."""

import functools
import logging

import numpy as np
import pytest

import jax.numpy as jnp

from knowledgegraphembedding_torch import cuda_graphs
from knowledgegraphembedding_torch import eval as t_eval
from knowledgegraphembedding_torch.config import ModelSpec as TSpec
from knowledgegraphembedding_torch.data.filterset import FilterSets as TFilterSets
from knowledgegraphembedding_torch.models import kge as t_kge
from knowledgegraphembedding_tpu import eval as j_eval
from knowledgegraphembedding_tpu.config import ModelSpec as JSpec
from knowledgegraphembedding_tpu.data.filterset import FilterSets as JFilterSets
from knowledgegraphembedding_tpu.data.synthetic import make_random_kg
from knowledgegraphembedding_tpu.ops import pallas_rank

import torch_mesh

MODELS = ["RotatE", "TransE", "pRotatE", "DistMult", "ComplEx"]
MODES = ("head-batch", "tail-batch")
NBS = [1, 31, 32, 33, 65]
LOG_STEPS = [0, 1, 5, 1000]
BATCHES = [5, 16]
E, R, CHUNK = 40, 4, 32


@functools.lru_cache(maxsize=None)
def _data(eff: int):
    """Train triples, and ``max(NBS) * eff - 3`` test triples drawn from a
    seed, all of them in the all-true set: the split of nb batches is their
    first ``nb * eff - 3`` (the last batch ragged), so that every split
    size shares one filter and its window length ``k_max``."""
    ds = make_random_kg(nentity=E, nrelation=R, ntriples=300, n_valid=5, n_test=5, seed=eff)
    rng = np.random.default_rng(eff)
    n = max(NBS) * eff - 3
    test = np.stack([rng.integers(0, E, n), rng.integers(0, R, n),
                     rng.integers(0, E, n)], 1).astype(np.int64)
    all_true = np.concatenate([ds.all_true_triples, test])
    return (test, TFilterSets.build(ds.train, all_true, E, R),
            JFilterSets.build(ds.train, all_true, E, R))


@functools.lru_cache(maxsize=None)
def _setup(model: str, nb: int):
    skw = torch_mesh.spec_kw(model, E, nrelation=R, hidden_dim=8)
    eff = t_eval.eff_eval_batch(TSpec(**skw), 1)
    test, tfilters, jfilters = _data(eff)
    p0 = torch_mesh.init_params(skw, seed=len(model))
    return (skw, eff, test[:nb * eff - 3], p0, t_kge.params_from_numpy(p0, "cpu"),
            {k: jnp.asarray(v) for k, v in p0.items()}, tfilters, jfilters)


def _jax_scan_ranks(jparams, jspec, jfilters, test, eff, log_steps, ranker=None):
    """JAX's chunk plan and scans, as ``test_step`` drives them: ranks
    i64[2, n] and the [SC, B, 3] chunks in order."""
    dev = j_eval.get_device_filter(jfilters)
    n = len(test)
    n_pad = -(-n // eff) * eff
    trip = np.concatenate([test, np.repeat(test[-1:], n_pad - n, axis=0)]).astype(np.int32)
    stack = jnp.asarray(trip).reshape(-1, eff, 3)
    nb = stack.shape[0]
    SC = min(nb, j_eval._SCAN_CHUNK, max(1, log_steps))
    n_scan = -(-nb // SC) * SC
    stack = jnp.concatenate([stack, jnp.repeat(stack[-1:], n_scan - nb, axis=0)])
    width = max(-(-E // CHUNK) * CHUNK, E + 1)
    ranks, chunks = [], []
    for mode in MODES:
        offsets, counts, values, k_max = dev._modes[mode]
        for s in range(0, n_scan, SC):
            sub = stack[s:s + SC]
            chunks.append(np.asarray(sub))
            if ranker is None:
                r = j_eval._eval_scan_xla(jparams, offsets, counts, values, sub, spec=jspec,
                                          mode=mode, chunk=CHUNK, k_max=k_max, width=width)
            else:
                r = j_eval._eval_scan_pallas(
                    ranker.table, ranker.rel, ranker.modulus, offsets, counts, values, sub,
                    ranker.tsin, ranker.tcos, spec=jspec, mode=mode, k_max=k_max, width=width,
                    TE=ranker.TE, half_pad=ranker.half_pad, span=ranker.span,
                    two_halves=ranker.two_halves, Epad=ranker.Epad, interpret=ranker.interpret)
            ranks.append(np.asarray(r).reshape(-1))
    return np.concatenate(ranks).reshape(2, -1)[:, :n].astype(np.int64), chunks


def _port_ranks(monkeypatch, body_name, tparams, tspec, tfilters, test, **kw):
    """The port's ranks, and the chunks its body ``body_name`` was given."""
    chunks = []
    body = getattr(t_eval, body_name)

    def counted(*args, **kwargs):
        chunks.append(args[4].numpy())
        return body(*args, **kwargs)

    monkeypatch.setattr(t_eval, body_name, counted)
    ranks = t_eval.split_ranks(tparams, tspec, test, tfilters, eval_chunk_size=CHUNK,
                               device_filter=True, **kw)
    monkeypatch.setattr(t_eval, body_name, body)
    return ranks, chunks


CASES = [(m, nb, ls, tb) for m in MODELS for nb in NBS for ls in LOG_STEPS for tb in BATCHES]


@pytest.mark.parametrize("model,nb,log_steps,test_batch_size", CASES,
                         ids=[f"{m}-nb{nb}-log{ls}-tb{tb}" for m, nb, ls, tb in CASES])
def test_scan_driver_matches_jax(monkeypatch, caplog, model, nb, log_steps, test_batch_size):
    skw, eff, test, p0, tparams, jparams, tfilters, jfilters = _setup(model, nb)
    tspec, jspec = TSpec(**skw), JSpec(**skw)
    assert -(-len(test) // eff) == nb
    kw = dict(test_batch_size=test_batch_size, test_log_steps=log_steps)

    caplog.set_level(logging.INFO)
    plain, plain_chunks = _port_ranks(monkeypatch, "_eval_scan_plain", tparams, tspec, tfilters,
                                      test, use_kernel=False, logger=logging.getLogger("port"),
                                      **kw)
    want = j_eval.test_step(jparams, jspec, test, jfilters, eval_chunk_size=CHUNK,
                            use_pallas=False, device_filter=True,
                            logger=logging.getLogger("jax"), **kw)
    lines = {name: [r.getMessage() for r in caplog.records if r.name == name]
             for name in ("port", "jax")}
    assert lines["port"] == lines["jax"] and lines["jax"]

    # the same chunks, pad batches included, and the same ranks as JAX's scans
    xla, xla_chunks = _jax_scan_ranks(jparams, jspec, jfilters, test, eff, log_steps)
    SC, n_scan = t_eval.scan_plan(nb, max(1, log_steps))
    assert len(plain_chunks) == len(xla_chunks) == 2 * n_scan // SC
    for a, b in zip(plain_chunks, xla_chunks):
        np.testing.assert_array_equal(a, b)
    assert plain.shape == (2, len(test))
    np.testing.assert_array_equal(plain, xla)

    logs = [lg for row in plain for lg in t_eval.metrics_from_ranks(row)]
    got = {k: float(np.mean([lg[k] for lg in logs])) for k in logs[0]}
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-9), k

    if model in DISTANCE:  # the kernel body (its plain version here) against Pallas
        kernel, kernel_chunks = _port_ranks(monkeypatch, "_eval_scan_kernel", tparams, tspec,
                                            tfilters, test, use_kernel=True, **kw)
        ranker = pallas_rank.PallasRanker(jparams, jspec, TE=32, interpret=True)
        pallas, _ = _jax_scan_ranks(jparams, jspec, jfilters, test, eff, log_steps, ranker)
        assert len(kernel_chunks) == len(xla_chunks)
        np.testing.assert_array_equal(kernel, pallas)
        np.testing.assert_array_equal(kernel, plain)


DISTANCE = ("RotatE", "TransE", "pRotatE")


@pytest.mark.parametrize("nb", [1, 2, 5, 31, 32, 33, 63, 64, 65, 17008])
@pytest.mark.parametrize("log_steps", LOG_STEPS + [7, 32, 33])
def test_scan_plan_is_jax_arithmetic(nb, log_steps):
    """(SC, n_scan) of the single-device plan (and of the sharded one,
    which has no log cadence) from JAX's expressions (``eval.test_step``,
    ``parallel/eval_sharded.sharded_test_step``)."""
    assert t_eval._SCAN_CHUNK == j_eval._SCAN_CHUNK
    SC = min(nb, j_eval._SCAN_CHUNK, max(1, log_steps))
    assert t_eval.scan_plan(nb, max(1, log_steps)) == (SC, -(-nb // SC) * SC)
    SC = min(nb, j_eval._SCAN_CHUNK)
    assert t_eval.scan_plan(nb) == (SC, -(-nb // SC) * SC)


def test_main_path_plan_ranks_pad_batches():
    """1,000 test triples at B=16: 63 batches, chunks of 32, 64 batches
    ranked a mode (one pad batch, as in JAX): 128 rank-kernel launches an
    evaluation."""
    assert t_eval.scan_plan(-(-1000 // 16), 1000) == (32, 64)
    assert t_eval.scan_plan(-(-272115 // 16), 1000) == (32, 17024)


def test_per_batch_loop_equals_the_scan():
    """The per-batch loop kept for comparisons on the card ranks what the
    scan ranks."""
    skw, eff, test, p0, tparams, jparams, tfilters, jfilters = _setup("RotatE", 33)
    tspec = TSpec(**skw)
    for use_kernel in (False, True):
        scan = t_eval.split_ranks(tparams, tspec, test, tfilters, eval_chunk_size=CHUNK,
                                  device_filter=True, use_kernel=use_kernel)
        loop = t_eval._per_batch_ranks(tparams, tspec, test, tfilters, eval_chunk_size=CHUNK,
                                       use_kernel=use_kernel)
        np.testing.assert_array_equal(scan, loop)


def test_chunk_runner_runs_the_body_off_cuda():
    """Off CUDA the chunk runner is the body itself: no graph, no capture."""
    body = lambda chunk: chunk.sum()  # noqa: E731
    before = cuda_graphs.captures["eval_chunk"]
    graphs = {}
    assert t_eval.chunk_runner(graphs, "k", body, body, on_cuda=False) is body
    assert graphs == {} and cuda_graphs.captures["eval_chunk"] == before


def test_plain_graph_cache_follows_the_params_versions():
    """The plain and dense bodies' graph cache keeps one entry per params
    at their versions: an in-place update drops the old entry, and at most
    two entries live."""
    skw, eff, test, p0, tparams, jparams, tfilters, jfilters = _setup("DistMult", 1)
    tspec = TSpec(**skw)
    t_eval._plain_graphs.clear()
    params = {k: v.clone() for k, v in tparams.items()}
    t_eval.split_ranks(params, tspec, test, tfilters, device_filter=True)
    (old,) = t_eval._plain_graphs
    params["entity_embedding"].add_(0.0)  # bumps the version
    t_eval.split_ranks(params, tspec, test, tfilters, device_filter=True)
    (new,) = t_eval._plain_graphs
    assert new != old
    for _ in range(3):
        other = {k: v.clone() for k, v in tparams.items()}
        t_eval.split_ranks(other, tspec, test, tfilters, device_filter=True)
    assert len(t_eval._plain_graphs) == 2
