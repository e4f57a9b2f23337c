"""The port's rank counting against the JAX package's Pallas kernel (interpret
mode) and chunked XLA ranker on identical inputs. On the CPU the wrapper runs
its plain version; the CUDA kernel itself is held against that plain version
by tests/test_torch_cuda.py and chip_smoke.py on the card.

Ranks are compared exactly, except that a candidate whose score lies within
TIE_RTOL * max(1, |true|) of the true score may be counted differently by two
summation orders: a row may then differ by at most its number of such
candidates."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from knowledgegraphembedding_torch.config import ModelSpec as TSpec
from knowledgegraphembedding_torch.models import kge as t_kge
from knowledgegraphembedding_torch.ops import rank_kernel
from knowledgegraphembedding_tpu import eval as j_eval
from knowledgegraphembedding_tpu.config import ModelSpec as JSpec
from knowledgegraphembedding_tpu.data.filterset import FilterSets
from knowledgegraphembedding_tpu.data.synthetic import make_random_kg
from knowledgegraphembedding_tpu.ops import pallas_rank

# the RotatE/TransE cases of tests/test_pallas_rank.py
CASES = [("RotatE", True, False, 16), ("TransE", False, False, 16)]
MODES = ["head-batch", "tail-batch"]


def _setup(model, de, dr, dim, seed=0):
    ds = make_random_kg(nentity=70, nrelation=4, ntriples=700, n_valid=50, n_test=80, seed=3)
    kw = dict(model_name=model, nentity=ds.nentity, nrelation=ds.nrelation,
              hidden_dim=dim, gamma=6.0, double_entity_embedding=de,
              double_relation_embedding=dr)
    jspec, tspec = JSpec(**kw), TSpec(**kw)
    rng = np.random.default_rng(seed)
    r = jspec.embedding_range
    p = {
        "entity_embedding": rng.uniform(-r, r, (ds.nentity, jspec.entity_dim)).astype(np.float32),
        "relation_embedding": rng.uniform(-r, r, (ds.nrelation, jspec.relation_dim)).astype(np.float32),
    }
    filters = FilterSets.build(ds.train, ds.all_true_triples, ds.nentity, ds.nrelation)
    return ds, jspec, tspec, p, filters


def _assert_ranks_within_ties(got, want, ties, what):
    got, want, ties = (np.asarray(x, np.int64) for x in (got, want, ties))
    diff = np.abs(got - want)
    assert (diff <= ties).all(), (
        f"{what}: ranks differ beyond the near-tie candidates: got {got}, "
        f"want {want}, near-tie candidates {ties}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("model,de,dr,dim", CASES, ids=[c[0] for c in CASES])
def test_rank_counts_ref_matches_pallas_interpret(model, de, dr, dim, mode):
    ds, jspec, tspec, p, filters = _setup(model, de, dr, dim)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    pos = ds.test[:8].astype(np.int32)
    mask = filters.filter_mask_rows(pos, mode)
    true_ids = pos[:, 0] if mode == "head-batch" else pos[:, 2]

    # one set of L rows and true scores, fed to both kernels
    left = np.array(pallas_rank.left_rows(jp, jspec, jnp.asarray(pos), mode))
    true_rows = p["entity_embedding"][true_ids]
    true_score = np.array(pallas_rank.true_scores(
        jnp.asarray(left), jnp.asarray(true_rows), jspec, None))

    ranker = pallas_rank.PallasRanker(jp, jspec, TE=128, interpret=True)
    two = model == "RotatE"
    left_p = pallas_rank._pad_cols(jnp.asarray(left), ranker.span, ranker.half_pad, two)
    mask_t = np.zeros((ranker.Epad, len(pos)), np.int32)
    mask_t[: ds.nentity] = mask.T
    want = np.asarray(pallas_rank.rank_counts(
        left_p, jnp.asarray(true_score), jnp.asarray(true_ids), ranker.table,
        jnp.asarray(mask_t), family=model, gamma=jspec.gamma, E=ds.nentity,
        TE=128, half_pad=ranker.half_pad, interpret=True))

    args = (torch.from_numpy(left), torch.from_numpy(true_score),
            torch.from_numpy(true_ids), torch.from_numpy(p["entity_embedding"]),
            torch.from_numpy(mask))
    kw = dict(family=model, gamma=tspec.gamma, E=ds.nentity)
    got = rank_kernel.rank_counts_ref(*args, **kw)
    ties = rank_kernel.near_tie_counts(*args, **kw)
    assert got.dtype == torch.int32
    _assert_ranks_within_ties(got, want, ties, f"{model} {mode}")
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(rank_kernel.rank_counts(*args, **kw), got)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("model,de,dr,dim", CASES, ids=[c[0] for c in CASES])
def test_ranks_batch_kernel_matches_jax_rankers(model, de, dr, dim, mode):
    ds, jspec, tspec, p, filters = _setup(model, de, dr, dim)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    pos = ds.test[:8].astype(np.int32)
    mask_p = j_eval._pad_mask(filters.filter_mask_rows(pos, mode), 16)
    want_xla = np.asarray(j_eval.ranks_batch(jp, jnp.asarray(pos), jnp.asarray(mask_p),
                                             spec=jspec, mode=mode, chunk=16))
    want_pallas = np.asarray(pallas_rank.ranks_batch_pallas(
        jp, jspec, jnp.asarray(pos), jnp.asarray(mask_p), mode, TE=128, interpret=True))

    tp = t_kge.params_from_numpy(p, "cpu")
    tpos = torch.from_numpy(pos.astype(np.int64))
    tmask = torch.from_numpy(mask_p)
    got = rank_kernel.ranks_batch_kernel(tp, tspec, tpos, tmask, mode)
    ranker = rank_kernel.Ranker(tp, tspec)
    left, true_score, true_ids = ranker.inputs(tpos, mode)
    ties = rank_kernel.near_tie_counts(left, true_score, true_ids, ranker.table, tmask,
                                       family=model, gamma=tspec.gamma, E=ds.nentity)
    _assert_ranks_within_ties(got, want_pallas, ties, f"{model} {mode} vs pallas")
    _assert_ranks_within_ties(got, want_xla, ties, f"{model} {mode} vs xla")


def test_launch_count_does_not_move_on_cpu():
    ds, jspec, tspec, p, filters = _setup("RotatE", True, False, 16)
    tp = t_kge.params_from_numpy(p, "cpu")
    pos = torch.from_numpy(ds.test[:4].astype(np.int64))
    mask = torch.from_numpy(filters.filter_mask_rows(ds.test[:4], "tail-batch"))
    before = rank_kernel.rank_counts.launches
    rank_kernel.ranks_batch_kernel(tp, tspec, pos, mask, "tail-batch")
    assert rank_kernel.rank_counts.launches == before


def test_wrapper_rejects_mixed_devices_and_unknown_family():
    left = torch.zeros(2, 4)
    args = (left, torch.zeros(2), torch.zeros(2, dtype=torch.int32),
            torch.zeros(5, 4), torch.zeros(2, 5, dtype=torch.bool))
    with pytest.raises(ValueError, match="family"):
        rank_kernel.rank_counts(*args, family="pRotatE", gamma=1.0, E=5)
    meta = (left, torch.zeros(2), torch.zeros(2, dtype=torch.int32),
            torch.zeros(5, 4, device="meta"), torch.zeros(2, 5, dtype=torch.bool))
    with pytest.raises(ValueError, match="table is on meta"):
        rank_kernel.rank_counts(*meta, family="TransE", gamma=1.0, E=5)


@pytest.mark.parametrize("model,item", [("pRotatE", "K3"), ("DistMult", "item 9"),
                                        ("ComplEx", "item 9")])
def test_ranker_refuses_unported_models(model, item):
    spec = TSpec(model_name=model, nentity=10, nrelation=2, hidden_dim=4, gamma=1.0,
                 double_entity_embedding=model == "ComplEx",
                 double_relation_embedding=model == "ComplEx")
    params = t_kge.init_params(spec, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match=item):
        rank_kernel.Ranker(params, spec)


def test_get_ranker_cached_on_table_identity():
    ds, jspec, tspec, p, filters = _setup("TransE", False, False, 16)
    rank_kernel._ranker_cache.clear()
    p1 = t_kge.params_from_numpy(p, "cpu")
    a = rank_kernel.get_ranker(p1, tspec)
    assert rank_kernel.get_ranker(p1, tspec) is a
    p2 = t_kge.params_from_numpy(p, "cpu")  # a new table, same values
    c = rank_kernel.get_ranker(p2, tspec)
    assert c is not a
    assert rank_kernel.get_ranker(p1, tspec) is a
    for _ in range(rank_kernel._RANKER_CACHE_MAX):
        rank_kernel.get_ranker(t_kge.params_from_numpy(p, "cpu"), tspec)
    assert len(rank_kernel._ranker_cache) == rank_kernel._RANKER_CACHE_MAX
    assert rank_kernel.get_ranker(p1, tspec) is not a  # evicted, rebuilt

