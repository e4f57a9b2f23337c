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

from knowledgegraphembedding_torch import eval as t_eval
from knowledgegraphembedding_torch.config import ModelSpec as TSpec
from knowledgegraphembedding_torch.config import TrainSpec
from knowledgegraphembedding_torch.models import kge as t_kge
from knowledgegraphembedding_torch.ops import rank_kernel
from knowledgegraphembedding_torch.train import Trainer
from knowledgegraphembedding_tpu import eval as j_eval
from knowledgegraphembedding_tpu.config import ModelSpec as JSpec
from knowledgegraphembedding_tpu.data.filterset import FilterSets
from knowledgegraphembedding_tpu.data.synthetic import make_random_kg
from knowledgegraphembedding_tpu.ops import pallas_rank

# the RotatE/TransE cases of tests/test_pallas_rank.py (rank_counts) and the
# pRotatE case (rank_counts_protate)
CASES = [("RotatE", True, False, 16), ("TransE", False, False, 16)]
ALL_CASES = CASES + [("pRotatE", False, False, 16)]
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
    if jspec.has_modulus:
        p["modulus"] = np.float32(0.5 * r)
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
def test_protate_rank_counts_ref_matches_pallas_interpret(mode):
    """K3's plain version and the Pallas kernel on the same sin/cos inputs
    (the JAX ranker's lane-padded tables, cut back to d columns for the
    port's sin | cos layout): the counts are equal."""
    ds, jspec, tspec, p, filters = _setup("pRotatE", False, False, 16)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    pos = ds.test[:8].astype(np.int32)
    mask = filters.filter_mask_rows(pos, mode)
    true_ids = pos[:, 0] if mode == "head-batch" else pos[:, 2]
    ranker = pallas_rank.PallasRanker(jp, jspec, TE=128, interpret=True)
    d, E = ranker.span, ds.nentity
    left_p = pallas_rank._pad_cols(pallas_rank.left_rows(jp, jspec, jnp.asarray(pos), mode),
                                   d, ranker.half_pad, False)
    lsin, lcos = jnp.sin(left_p), jnp.cos(left_p)
    tsin, tcos = np.asarray(ranker.tsin), np.asarray(ranker.tcos)
    true_score = np.asarray(jspec.gamma - jp["modulus"] * jnp.sum(
        jnp.abs(lsin * tcos[true_ids] - lcos * tsin[true_ids]), axis=-1))
    mask_t = np.zeros((ranker.Epad, len(pos)), np.int32)
    mask_t[:E] = mask.T
    want = np.asarray(pallas_rank.rank_counts_protate(
        lsin, lcos, jnp.asarray(true_score), jnp.asarray(true_ids), jp["modulus"],
        ranker.tsin, ranker.tcos, jnp.asarray(mask_t), gamma=jspec.gamma, E=E, TE=128,
        interpret=True))

    left = torch.from_numpy(np.concatenate([np.asarray(lsin)[:, :d], np.asarray(lcos)[:, :d]], 1))
    table = torch.from_numpy(np.concatenate([tsin[:E, :d], tcos[:E, :d]], 1))
    args = (left, torch.from_numpy(np.array(true_score)), torch.from_numpy(true_ids), table,
            torch.from_numpy(mask))
    kw = dict(family="pRotatE", gamma=tspec.gamma, E=E, modulus=torch.tensor(p["modulus"]))
    got = rank_kernel.rank_counts_ref(*args, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(rank_kernel.rank_counts(*args, **kw), got)
    # the port's Ranker builds the same sin | cos table (torch's sin/cos may
    # differ from XLA's in the last bit)
    t_table = rank_kernel.Ranker(t_kge.params_from_numpy(p, "cpu"), tspec).table
    np.testing.assert_allclose(t_table.numpy(), table.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("model,de,dr,dim", ALL_CASES, ids=[c[0] for c in ALL_CASES])
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
                                       family=model, gamma=tspec.gamma, E=ds.nentity,
                                       modulus=ranker.modulus)
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
        rank_kernel.rank_counts(*args, family="DistMult", gamma=1.0, E=5)
    with pytest.raises(ValueError, match="modulus"):
        rank_kernel.rank_counts(*args, family="pRotatE", gamma=1.0, E=5)
    with pytest.raises(ValueError, match="modulus"):
        rank_kernel.rank_counts(*args, family="TransE", gamma=1.0, E=5, modulus=torch.tensor(1.0))
    meta = (left, torch.zeros(2), torch.zeros(2, dtype=torch.int32),
            torch.zeros(5, 4, device="meta"), torch.zeros(2, 5, dtype=torch.bool))
    with pytest.raises(ValueError, match="table is on meta"):
        rank_kernel.rank_counts(*meta, family="TransE", gamma=1.0, E=5)


@pytest.mark.parametrize("entry", ["Ranker", "split_ranks"])
@pytest.mark.parametrize("model", ["DistMult", "ComplEx"])
def test_ranker_refuses_unported_models(model, entry):
    spec = TSpec(model_name=model, nentity=10, nrelation=2, hidden_dim=4, gamma=1.0,
                 double_entity_embedding=model == "ComplEx",
                 double_relation_embedding=model == "ComplEx")
    params = t_kge.init_params(spec, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="no rank-kernel family.*dense matmul scoring"):
        if entry == "Ranker":
            rank_kernel.Ranker(params, spec)
        else:
            t_eval.split_ranks(params, spec, np.array([[0, 0, 1]]), None, use_kernel=True)


def test_get_ranker_cached_on_table_identity():
    """Keyed on each table's identity and version: the same unchanged
    tables reuse the ranker, new tables or an in-place update build a new
    one, and an entry whose tables have moved is dropped."""
    ds, jspec, tspec, p, filters = _setup("TransE", False, False, 16)
    rank_kernel._ranker_cache.clear()
    p1 = t_kge.params_from_numpy(p, "cpu")
    a = rank_kernel.get_ranker(p1, tspec)
    assert rank_kernel.get_ranker(p1, tspec) is a
    p2 = t_kge.params_from_numpy(p, "cpu")  # a new table, same values
    c = rank_kernel.get_ranker(p2, tspec)
    assert c is not a
    assert rank_kernel.get_ranker(p1, tspec) is a
    p1["entity_embedding"].add_(0.0)  # in place: a new version of the same table
    b = rank_kernel.get_ranker(p1, tspec)
    assert b is not a and len(rank_kernel._ranker_cache) == 2
    assert all(r is not a for _, r in rank_kernel._ranker_cache.values())
    for _ in range(rank_kernel._RANKER_CACHE_MAX):
        rank_kernel.get_ranker(t_kge.params_from_numpy(p, "cpu"), tspec)
    assert len(rank_kernel._ranker_cache) == rank_kernel._RANKER_CACHE_MAX
    assert rank_kernel.get_ranker(p1, tspec) is not b  # evicted, rebuilt


@pytest.mark.parametrize("model,de,dr,dim", [ALL_CASES[0], ALL_CASES[2]],
                         ids=["RotatE", "pRotatE"])
def test_ranks_after_in_place_update_are_fresh(model, de, dr, dim):
    """rank through the cache; one Adam step of a Trainer updates the tables
    in place; rank again: the ranks are those of a freshly built Ranker."""
    ds, jspec, tspec, p, filters = _setup(model, de, dr, dim)
    rank_kernel._ranker_cache.clear()
    trainer = Trainer(tspec, TrainSpec(negative_sample_size=8, batch_size=32),
                      t_kge.params_from_numpy(p, "cpu"), lr=0.05, warm_up_steps=100)
    kw = dict(test_batch_size=16, use_kernel=True)
    before = t_eval.split_ranks(trainer.params, tspec, ds.test, filters, **kw)
    rng = np.random.default_rng(0)
    pos = ds.train[:32]
    neg = rng.integers(0, ds.nentity, (32, 8)).astype(np.int32)
    table = trainer.params["entity_embedding"]
    trainer.one_step((torch.from_numpy(pos), torch.from_numpy(neg),
                      torch.ones(32), "tail-batch"))
    assert trainer.params["entity_embedding"] is table  # updated in place
    after = t_eval.split_ranks(trainer.params, tspec, ds.test, filters, **kw)
    fresh = {k: v.detach().clone() for k, v in trainer.params.items()}
    want = t_eval.split_ranks(fresh, tspec, ds.test, filters, **kw)
    np.testing.assert_array_equal(after, want)
    assert (after != before).any()  # the step moved some ranks
    assert len(rank_kernel._ranker_cache) <= rank_kernel._RANKER_CACHE_MAX


PLAN_WIDTHS = [2, 26, 2000, 8000]


@pytest.mark.parametrize("E", [1, 37, 14541])
@pytest.mark.parametrize("B", [1, 16, 17, 128, 129])
@pytest.mark.parametrize("family", rank_kernel.FAMILIES)
def test_launch_plan_covers_every_pair_once_and_fills_the_card(family, B, E):
    """On a 132-SM card: every (row, candidate) pair lies in exactly one
    block's rows and tiles, every element of a row in exactly one chunk
    quad, the shared memory fits, the grid is one wave that fills the SMs,
    and any width is taken."""
    sms = 132
    for D in PLAN_WIDTHS:
        plan = rank_kernel.launch_plan(family, B, D, E, sms)
        gx, gy = plan.grid
        row_block, tile = rank_kernel._ROW_BLOCK, rank_kernel._TILE
        # rows: block x holds rows [16 x, 16 x + 16); candidates: block y walks
        # tiles y, y + gy, ...
        rows = np.zeros(gx * row_block, np.int64)
        for x in range(gx):
            rows[x * row_block:(x + 1) * row_block] += 1
        cands = np.zeros(plan.tiles * tile, np.int64)
        walked = []
        for y in range(gy):
            mine = np.arange(y, plan.tiles, gy)
            walked.append(len(mine))
            cands[(mine[:, None] * tile + np.arange(tile)).ravel()] += 1
        assert (rows[:B] == 1).all() and (cands[:E] == 1).all()
        assert (gx - 1) * row_block < B and (plan.tiles - 1) * tile < E
        assert (min(walked), max(walked)) == plan.tiles_per_block
        assert plan.tiles_per_block[1] - plan.tiles_per_block[0] <= 1
        # handed out: block y scores tile y, then whichever block asks the
        # row block's counter next (here in a random order) gets gy + n
        assert plan.handed == (plan.chunks >= rank_kernel._STAGES)
        if plan.handed:
            rng = np.random.default_rng(B + E + D)
            scored = np.zeros(plan.tiles, np.int64)
            scored[:gy] += 1
            asking, handed = list(range(gy)), 0
            while asking:
                y = asking.pop(int(rng.integers(len(asking))))
                ct = gy + handed
                handed += 1
                if ct < plan.tiles:
                    scored[ct] += 1
                    asking.append(y)
            assert (scored == 1).all()
        # elements: chunks of _CHUNK cover each half once; the split threads'
        # quads (thread s: elements 4 s .. 4 s + 3) cover each chunk once
        chunk = rank_kernel._CHUNK
        assert plan.half * plan.halves == D
        assert (plan.chunks - 1) * chunk < plan.half <= plan.chunks * chunk
        assert 4 * rank_kernel._SPLIT == chunk
        assert plan.vec16 == (plan.half % 4 == 0)
        # shared memory within a block's 232,448 bytes and the SM's 233,472
        assert plan.smem_bytes == rank_kernel.smem_bytes(family) <= 232448
        assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= 233472
        assert plan.threads * plan.blocks_per_sm <= 2048
        # one wave that fills the card, as far as the work allows
        assert gx * gy >= min(sms, gx * plan.tiles)
        assert plan.waves <= 1.0 and plan.waves == gx * gy / (sms * plan.blocks_per_sm)
    # a plan is made once per shape and card
    assert rank_kernel.launch_plan(family, B, 2000, E, sms) is rank_kernel.launch_plan(
        family, B, 2000, E, sms)


def test_launch_plan_refuses_what_the_kernel_does_not_take():
    assert not rank_kernel.launch_plan("RotatE", 16, 2000, 100, 132, aligned=False).vec16
    assert rank_kernel.launch_plan("TransE", 16, 13, 100, 132).chunks == 1
    with pytest.raises(ValueError, match="even width"):
        rank_kernel.launch_plan("pRotatE", 16, 13, 100, 132)
    with pytest.raises(ValueError, match="at least 1"):
        rank_kernel.launch_plan("TransE", 16, 8, 0, 132)
    with pytest.raises(ValueError, match="family"):
        rank_kernel.launch_plan("DistMult", 16, 8, 10, 132)
    # many rows: more row blocks than resident slots, one tile slot each
    plan = rank_kernel.launch_plan("TransE", 16 * 1000, 8, 10, 132)
    assert plan.grid == (1000, 1) and plan.waves > 1


@pytest.mark.parametrize("family", rank_kernel.FAMILIES)
def test_synthetic_inputs_spread_the_counts(family):
    """The tile-edge sweep's inputs: counts within 0..E-1 and not all equal,
    the same from the same seed."""
    args, kw = rank_kernel.synthetic_inputs(family, 17, 37, 26 if family != "TransE" else 13)
    got = rank_kernel.rank_counts(*args, **kw)
    assert got.shape == (17,) and int(got.min()) >= 0 and int(got.max()) < 37
    assert len(set(got.tolist())) > 3
    again, _ = rank_kernel.synthetic_inputs(family, 17, 37, 26 if family != "TransE" else 13)
    assert all(torch.equal(a, b) for a, b in zip(args, again))


@pytest.mark.parametrize("offset", [0, 1, 15, 16])
@pytest.mark.parametrize("family", rank_kernel.FAMILIES)
def test_rank_counts_take_a_mask_column_window(family, offset):
    """The sharded evaluation passes the columns [offset, offset + E) of a
    wider mask, a view with unit column stride and a longer row stride; on
    the CPU the wrapper counts over it as over its contiguous copy (the card
    test in tests/test_torch_cuda.py holds the kernel to the same)."""
    args, kw = rank_kernel.synthetic_inputs(family, 17, 37, 16, seed=offset)
    left, true_score, true_ids, table, mask = args
    wide = torch.cat([torch.ones(17, offset, dtype=torch.bool), mask,
                      torch.ones(17, 16 - offset + 3, dtype=torch.bool)], dim=1)
    window = wide[:, offset:offset + mask.shape[1]]
    assert window.stride() == (wide.shape[1], 1) and torch.equal(window, mask)
    got = rank_kernel.rank_counts(left, true_score, true_ids, table, window, **kw)
    want = rank_kernel.rank_counts_ref(left, true_score, true_ids, table, mask.contiguous(), **kw)
    assert torch.equal(got, want)
    assert rank_kernel.rank_counts.launches == 0  # the plain version, no launch
