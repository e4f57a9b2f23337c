"""The port's device-resident sampler against the JAX package's
(knowledgegraphembedding_tpu/sampler/device_sampler.py), on the CPU: the
CSR arrays, ``gap_map`` (exhaustively), ``csr_member``, the epoch index
stream, the tail-first alternation and the positives and weights are equal;
the draw itself is the port's own counter-based generator (JAX's threefry
bits are not reproducible in torch), held to the sampling contract: no
train-true negative, uniform over the allowed set, a pure function of
(seed, mode, draw index, row, slot)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from knowledgegraphembedding_torch import checkpoint as t_ckpt
from knowledgegraphembedding_torch.config import ModelSpec, RunConfig, TrainSpec
from knowledgegraphembedding_torch.fused_train import FusedDeviceTrainer
from knowledgegraphembedding_torch.models import kge as t_kge
from knowledgegraphembedding_torch.sampler import device_sampler as t_ds
from knowledgegraphembedding_torch.sampler import negative as t_neg
from knowledgegraphembedding_tpu.data.filterset import subsampling_weights
from knowledgegraphembedding_tpu.data.synthetic import make_random_kg
from knowledgegraphembedding_tpu.sampler import device_sampler as j_ds

MODES = ["head-batch", "tail-batch"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These tensors are small: one intra-op thread, whose ops take
    microseconds, where waking a pool of threads costs milliseconds."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(E=60, R=4, T=400, seed=0):
    rng = np.random.default_rng(seed)
    tr = np.stack([rng.integers(0, E, T), rng.integers(0, R, T), rng.integers(0, E, T)], 1)
    return np.unique(tr, axis=0).astype(np.int32)


def _j_csr(arrays):
    offsets, counts, values, _ = arrays
    return {"offsets": jnp.asarray(offsets), "counts": jnp.asarray(counts),
            "values": jnp.asarray(values)}


def _t_csr(arrays):
    offsets, counts, values, _ = arrays
    return {"offsets": torch.from_numpy(offsets), "counts": torch.from_numpy(counts),
            "values": torch.from_numpy(values)}


@pytest.mark.parametrize("mode", MODES)
def test_build_mode_csr_equals_jax(mode):
    train = _graph(seed=3)
    train = np.concatenate([train, train[:7]])  # duplicate triples are deduplicated
    got = t_ds.build_mode_csr(train, 60, 4, mode)
    want = j_ds.build_mode_csr(train, 60, 4, mode)
    assert got[3] == want[3]
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", MODES)
def test_coverage_guard_raises_as_jax(mode):
    E = 5  # key (h=0, r=0) -> every tail; key (r=0, t=t) -> every head for t=0
    train = (np.array([[0, 0, t] for t in range(E)], np.int32) if mode == "tail-batch"
             else np.array([[h, 0, 0] for h in range(E)], np.int32))
    for mod in (t_ds, j_ds):
        with pytest.raises(ValueError, match="covers every entity"):
            mod.build_mode_csr(train, E, 1, mode)


def test_gap_map_equals_jax_exhaustively():
    """Every u in [0, E - c) for keys with gaps at the edges, adjacent runs
    of values, duplicated train triples, an empty set and adjacent keys of
    very different sizes: the port's searchsorted shift, JAX's chunked
    compare and the u-th smallest allowed entity agree."""
    E = 23
    trues = {0: [1, 2, 7, 8, 9, 15, 22], 1: [0], 2: [], 3: list(range(17)),
             4: [22], 5: list(range(3, 21, 2))}
    rows = [[h, 0, t] for h, ts in trues.items() for t in ts]
    rows += [[0, 0, 7], [3, 0, 4]]
    train = np.array(rows, np.int32)
    arrays = t_ds.build_mode_csr(train, E, 1, "tail-batch")
    k_max = arrays[3]
    for h, ts in trues.items():
        allowed = sorted(set(range(E)) - set(ts))
        u = np.arange(len(allowed), dtype=np.int32)[None, :]
        got = t_ds.gap_map(torch.from_numpy(u).long(), torch.tensor([h]), _t_csr(arrays),
                           k_max, E)
        want = j_ds.gap_map(jnp.asarray(u), jnp.asarray([h], jnp.int32), _j_csr(arrays),
                            k_max, E)
        assert got[0].tolist() == np.asarray(want)[0].tolist() == allowed, h


def test_gap_map_equals_jax_on_random_rows():
    """Many rows at once, random keys and u from numpy, on a random graph
    whose k_max needs more than one of JAX's 16-wide chunks."""
    rng = np.random.default_rng(4)
    E = 50
    train = np.concatenate([_graph(E=E, R=2, T=300, seed=1),
                            np.array([[1, 0, t] for t in range(0, 40)], np.int32)])
    arrays = t_ds.build_mode_csr(train, E, 2, "tail-batch")
    offsets, counts, values, k_max = arrays
    assert k_max > 16
    qk = rng.integers(0, E * 2, 64).astype(np.int32)
    qk[:4] = 2  # the key h=1, r=0
    u = (rng.random((64, 40)) * (E - counts[qk])[:, None]).astype(np.int32)
    got = t_ds.gap_map(torch.from_numpy(u).long(), torch.from_numpy(qk).long(),
                       _t_csr(arrays), k_max, E)
    want = j_ds.gap_map(jnp.asarray(u), jnp.asarray(qk), _j_csr(arrays), k_max, E)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_csr_member_equals_jax():
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 50, 300).astype(np.int32)
    vals = rng.integers(0, 70, 300).astype(np.int32)
    t_csr = t_ds._DeviceCSR(keys, vals, n_keys=50, sentinel=70)
    j_csr = j_ds._DeviceCSR(keys, vals, n_keys=50, sentinel=70)
    assert t_csr.k_max == j_csr.k_max
    qk = rng.integers(0, 50, 8).astype(np.int32)
    qv = rng.integers(0, 70, (8, 64)).astype(np.int32)
    got = t_csr.member(torch.from_numpy(qk).long(), torch.from_numpy(qv)).numpy()
    want = np.asarray(j_csr.member(jnp.asarray(qk), jnp.asarray(qv)))
    np.testing.assert_array_equal(got, want)
    pairs = set(zip(keys.tolist(), vals.tolist()))
    assert got.tolist() == [[(int(k), int(v)) in pairs for v in row] for k, row in zip(qk, qv)]


def test_csr_member_adjacent_key_no_contamination():
    keys = np.array([0] + [1] * 10, np.int32)
    vals = np.array([5] + list(range(10, 20)), np.int32)
    csr = t_ds._DeviceCSR(keys, vals, n_keys=2, sentinel=99)
    got = csr.member(torch.zeros(1, dtype=torch.int64), torch.tensor([[5, 10, 15, 19]]))
    assert got[0].tolist() == [True, False, False, False]


@pytest.mark.parametrize("subset", [None, "odd"])
def test_epoch_index_stream_equals_jax(subset):
    pool = None if subset is None else np.arange(1, 301, 2)
    a = t_ds._EpochIndexStream(300, pool, seed=7, count=64)
    b = j_ds._EpochIndexStream(300, pool, seed=7, count=64)
    for _ in range(12):  # several epochs, with short-batch top-ups
        x, y = a.next(), b.next()
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)


def test_iterator_positives_and_weights_equal_jax():
    """The tail-first alternation and the index streams (head seed, tail
    seed + 1) are JAX's: the same positives and weights batch for batch."""
    train = _graph(seed=2)
    got = t_ds.build_device_iterator(train, 60, 4, 25, 4, seed=3)
    want = j_ds.build_device_iterator(train, 60, 4, 25, 4, seed=3)
    modes = []
    for _ in range(10):
        g, w = next(got), next(want)
        assert g[3] == w[3]
        modes.append(g[3])
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w[0]))
        np.testing.assert_array_equal(g[2].numpy(), np.asarray(w[2]))
        assert g[1].dtype == torch.int32 and g[1].shape == tuple(w[1].shape)
    assert modes[:4] == ["tail-batch", "head-batch", "tail-batch", "head-batch"]
    np.testing.assert_array_equal(got._samplers[0].weights.numpy(),
                                  subsampling_weights(train, 4))


def test_epoch_coverage_of_tail_batches():
    train = _graph(seed=2)
    it = t_ds.build_device_iterator(train, 60, 4, 25, 4, seed=0)
    n = len(train)
    seen = []
    while len(seen) < -(-n // 25):
        pos, _, _, mode = next(it)
        if mode == "tail-batch":
            seen.append(pos.numpy())
    assert len(np.unique(np.concatenate(seen)[:n], axis=0)) == n


@pytest.mark.parametrize("mode", MODES)
def test_no_train_true_collisions(mode):
    train = _graph()
    s = t_ds.DeviceSampler(train, 60, 4, batch_size=32, negative_sample_size=16,
                           mode=mode, seed=3)
    tr = set(map(tuple, train.tolist()))
    for _ in range(5):
        pos, neg, _, m = s.next_batch()
        assert m == mode
        for (h, r, t), row in zip(pos.tolist(), neg.tolist()):
            for x in row:
                assert ((x, r, t) if mode == "head-batch" else (h, r, x)) not in tr


def test_dense_key_draws_only_the_allowed_entities():
    """A key whose true set covers 90 % of the entities draws only the two
    left over (the gap map has no rejection loop to run out of)."""
    train = np.array([[0, 0, t] for t in range(18)], np.int32)
    s = t_ds.DeviceSampler(train, 20, 1, batch_size=4, negative_sample_size=8,
                           mode="tail-batch", seed=0)
    for _ in range(3):
        assert set(np.unique(s.next_batch()[1].numpy())) <= {18, 19}


@pytest.mark.parametrize("mode", MODES)
def test_uniform_over_allowed_chi_square(mode):
    """64 x 4,096 draws for one key over its 34 allowed entities: no true
    entity drawn, and Pearson's statistic (33 degrees of freedom, mean 33,
    sd 8.1) below 80, a tail probability of about 1e-5 for a uniform draw."""
    E = 40
    trues = [0, 3, 4, 5, 20, 39]
    train = (np.array([[0, 0, t] for t in trues], np.int32) if mode == "tail-batch"
             else np.array([[h, 0, 0] for h in trues], np.int32))
    s = t_ds.DeviceSampler(train, E, 1, batch_size=64, negative_sample_size=4096,
                           mode=mode, seed=11)
    idx = torch.zeros(64, dtype=torch.int32)  # every row the same key
    counts = np.zeros(E)
    for draw in range(1, 5):
        _, neg, _ = s.sample(idx, torch.tensor(draw))
        counts += np.bincount(neg.numpy().ravel(), minlength=E)
    assert counts[trues].sum() == 0
    allowed = np.delete(counts, trues)
    expected = counts.sum() / len(allowed)
    chi2 = float(((allowed - expected) ** 2 / expected).sum())
    assert chi2 < 80, chi2


def test_slots_and_rows_are_uncorrelated():
    """Neighbouring slots, rows and draws of the raw bits: the correlation of
    their low bits and of their top bits is within 5 sd of 0 for 2^18 pairs."""
    counter = torch.arange(512 * 512, dtype=torch.int64).view(512, 512)
    keys = t_ds.round_keys(0, "tail-batch")
    a = t_ds.uniform_bits(counter, torch.tensor(1), keys)
    b = t_ds.uniform_bits(counter, torch.tensor(2), keys)
    for x, y in ((a[:, :-1], a[:, 1:]), (a[:-1], a[1:]), (a, b)):
        for bits in ((x & 0xFFFF, y & 0xFFFF), (x >> 47, y >> 47)):
            u, v = (t.double().flatten() for t in bits)
            r = float(torch.corrcoef(torch.stack([u, v]))[0, 1])
            assert abs(r) < 5 / np.sqrt(u.numel()), r


def test_mixer_arithmetic():
    """The 16-bit-half product is the 32-bit product, the mixer the same on
    ints and tensors, and the Feistel network a bijection of the counters
    into [0, 2^63)."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, 1000, dtype=np.uint64).astype(np.int64)
    for c in (0x21F0AAAD, 0xD35A2D97, 0xFFFFFFFF, 1):
        got = t_ds._mul32(torch.from_numpy(x), c).numpy()
        assert got.tolist() == [(int(v) * c) % 2**32 for v in x]
    xt = torch.from_numpy(x)
    assert t_ds._hash32(xt).tolist() == [t_ds._hash32(int(v)) for v in x]
    counter = torch.arange(1 << 16, dtype=torch.int64)
    bits = t_ds.uniform_bits(counter, torch.tensor(9), t_ds.round_keys(3, "head-batch"))
    assert int(bits.min()) >= 0 and len(torch.unique(bits)) == 1 << 16


def test_draw_is_pinned():
    """The generator's integers for a fixed input: the card's draws are held
    to the CPU's (tests/test_torch_cuda.py), so pinning these pins both."""
    bits = t_ds.uniform_bits(torch.arange(4, dtype=torch.int64), torch.tensor(3),
                             t_ds.round_keys(0, "tail-batch"))
    assert bits.tolist() == PINNED_BITS
    assert t_ds.round_keys(0, "tail-batch") != t_ds.round_keys(0, "head-batch")
    assert t_ds.round_keys(0, "tail-batch") != t_ds.round_keys(1, "tail-batch")


PINNED_BITS = [4042119872823489487, 8676347971226017428, 3517802217901310612,
               71231523968408245]


def test_draw_index_rule():
    """Tail at even steps s draws index s//2 + 1, head at odd (s-1)//2 + 1:
    the per-mode count of draws from step 0."""
    for s in range(12):
        mode = "tail-batch" if s % 2 == 0 else "head-batch"
        assert int(t_ds.draw_index(torch.tensor(s), mode)) == s // 2 + 1


def _fused_setup():
    ds = make_random_kg(nentity=40, nrelation=3, ntriples=400, n_valid=5, n_test=5, seed=6)
    spec = ModelSpec(model_name="RotatE", nentity=40, nrelation=3, hidden_dim=8, gamma=6.0,
                     double_entity_embedding=True)
    tspec = TrainSpec(negative_sample_size=8, batch_size=16,
                      negative_adversarial_sampling=True)
    params = t_kge.init_params(spec, torch.Generator().manual_seed(0), device="cpu")
    return ds, spec, tspec, params


def _trainer(ds, spec, tspec, params, **kw):
    return FusedDeviceTrainer(spec, tspec, params, lr=0.01, warm_up_steps=10**9,
                              train=ds.train, seed=2, record_batches=True, **kw)


def test_draw_of_a_step_is_the_same_by_block_singles_resume_and_iterator(tmp_path):
    """The batches of steps 0-7 drawn by one block of 8, by 8 blocks of 1,
    by the per-step device iterator, and by a trainer resumed from a
    checkpoint at step 3 with the index streams where they were."""
    import copy

    ds, spec, tspec, params = _fused_setup()
    block = _trainer(ds, spec, tspec, params)
    block.run_block(8)
    want = block.recorded()

    singles, got = _trainer(ds, spec, tspec, params), []
    for i in range(8):
        singles.run_block(1)
        got += singles.recorded()
        if i == 2:
            cfg = RunConfig(model="RotatE", double_entity_embedding=True, hidden_dim=8,
                            gamma=6.0, nentity=40, nrelation=3)
            t_ckpt.save_model(singles, cfg, str(tmp_path))
            streams = copy.deepcopy((singles._head._stream, singles._tail._stream))
    resumed = _trainer(ds, spec, tspec, params)
    t_ckpt.restore_trainer(resumed, str(tmp_path))
    resumed._head._stream, resumed._tail._stream = streams
    assert resumed.step == 3
    resumed.run_block(5)
    it = t_ds.build_device_iterator(ds.train, 40, 3, 16, 8, seed=2)
    per_step = [next(it) for _ in range(8)]
    for other in (got, want[:3] + resumed.recorded(), per_step):
        for x, y in zip(want, other):
            assert x[3] == y[3]
            assert all(torch.equal(u, v) for u, v in zip(x[:3], y[:3]))


def test_int32_key_guard():
    train = np.zeros((4, 3), np.int32)
    for mod in (t_ds, j_ds):
        with pytest.raises(ValueError, match="int32"):
            mod.DeviceSampler(train, 2**17, 2**15, 4, 4, "tail-batch")


def test_build_train_iterator_device_backend():
    it = t_neg.build_train_iterator(_graph(), 60, 4, 8, 4, seed=1, prefetch_depth=6,
                                    backend="device")
    assert isinstance(it, t_ds.DeviceBidirectionalIterator) and it._depth == 3
    pos, neg, w, mode = next(it)
    assert mode == "tail-batch" and neg.shape == (8, 4) and pos.device.type == "cpu"
