"""The port's CSR inverted indexes, pattern dictionary and tessellation
oracles against ``repro``'s, on the CPU.

Same inputs (numpy, from a seed) through both packages: ``InvertedIndex``
against the naive overlap, the reference's index and the dense-bucket
``DeviceIndex``; ``CompressedInvertedIndex`` equal to the flat index with
the reference's varint bytes; pattern ids equal to ``np.unique``'s; the
f64 tessellation oracles equal to the reference's.  Everything here is
exact except the oracles' normalised rows (within 1e-15).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from conftest import CFG, unit_factors  # noqa: E402

from repro.compress.patterns import (  # noqa: E402
    pattern_dict_encode as j_encode)
from repro.compress.postings import CompressedPostings  # noqa: E402
from repro.core import inverted_index as jii  # noqa: E402
from repro.core import tessellation as jtess  # noqa: E402
from repro.core.mapping import GamConfig as JConfig  # noqa: E402
from repro.core.mapping import sparse_map as j_sparse_map  # noqa: E402
from repro_torch.compress import (CodecError, encode_postings,  # noqa: E402
                                  pattern_dict_decode, pattern_dict_encode,
                                  pattern_dict_nbytes)
from repro_torch.core import inverted_index as tii  # noqa: E402
from repro_torch.core import tessellation as ttess  # noqa: E402

CPU = "cpu"


def _mapped(factors, cfg=CFG):
    tau, vals = j_sparse_map(jnp.asarray(np.asarray(factors, np.float32)),
                             cfg)
    return np.asarray(tau), np.asarray(vals) != 0.0


def _clustered(n, k, n_clusters, seed):
    """Unit rows near a few centres: many items share one pattern."""
    rng = np.random.default_rng(seed)
    centres = unit_factors(n_clusters, k, seed + 1)
    z = centres[rng.integers(0, n_clusters, n)] + 0.02 * rng.normal(
        size=(n, k)).astype(np.float32)
    return (z / np.linalg.norm(z, axis=1, keepdims=True)).astype(np.float32)


CATALOGS = {
    "random": lambda: unit_factors(400, CFG.k, 3),
    "clustered": lambda: _clustered(600, CFG.k, 7, 5),
}


def _same_answers(got, want):
    assert len(got) == len(want)
    for (g_ids, g_ov), (w_ids, w_ov) in zip(got, want):
        assert g_ids.dtype == torch.int32 and g_ov.dtype == torch.int64
        np.testing.assert_array_equal(g_ids.numpy(), w_ids)
        np.testing.assert_array_equal(g_ov.numpy(), w_ov)


# ---------------------------------------------------------------- flat CSR


def test_inverted_index_matches_naive():
    cfg = JConfig(k=8, scheme="parse_tree")
    tau, _ = _mapped(unit_factors(200, 8, 3), cfg)
    idx = tii.InvertedIndex(tau, cfg.p, device=CPU)
    q = tau[17]
    ids, ov = idx.query(q)
    naive_ov = (tau[:, :, None] == q[None, None, :]).sum((1, 2))
    naive_ids = np.nonzero(naive_ov >= 1)[0]
    np.testing.assert_array_equal(ids.numpy(), naive_ids)
    np.testing.assert_array_equal(ov.numpy(), naive_ov[naive_ids])
    assert 17 in ids.tolist()          # an item is its own candidate


@pytest.mark.parametrize("catalog", sorted(CATALOGS))
@pytest.mark.parametrize("min_overlap", [0, 1, 2, 4])
def test_inverted_index_matches_reference(catalog, min_overlap):
    tau, mask = _mapped(CATALOGS[catalog]())
    q_tau, q_mask = _mapped(unit_factors(24, CFG.k, 4))
    q_mask[3] = False                   # a query with no indexed slot
    want = jii.InvertedIndex(tau, CFG.p, mask)
    got = tii.InvertedIndex(tau, CFG.p, mask, device=CPU)
    assert got.postings.dtype == torch.int32
    np.testing.assert_array_equal(got.postings.numpy(), want.postings)
    np.testing.assert_array_equal(got.offsets.numpy(), want.offsets)
    assert got.nbytes == want.nbytes
    for s in range(0, CFG.p, 17):
        np.testing.assert_array_equal(got.posting_list(s).numpy(),
                                      want.posting_list(s))
    _same_answers(got.batch_query(q_tau, min_overlap, q_mask),
                  want.batch_query(q_tau, min_overlap, q_mask))
    _same_answers([got.query(q_tau[5], min_overlap, q_mask[5])],
                  [want.query(q_tau[5], min_overlap, q_mask[5])])


def test_candidates_are_the_batch_answers_flat():
    tau, mask = _mapped(CATALOGS["clustered"]())
    q_tau, q_mask = _mapped(unit_factors(9, CFG.k, 8))
    idx = tii.InvertedIndex(tau, CFG.p, mask, device=CPU)
    qrow, ids, ov = idx.candidates(q_tau, 2, q_mask)
    key = qrow * idx.n_items + ids
    assert torch.equal(key, torch.sort(key).values)      # (row, id) order
    for qi, (w_ids, w_ov) in enumerate(idx.batch_query(q_tau, 2, q_mask)):
        assert torch.equal(ids[qrow == qi].to(torch.int32), w_ids)
        assert torch.equal(ov[qrow == qi], w_ov)


def test_counter_chunks_give_the_unchunked_answer(monkeypatch):
    """A request cut into chunks of queries answers as one chunk."""
    tau, mask = _mapped(CATALOGS["clustered"]())
    q_tau, q_mask = _mapped(unit_factors(11, CFG.k, 9))
    flat = tii.InvertedIndex(tau, CFG.p, mask, device=CPU)
    comp = flat.compress()
    whole = [idx.candidates(q_tau, 2, q_mask) for idx in (flat, comp)]
    monkeypatch.setattr(tii, "_COUNTER_CHUNK", 3 * flat.n_items)
    for idx, want in zip((flat, comp), whole):
        for a, b in zip(idx.candidates(q_tau, 2, q_mask), want):
            assert torch.equal(a, b)


def test_flat_index_matches_device_index():
    cfg = JConfig(k=8, scheme="parse_tree")
    tau, _ = _mapped(unit_factors(150, 8, 4), cfg)
    cpu = tii.InvertedIndex(tau, cfg.p, device=CPU)
    dev = tii.DeviceIndex.build(tau, cfg.p, bucket=256, device=CPU)
    want = jii.DeviceIndex.build(tau, cfg.p, bucket=256)
    for qi in (0, 7, 99):
        ids, _ = cpu.query(tau[qi], min_overlap=2)
        mask = dev.candidate_mask(torch.tensor(tau[qi]), min_overlap=2)
        np.testing.assert_array_equal(torch.nonzero(mask)[:, 0].numpy(),
                                      ids.numpy())
        np.testing.assert_array_equal(
            mask.numpy(),
            np.asarray(want.candidate_mask(jnp.asarray(tau[qi]), 2)))


def test_device_index_spill_keeps_the_flat_candidates():
    cfg = JConfig(k=6, scheme="one_hot")
    tau, _ = _mapped(unit_factors(300, 6, 5), cfg)
    dev = tii.DeviceIndex.build(tau, cfg.p, bucket=4, device=CPU)
    ids, _ = tii.InvertedIndex(tau, cfg.p, device=CPU).query(tau[0])
    mask = dev.candidate_mask(torch.tensor(tau[0]))
    assert set(ids.tolist()) <= set(torch.nonzero(mask)[:, 0].tolist())


# ---------------------------------------------------------- compressed CSR


@pytest.mark.parametrize("catalog", sorted(CATALOGS))
def test_compressed_index_equals_flat_with_reference_bytes(catalog):
    tau, mask = _mapped(CATALOGS[catalog]())
    want = jii.InvertedIndex(tau, CFG.p, mask).compress()
    flat = tii.InvertedIndex(tau, CFG.p, mask, device=CPU)
    got = flat.compress()
    assert got.n_patterns == want.n_patterns
    assert got.nbytes == want.nbytes < flat.nbytes
    for mine, ref in ((got.slot_patterns, want.slot_patterns),
                      (got.pattern_items, want.pattern_items)):
        np.testing.assert_array_equal(mine.data, ref.data)
        np.testing.assert_array_equal(mine.counts, ref.counts)
        assert mine.n_values == ref.n_values
    q_tau, q_mask = _mapped(unit_factors(20, CFG.k, 4))
    for mo in (1, 2, 4):
        _same_answers(got.batch_query(q_tau, mo, q_mask),
                      [(i.numpy(), o.numpy())
                       for i, o in flat.batch_query(q_tau, mo, q_mask)])
        _same_answers(got.batch_query(q_tau, mo, q_mask),
                      want.batch_query(q_tau, mo, q_mask))


def test_compressed_index_posting_lists_and_decompress_roundtrip():
    tau, mask = _mapped(unit_factors(300, CFG.k, 5))
    idx = tii.InvertedIndex(tau, CFG.p, mask, device=CPU)
    cidx = idx.compress()
    ref = jii.InvertedIndex(tau, CFG.p, mask).compress()
    for s in range(CFG.p):
        assert torch.equal(cidx.posting_list(s), idx.posting_list(s))
        np.testing.assert_array_equal(cidx.posting_list(s).numpy(),
                                      ref.posting_list(s))
    flat = cidx.decompress()
    assert torch.equal(flat.postings, idx.postings)
    assert torch.equal(flat.offsets, idx.offsets)
    assert (flat.n_items, flat.p, flat.k) == (idx.n_items, idx.p, idx.k)


def test_compressed_index_empty_query_and_empty_catalog():
    tau, mask = _mapped(unit_factors(10, CFG.k, 6))
    cidx = tii.InvertedIndex(tau, CFG.p, mask, device=CPU).compress()
    ids, ov = cidx.query(np.empty(0, np.int64), 1)
    assert ids.numel() == 0 and ov.numel() == 0
    empty = tii.InvertedIndex(np.zeros((0, CFG.k), np.int32), CFG.p,
                              device=CPU).compress()
    assert empty.n_patterns == 0
    ids, ov = empty.query(tau[0], 1, mask[0])
    assert ids.numel() == 0 and ov.numel() == 0


def test_duplicate_postings_cannot_be_pattern_factored():
    tau = np.array([[0, 0, 1], [2, 3, 4]], np.int32)    # slot 0 twice
    with pytest.raises(CodecError, match="duplicate"):
        tii.InvertedIndex(tau, 8, device=CPU).compress()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decode_slot_ranges_matches_reference(seed):
    """Values of every byte length (up to 2^32 - 1), empty slots, and slots
    requested out of order and twice."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 9, size=40)
    counts[[3, 17]] = 0
    lists = [np.sort(rng.integers(0, 2 ** int(rng.integers(4, 33)),
                                  size=c)).astype(np.int64) for c in counts]
    postings = np.concatenate(lists)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    cp = encode_postings(postings, offsets)
    ref_cp = CompressedPostings(cp.data, cp.counts, cp.n_values)
    slots = np.array([5, 3, 39, 0, 5, 17, 22], np.int64)
    want_vals, want_lens = jii._decode_slot_ranges(ref_cp, slots)
    vals, lens = tii._decode_slot_ranges(tii._Stream(cp, torch.device(CPU)),
                                         torch.as_tensor(slots))
    np.testing.assert_array_equal(vals.numpy(), want_vals)
    np.testing.assert_array_equal(lens.numpy(), want_lens)
    np.testing.assert_array_equal(vals.numpy(),
                                  np.concatenate([lists[s] for s in slots]))


# ------------------------------------------------------ pattern dictionary


@pytest.mark.parametrize("n,words,n_protos", [(300, 4, 5), (1000, 1, 40),
                                              (257, 7, 257), (1, 3, 1),
                                              (0, 2, 1)])
def test_pattern_dict_ids_equal_reference(n, words, n_protos):
    """The ids are np.unique's row order over uint32 words, including words
    at and past 2^31 (where a signed order would differ)."""
    rng = np.random.default_rng(n + words)
    protos = rng.integers(0, 2 ** 32, size=(n_protos, words), dtype=np.uint32)
    protos[0, 0] = 2 ** 32 - 1
    if n_protos > 1:
        protos[1, 0] = 2 ** 31
    bits = protos[rng.integers(0, n_protos, size=n)]
    want_uniq, want_inv = j_encode(bits)
    uniq, inv = pattern_dict_encode(bits)
    assert inv.dtype == torch.int32
    np.testing.assert_array_equal(uniq.numpy(), want_uniq.astype(np.int64))
    np.testing.assert_array_equal(inv.numpy(), want_inv)
    np.testing.assert_array_equal(pattern_dict_decode(uniq, inv).numpy(),
                                  bits.astype(np.int64))
    assert pattern_dict_nbytes(uniq, inv) == want_uniq.nbytes + want_inv.nbytes
    # the same bits held as int32 (how the port's bitsets store them)
    uniq32, inv32 = pattern_dict_encode(torch.from_numpy(bits.view(np.int32)))
    assert torch.equal(uniq32, uniq) and torch.equal(inv32, inv)


# ------------------------------------------------- tessellation oracles


@pytest.mark.parametrize("k,d", [(3, 1), (5, 1), (4, 2), (3, 3)])
def test_enumerate_gamma_matches_reference(k, d):
    got = ttess.enumerate_gamma(k, d)
    want = jtess.enumerate_gamma(k, d)
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-15)


@pytest.mark.parametrize("k,d", [(4, 1), (6, 1), (5, 2)])
def test_exhaustive_tess_vector_matches_reference(k, d):
    """The same closest vector, or (only on a near-tie) one exactly as
    close to z."""
    z = np.random.default_rng(k * d).normal(size=(64, k))
    got = ttess.exhaustive_tess_vector(z, d=d).numpy()
    want = jtess.exhaustive_tess_vector(z, d=d)
    zn = z / np.linalg.norm(z, axis=1, keepdims=True)
    np.testing.assert_allclose((got * zn).sum(1), (want * zn).sum(1),
                               rtol=0, atol=1e-14)
    same = np.abs(got - want).max(axis=1) <= 1e-15
    assert same.mean() > 0.95
    one = ttess.exhaustive_tess_vector(z[0], d=d).numpy()
    np.testing.assert_array_equal(one, got[0])


@pytest.mark.parametrize("k", [3, 5, 7])
def test_ternary_pattern_is_the_exhaustive_closest_vector(k):
    """Lemma 1 on the port: Algorithm 2 finds the closest ternary vector."""
    z = torch.from_numpy(np.random.default_rng(k).normal(size=(200, k)))
    a = ttess.tess_vector(z)
    best = ttess.exhaustive_tess_vector(z)
    zn = z / torch.linalg.vector_norm(z, dim=1, keepdim=True)
    torch.testing.assert_close((a * zn).sum(1), (best * zn).sum(1),
                               rtol=0, atol=1e-12)


def test_query_on_empty_posting_lists_at_min_overlap_zero_like_reference():
    """A query whose slots hold no posting, at min_overlap 0: the flat
    index returns every item (overlap 0), the compressed one none, in both
    packages."""
    rng = np.random.default_rng(3)
    tau = rng.integers(0, 20, size=(50, 4)).astype(np.int32)
    tau.sort(axis=1)
    tau[:, 1:] += np.arange(1, 4, dtype=np.int32) * 20   # distinct slots
    query = np.array([90, 91, 92, 93], np.int32)         # empty lists
    for mo in (0, 1):
        want = jii.InvertedIndex(tau, 100)
        got = tii.InvertedIndex(tau, 100, device=CPU)
        _same_answers([got.query(query, mo)], [want.query(query, mo)])
        _same_answers([got.compress().query(query, mo)],
                      [want.compress().query(query, mo)])
    assert got.query(query, 0)[0].numel() == 50
    assert got.compress().query(query, 0)[0].numel() == 0
