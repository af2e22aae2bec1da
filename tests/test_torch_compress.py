"""The port's compressed-catalog codecs against ``repro.compress``.

The varint posting codec and the int8 quantizer must give the reference's
bytes exactly (snapshots carry both across packages), including the edge
shapes of ``tests/test_compression.py``; the table <-> CSR flattening must
match ``repro.core.inverted_index``.  Inputs are made with numpy from a seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from conftest import CFG, unit_factors  # noqa: E402

import repro.compress as jc  # noqa: E402
import repro_torch.compress as tc  # noqa: E402
from repro.core import inverted_index as jii  # noqa: E402
from repro_torch.core import inverted_index as tii  # noqa: E402

VARINT_CASES = {
    "empty": [], "zero": [0], "u32max": [2**32 - 1],
    "byte_edges": [1, 255, 256, 65535, 65536, 2**24 - 1, 2**24, 2**32 - 1],
    "n3": np.arange(3) * 1000, "n4": np.arange(4) * 1000,
    "n5": np.arange(5) * 1000, "n7": np.arange(7) * 1000,
    "n8": np.arange(8) * 1000, "n9": np.arange(9) * 1000,
    "small": np.arange(64) % 200,
    "random": np.random.default_rng(0).integers(0, 2**32, 1001),
}


@pytest.mark.parametrize("values", list(VARINT_CASES.values()),
                         ids=list(VARINT_CASES))
def test_group_varint_gives_reference_bytes(values):
    v = np.asarray(values, np.int64)
    got = tc.group_varint_encode(v)
    np.testing.assert_array_equal(got, jc.group_varint_encode(v))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(tc.group_varint_decode(got, v.size), v)


@pytest.mark.parametrize("cut,n", [(-1, 5), (0, 9), (-3, 5)])
def test_group_varint_rejects_truncated_streams_as_reference(cut, n):
    buf = jc.group_varint_encode(np.array([1, 2, 3, 4, 5]))
    buf = buf[:cut] if cut else buf
    for mod in (jc, tc):
        with pytest.raises(mod.CodecError):
            mod.group_varint_decode(buf, n)


def test_delta_codec_matches_reference():
    v = np.array([0, 0, 3, 3, 10, 2**31, 2**32 - 1], np.int64)
    np.testing.assert_array_equal(tc.delta_encode(v), jc.delta_encode(v))
    np.testing.assert_array_equal(tc.delta_decode(tc.delta_encode(v)), v)
    for bad in ([3, 1], [-1, 2], [2**32]):
        for mod in (jc, tc):
            with pytest.raises(mod.CodecError):
                mod.delta_encode(np.asarray(bad, np.int64))


def _csr(lists):
    postings = np.concatenate([np.asarray(x, np.int64) for x in lists])
    offsets = np.zeros(len(lists) + 1, np.int64)
    np.cumsum([len(x) for x in lists], out=offsets[1:])
    return postings, offsets


POSTING_CASES = {
    "restarts": [np.arange(500), [], [7], [], [],
                 [2**30 - 2, 2**30 - 1, 2**30, 2**30 + 1]],
    "all_empty": [[], [], []],
    "duplicates": [[4, 4, 4], [0], [9, 10, 2**32 - 1]],
    "random": [np.sort(np.random.default_rng(s).integers(0, 1 << 20, s * 37))
               for s in range(12)],
}


@pytest.mark.parametrize("lists", list(POSTING_CASES.values()),
                         ids=list(POSTING_CASES))
def test_encode_postings_gives_reference_bytes(lists):
    postings, offsets = _csr(lists)
    got = tc.encode_postings(postings, offsets)
    want = jc.encode_postings(postings, offsets)
    np.testing.assert_array_equal(got.data, want.data)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.n_values == want.n_values and got.nbytes == want.nbytes
    post2, off2 = tc.decode_postings(got)
    np.testing.assert_array_equal(post2, postings)
    np.testing.assert_array_equal(off2, offsets)
    # the port decodes the reference's stream and vice versa
    np.testing.assert_array_equal(
        tc.decode_postings(tc.CompressedPostings(
            want.data, want.counts, want.n_values))[0], postings)


@pytest.mark.parametrize("postings,offsets", [
    ([5, 3], [0, 2]),          # descending within a slot
    ([-1], [0, 1]),            # negative id
    ([1, 2], [0, 1]),          # framing mismatch
])
def test_encode_postings_validates_input_as_reference(postings, offsets):
    for mod in (jc, tc):
        with pytest.raises(mod.CodecError):
            mod.encode_postings(np.array(postings), np.array(offsets))


def _normal(n, k, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(n, k)) * scale).astype(
        np.float32)


def _halves(n, k):
    """Blocks whose elements sit exactly on rounding ties of the step."""
    x = (np.arange(n * k) % 255 - 127).astype(np.float32).reshape(n, k)
    x[:, 0] = 127.0                       # amax 127: scale exactly 1
    return x + np.float32(0.5) * (np.arange(k) % 2)[None, :]


QUANT_CASES = {
    "normal": (_normal(256, 16, 0, 3.0), 64),
    "zero_block": (np.zeros((64, 8), np.float32), 64),
    "mixed_zero_blocks": (np.concatenate([np.zeros((32, 10), np.float32),
                                          _normal(32, 10, 1),
                                          np.zeros((32, 10), np.float32)]),
                          32),
    "empty": (np.zeros((0, 8), np.float32), 8),
    "one_row_blocks": (_normal(7, 5, 2), 1),
    "ties": (_halves(40, 6), 8),
    "tiny_values": (_normal(64, 4, 3, 1e-38), 16),
    "huge_values": (_normal(64, 4, 4, 1e37), 32),
    "unit_rows": (unit_factors(2048, 10, 5), 512),
}


@pytest.mark.parametrize("x,block", list(QUANT_CASES.values()),
                         ids=list(QUANT_CASES))
def test_quantize_int8_gives_reference_bytes(x, block):
    want_q, want_s = jc.quantize_int8(x, block=block)
    got_q, got_s = tc.quantize_int8(torch.from_numpy(x), block=block)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy().view(np.uint32),
                                  want_s.view(np.uint32))
    np.testing.assert_array_equal(
        tc.dequantize_int8(got_q, got_s, block).numpy(),
        jc.dequantize_int8(want_q, want_s, block))
    np.testing.assert_array_equal(
        tc.quantization_error_bound(got_s).numpy(),
        jc.quantization_error_bound(want_s))


def test_quantize_int8_error_is_within_half_scale_and_bounds_scores():
    x = _normal(256, 16, 0, 3.0)
    q, scales = tc.quantize_int8(torch.from_numpy(x), block=64)
    err = (tc.dequantize_int8(q, scales, 64) - torch.from_numpy(x)).abs()
    bound = tc.quantization_error_bound(scales).repeat_interleave(64)[:, None]
    assert bool((err <= bound + 1e-7).all())
    users = _normal(5, 16, 9)
    got = tc.score_error_bound(scales, torch.from_numpy(users)).numpy()
    want = jc.score_error_bound(scales.numpy(), users)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the bound holds for every item against every query
    deq = tc.dequantize_int8(q, scales, 64).numpy().astype(np.float64)
    score_err = np.abs(users.astype(np.float64) @ (deq - x).T)
    assert (score_err <= np.repeat(got, 64, axis=1) + 1e-6).all()


def test_quantize_int8_refuses_ragged_blocks_as_reference():
    x = np.zeros((10, 4), np.float32)
    for fn, arg in ((jc.quantize_int8, x),
                    (tc.quantize_int8, torch.from_numpy(x))):
        for block in (3, 0):
            with pytest.raises(ValueError):
                fn(arg, block=block)


@pytest.mark.parametrize("n,bucket", [(300, 512), (300, 4), (1000, 16),
                                      (5, 1)])
def test_table_csr_round_trip_matches_reference(n, bucket):
    import jax.numpy as jnp
    from repro.core.mapping import sparse_map
    tau, vals = sparse_map(jnp.asarray(unit_factors(n, 16, n)), CFG)
    table, counts, _ = tii.build_segment(np.asarray(tau), CFG.p, bucket,
                                         np.asarray(vals) != 0)
    got = tii.table_to_csr(table, counts)
    want = jii.table_to_csr(table, counts)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    t2, c2 = tii.csr_to_table(*got, bucket, sentinel=n)
    w2, wc2 = jii.csr_to_table(*want, bucket, sentinel=n)
    np.testing.assert_array_equal(t2, table)
    np.testing.assert_array_equal(c2, counts)
    np.testing.assert_array_equal(t2, w2)
    np.testing.assert_array_equal(c2, wc2)
    assert t2.dtype == w2.dtype and c2.dtype == wc2.dtype
    # through the varint codec, as a compressed snapshot stores it
    cp = tc.encode_postings(*got)
    np.testing.assert_array_equal(
        tii.csr_to_table(*tc.decode_postings(cp), bucket, sentinel=n)[0],
        table)
    if bucket > 1 and int(counts.max()) > 1:
        for mod in (jii, tii):
            with pytest.raises(ValueError, match="bucket"):
                mod.csr_to_table(*got, 1, sentinel=n)
