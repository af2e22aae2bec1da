"""The port's retrieval kernels (plain versions) against the JAX package.

The JAX side runs its Pallas kernels in interpret mode.  Both sides get the
same mapped patterns (from the reference's ``sparse_map``), so each case
tests the kernel and not the map step.  Rows, counts, skip maps and masks
must match exactly; empty slots are (NEG, -1) on both sides.

Scores are held within 4 ulp of the dot product's scale, ``|u| * max |v|``,
which bounds ``sum_d |u_d v_d|``.  The reference's own dot is not one fixed
order: on the CPU it equals a sequential fused multiply-add loop for some
tile shapes and not for others, and on a cancelling sum two orders differ by
more than 4 ulp of the (small) result while both sit within an ulp of the
scale.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from conftest import CFG, unit_factors  # noqa: E402

from repro.compress import quantize as jquant  # noqa: E402
from repro.core.inverted_index import DeviceIndex as JDeviceIndex  # noqa: E402
from repro.core.mapping import sparse_map as j_sparse_map  # noqa: E402
from repro.core.retrieval import masked_topk as j_masked_topk  # noqa: E402
from repro.kernels.gam_score import gam_score as j_gam_score  # noqa: E402
from repro_torch.core.inverted_index import DeviceIndex  # noqa: E402
from repro_torch.core.retrieval import masked_topk  # noqa: E402
tgr = importlib.import_module("repro_torch.kernels.gam_retrieve")  # noqa: E402

# the package re-exports a function of the same name, so load the module
jgr = importlib.import_module("repro.kernels.gam_retrieve")
from repro_torch.kernels.gam_score import NEG, gam_score_plain  # noqa: E402

ULP = 4


def _mapped(factors, cfg=CFG):
    tau, vals = j_sparse_map(jnp.asarray(factors), cfg)
    return np.array(tau), np.array(vals) != 0.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _metas(tau, mask, spill, bn, n_rows=None):
    jm = jgr.build_retrieval_meta(tau, mask, CFG.p, n_rows=n_rows,
                                  spill_rows=spill, bn=bn)
    tm = tgr.build_retrieval_meta(tau, mask, CFG.p, n_rows=n_rows,
                                  spill_rows=spill, bn=bn, device="cpu")
    return jm, tm


def _assert_meta_equal(jm, tm):
    for f in ("p", "words", "bn", "n_rows", "n_pad", "n_blocks"):
        assert getattr(tm, f) == getattr(jm, f), f
    np.testing.assert_array_equal(tm.item_bits_t.numpy().view(np.uint32),
                                  np.asarray(jm.item_bits_t))
    np.testing.assert_array_equal(tm.block_union.numpy().view(np.uint32),
                                  np.asarray(jm.block_union))
    np.testing.assert_array_equal(tm.block_spill.numpy(),
                                  np.asarray(jm.block_spill))
    np.testing.assert_array_equal(tm.spill8.numpy(), np.asarray(jm.spill8))


def assert_scores_close(got, want, users, items):
    """(Q, kappa) scores within 4 ulp of each query's dot-product scale."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = (np.linalg.norm(np.asarray(users, np.float64), axis=1)
             * np.linalg.norm(np.asarray(items, np.float64), axis=1).max())
    tol = ULP * np.spacing(scale.astype(np.float32))[:, None]
    bad = np.abs(got.astype(np.float64) - want) > tol
    assert not bad.any(), (f"{bad.sum()} scores differ by more than {ULP} "
                           f"ulp of the scale: {got[bad][:5]} vs {want[bad][:5]}")


def _assert_retrieve_equal(got, want, users, items):
    w_vals = np.asarray(want.vals)
    g_vals = got.vals.numpy()
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    np.testing.assert_array_equal(got.blk_counts.numpy(),
                                  np.asarray(want.blk_counts))
    np.testing.assert_array_equal(got.skipped.numpy(),
                                  np.asarray(want.skipped))
    empty = w_vals <= NEG / 2
    np.testing.assert_array_equal(g_vals <= NEG / 2, empty)
    assert (g_vals[empty] == NEG).all()
    assert_scores_close(np.where(empty, 0, g_vals), np.where(empty, 0, w_vals),
                        users, items)


def _run_both(users, items, tau, mask, q_tau, q_mask, kappa, *, bn, bq=32,
              min_overlap=1, bucket=None, alive=None):
    spill = None
    if bucket is not None:
        spill = np.asarray(JDeviceIndex.build(tau, CFG.p, bucket,
                                              mask=mask).spill)
    jm, tm = _metas(tau, mask, spill, bn)
    _assert_meta_equal(jm, tm)
    want = jgr.gam_retrieve(users, items, q_tau, q_mask, jm, kappa,
                            min_overlap=min_overlap, alive=alive, bq=bq,
                            interpret=True, loop_merge=False)
    got = tgr.gam_retrieve_plain(
        _t(users), _t(items), _t(q_tau), _t(q_mask), tm, kappa,
        min_overlap=min_overlap, bq=bq,
        alive=None if alive is None else _t(alive))
    _assert_retrieve_equal(got, want, users, items)
    return got


@pytest.mark.parametrize("n,q,kappa,mo,bucket,bn,bq", [
    (350, 16, 10, 2, 512, 128, 32),    # plain randomized catalog
    (300, 7, 5, 1, 4, 64, 8),          # tiny bucket forces spill candidates
    (123, 3, 50, 3, 256, 32, 8),       # kappa > candidates, ragged shapes
    (513, 11, 17, 2, 8, 96, 8),        # spill + non-divisible Q and N blocks
    (200, 9, 10, 0, 512, 64, 12),      # min_overlap=0, bq not a multiple of 8
])
def test_plain_gam_retrieve_matches_reference(n, q, kappa, mo, bucket, bn, bq):
    items = unit_factors(n, 16, n)
    users = unit_factors(q, 16, n + 1)
    tau, mask = _mapped(items)
    q_tau, q_mask = _mapped(users)
    _run_both(users, items, tau, mask, q_tau, q_mask, min(kappa, n), bn=bn,
              bq=bq, min_overlap=mo, bucket=bucket)


def test_plain_gam_retrieve_ties_break_by_lowest_row():
    base = unit_factors(8, 16, 0)
    items = np.concatenate([base] * 8)            # rows i, i+8, ... tie
    users = base[:4]
    tau, mask = _mapped(items)
    q_tau, q_mask = _mapped(users)
    got = _run_both(users, items, tau, mask, q_tau, q_mask, 12, bn=16, bq=8,
                    bucket=512)
    rows = got.rows.numpy()
    for qi in range(4):                            # equal scores: row asc
        s = got.vals.numpy()[qi]
        for a in range(11):
            if s[a] == s[a + 1]:
                assert rows[qi, a] < rows[qi, a + 1]


def test_plain_gam_retrieve_all_empty_rows():
    items = unit_factors(200, 16, 5)
    users = unit_factors(6, 16, 6)
    tau, mask = _mapped(items)
    q_tau, q_mask = _mapped(users)
    got = _run_both(users, items, tau, mask, q_tau, q_mask, 10, bn=64,
                    min_overlap=17)
    assert (got.rows.numpy() == -1).all() and (got.vals.numpy() == NEG).all()
    assert got.skipped.numpy().all() and (got.blk_counts.numpy() == 0).all()


def test_plain_gam_retrieve_block_skipping_on_clustered_catalog():
    rng = np.random.default_rng(2)
    centers = unit_factors(8, 16, 7)
    items = np.repeat(centers, 64, axis=0) + \
        0.04 * rng.normal(size=(512, 16)).astype(np.float32)
    items /= np.linalg.norm(items, axis=1, keepdims=True)
    users = centers[:2] + 0.04 * rng.normal(size=(2, 16)).astype(np.float32)
    tau, mask = _mapped(items)
    q_tau, q_mask = _mapped(users)
    got = _run_both(users, items, tau, mask, q_tau, q_mask, 10, bn=64, bq=8,
                    min_overlap=4, bucket=4096)
    assert got.skipped.numpy().mean() > 0.2


def test_plain_gam_retrieve_alive_and_exact_path():
    items = unit_factors(100, 16, 12)
    users = unit_factors(4, 16, 13)
    tau, mask = _mapped(items)
    q_tau, q_mask = _mapped(users)
    alive = np.ones(100, bool)
    alive[::3] = False
    got = _run_both(users, items, tau, mask, q_tau, q_mask, 10, bn=32,
                    min_overlap=0, alive=alive)
    np.testing.assert_array_equal(got.blk_counts.numpy().sum(1),
                                  np.full(4, int(alive.sum())))


def test_plain_gam_retrieve_chunked_walk_matches_one_chunk(monkeypatch):
    """The plain version's item chunking does not change the answer."""
    items = unit_factors(700, 16, 21)
    users = unit_factors(9, 16, 22)
    tau, mask = _mapped(items)
    q_tau, q_mask = _mapped(users)
    tm = tgr.build_retrieval_meta(tau, mask, CFG.p, bn=32, device="cpu")
    args = (_t(users), _t(items), _t(q_tau), _t(q_mask), tm, 10)
    whole = tgr.gam_retrieve_plain(*args, min_overlap=2)
    monkeypatch.setattr(tgr, "_PLAIN_CHUNK", 9 * 32)      # one block a chunk
    chunked = tgr.gam_retrieve_plain(*args, min_overlap=2)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("n,bn,spill", [(64, 256, None), (1000, 96, [3, 999]),
                                        (257, 8, [0]), (0, 256, None)])
def test_build_retrieval_meta_matches_reference(n, bn, spill):
    items = unit_factors(max(n, 1), 16, 31)[:n]
    tau, mask = _mapped(items) if n else (np.zeros((0, 16), np.int32),
                                          np.zeros((0, 16), bool))
    jm, tm = _metas(tau, mask, spill, bn, n_rows=max(n, 5))
    _assert_meta_equal(jm, tm)
    np.testing.assert_array_equal(
        tgr.pack_patterns(tau, mask, CFG.p).numpy().view(np.uint32)
        if n else np.zeros((0, jm.words), np.uint32),
        jgr.pack_patterns(tau, mask, CFG.p) if n
        else np.zeros((0, jm.words), np.uint32))


def test_row_capacity_and_host_helpers_match_reference():
    assert tgr.ROW_CAPACITY == jgr.ROW_CAPACITY
    assert tgr.TOPK_EMPTY_ROW == jgr.TOPK_EMPTY_ROW
    empty = (np.zeros((0, 16), np.int32), np.zeros((0, 16), bool))
    for mod, on in ((jgr, {}), (tgr, {"device": "cpu"})):
        with pytest.raises(mod.RowCapacityError):
            mod.build_retrieval_meta(*empty, CFG.p,
                                     n_rows=mod.ROW_CAPACITY + 1, bn=256,
                                     **on)
        with pytest.raises(ValueError):         # fewer rows than patterns
            mod.build_retrieval_meta(np.zeros((3, 16), np.int32),
                                     np.ones((3, 16), bool), CFG.p, n_rows=2,
                                     **on)
    for q in (1, 7, 8, 9, 33, 256):
        for bq in (8, 12, 32, 64):
            assert tgr.effective_bq(q, bq) == jgr.effective_bq(q, bq)
            sk = np.random.default_rng(q * bq).random(
                (-(-q // jgr.effective_bq(q, bq)), 5)) < 0.5
            np.testing.assert_array_equal(tgr.expand_tile_skips(sk, q, bq),
                                          jgr.expand_tile_skips(sk, q, bq))
    vals = np.array([[0.5, NEG, 0.1], [NEG, NEG, NEG]], np.float32)
    rows = np.array([[3, -1, 7], [-1, -1, -1]], np.int32)
    for got, want in zip(tgr.export_topk(vals, rows, offset=100),
                         jgr.export_topk(vals, rows, offset=100)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("q,n,k", [(4, 64, 8), (128, 512, 16), (37, 1000, 10),
                                   (1, 2048, 64), (130, 513, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_gam_score_matches_reference(q, n, k, dtype):
    r = np.random.default_rng(q * n + k)
    u = r.normal(size=(q, k)).astype(np.float32)
    v = r.normal(size=(n, k)).astype(np.float32)
    mask = r.random((q, n)) < 0.3
    want = j_gam_score(jnp.asarray(u, dtype), jnp.asarray(v, dtype),
                       jnp.asarray(mask), bq=32, bn=128, interpret=True)
    tdt = getattr(torch, dtype)
    got = gam_score_plain(_t(u).to(tdt), _t(v).to(tdt), _t(mask))
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)
    assert (got.numpy()[~mask] == NEG).all()


@pytest.mark.parametrize("n,q,kappa,mo,bucket", [(400, 20, 10, 2, 512),
                                                 (300, 7, 5, 1, 4),
                                                 (123, 3, 50, 3, 256)])
def test_masked_topk_and_candidate_masks_match_reference(n, q, kappa, mo,
                                                         bucket):
    items = unit_factors(n, 16, 40 + n)
    users = unit_factors(q, 16, 41 + n)
    tau, mask = _mapped(items)
    q_tau, q_mask = _mapped(users)
    jdev = JDeviceIndex.build(tau, CFG.p, bucket, mask=mask)
    tdev = DeviceIndex.build(tau, CFG.p, bucket, mask=mask, device="cpu")
    for f in ("table", "counts", "spill"):
        np.testing.assert_array_equal(getattr(tdev, f).numpy(),
                                      np.asarray(getattr(jdev, f)))
    jmasks = jdev.batch_candidate_mask(jnp.asarray(q_tau), mo,
                                       jnp.asarray(q_mask))
    tmasks = tdev.batch_candidate_mask(_t(q_tau), mo, _t(q_mask))
    np.testing.assert_array_equal(tmasks.numpy(), np.asarray(jmasks))
    np.testing.assert_array_equal(
        tdev.candidate_mask(_t(q_tau[0]), mo, _t(q_mask[0])).numpy(),
        np.asarray(jdev.candidate_mask(jnp.asarray(q_tau[0]), mo,
                                       jnp.asarray(q_mask[0]))))
    kk = min(kappa, n)
    w_vals, w_ids = j_masked_topk(jnp.asarray(users), jnp.asarray(items),
                                  jmasks, kk)
    g_vals, g_ids = masked_topk(_t(users), _t(items), tmasks, kk)
    np.testing.assert_array_equal(g_ids.numpy(), np.asarray(w_ids))
    w_vals = np.asarray(w_vals)
    real = w_vals > NEG / 2
    assert_scores_close(np.where(real, g_vals.numpy(), 0),
                        np.where(real, w_vals, 0), users, items)
    np.testing.assert_array_equal(g_vals.numpy()[~real], w_vals[~real])


def test_kernel_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the kernel wrappers raise; only ops dispatches."""
    from repro_torch.kernels import ops
    gam_score = importlib.import_module("repro_torch.kernels.gam_score")
    tess_project = importlib.import_module(
        "repro_torch.kernels.tess_project")
    z = torch.zeros((2, 4))
    with pytest.raises(ValueError):
        tess_project.tess_project(z)
    with pytest.raises(ValueError):
        gam_score.gam_score(z, z, torch.ones((2, 2), dtype=torch.bool))
    assert ops.tess_project(z)[0].shape == (2, 4)
    assert tess_project.tess_project.launches == 0


def test_builders_default_to_the_card_and_raise_without_one(monkeypatch):
    """``build_retrieval_meta`` and ``DeviceIndex.build`` without a device
    mean the card: with none present they raise, naming ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tau, mask = _mapped(unit_factors(40, 16, 9))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgr.build_retrieval_meta(tau, mask, CFG.p, bn=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceIndex.build(tau, CFG.p, 64, mask=mask)
    assert tgr.build_retrieval_meta(tau, mask, CFG.p, bn=8,
                                    device="cpu").n_pad == 40
    assert DeviceIndex.build(tau, CFG.p, 64, mask=mask,
                             device="cpu").table.device.type == "cpu"


# ------------------------------------------------------------ the int8 path


def _q_metas(tau, mask, spill, bn, factors, n_rows=None):
    kw = dict(n_rows=n_rows, spill_rows=spill, bn=bn, factors=factors,
              quantize="int8")
    return (jgr.build_retrieval_meta(tau, mask, CFG.p, **kw),
            tgr.build_retrieval_meta(tau, mask, CFG.p, **kw, device="cpu"))


def _assert_slab_equal(jm, tm):
    assert tm.quantize == jm.quantize == "int8"
    np.testing.assert_array_equal(tm.factors_q.numpy(),
                                  np.asarray(jm.factors_q))
    np.testing.assert_array_equal(tm.scales.numpy().view(np.uint32),
                                  np.asarray(jm.scales).view(np.uint32))
    assert tuple(tm.scales.shape) == (1, tm.n_blocks)


@pytest.mark.parametrize("n,n_rows,bn", [(64, None, 256), (1000, None, 96),
                                         (257, 300, 8), (350, 512, 128)])
def test_build_retrieval_meta_int8_slab_matches_reference(n, n_rows, bn):
    items = unit_factors(n, 16, 60 + n) * 3.0
    tau, mask = _mapped(items)
    jm, tm = _q_metas(tau, mask, None, bn, items, n_rows)
    _assert_meta_equal(jm, tm)
    _assert_slab_equal(jm, tm)
    # quantize_meta on existing metadata attaches the same slab
    _assert_slab_equal(jm, tgr.quantize_meta(
        tgr.build_retrieval_meta(tau, mask, CFG.p, n_rows=n_rows, bn=bn,
                                 device="cpu"),
        _t(items)))


def test_int8_meta_errors_match_reference():
    tau, mask = _mapped(unit_factors(40, 16, 3))
    for mod, on in ((jgr, {}), (tgr, {"device": "cpu"})):
        with pytest.raises(ValueError, match="quantize"):
            mod.build_retrieval_meta(tau, mask, CFG.p, quantize="int4", **on)
        with pytest.raises(ValueError, match="factor slab"):
            mod.build_retrieval_meta(tau, mask, CFG.p, quantize="int8", **on)
        meta = mod.build_retrieval_meta(tau, mask, CFG.p, bn=8, **on)
        with pytest.raises(ValueError, match="n_pad"):
            mod.quantize_meta(meta, np.zeros((meta.n_pad + 1, 16), np.float32))
    with pytest.raises(ValueError, match="int8 slab"):
        tgr.gam_retrieve_q_plain(_t(unit_factors(2, 16, 1)), _t(tau[:2]),
                                 _t(mask[:2]), meta, 10)


def _assert_pool_close(got, want, users, items) -> int:
    """Counts and skip map exact; pool scores within 4 ulp of the scale;
    pool rows exact except on queries where every differing row scores
    within 4 ulp of the pool's boundary.  Returns the queries excused."""
    np.testing.assert_array_equal(got.blk_counts.numpy(),
                                  np.asarray(want.blk_counts))
    np.testing.assert_array_equal(got.skipped.numpy(),
                                  np.asarray(want.skipped))
    g_vals, w_vals = got.vals.numpy(), np.asarray(want.vals)
    g_rows, w_rows = got.rows.numpy(), np.asarray(want.rows)
    np.testing.assert_array_equal(g_vals <= NEG / 2, w_vals <= NEG / 2)
    empty = w_vals <= NEG / 2
    assert_scores_close(np.where(empty, 0, g_vals), np.where(empty, 0, w_vals),
                        users, items)
    tol = ULP * np.spacing(np.float32(
        np.linalg.norm(users, axis=1).max()
        * np.linalg.norm(items, axis=1).max()))
    excused = 0
    for qi in np.nonzero((g_rows != w_rows).any(axis=1))[0]:
        edge = w_vals[qi, -1]
        g_only = ~np.isin(g_rows[qi], w_rows[qi])
        w_only = ~np.isin(w_rows[qi], g_rows[qi])
        assert (np.abs(g_vals[qi][g_only] - edge) <= 2 * tol).all(), qi
        assert (np.abs(w_vals[qi][w_only] - edge) <= 2 * tol).all(), qi
        excused += 1
    return excused


Q_CASES = [
    (350, 16, 10, 2, 512, 128, 32),
    (300, 7, 5, 1, 4, 64, 8),
    (123, 3, 50, 3, 256, 32, 8),
    (513, 11, 17, 2, 8, 96, 8),
    (200, 9, 10, 0, 512, 64, 12),
    (2048, 64, 128, 1, 64, 256, 32),
]


@pytest.mark.parametrize("n,q,pool,mo,bucket,bn,bq", Q_CASES)
@pytest.mark.parametrize("with_alive", [False, True])
def test_plain_gam_retrieve_q_matches_reference_kernel(n, q, pool, mo, bucket,
                                                       bn, bq, with_alive):
    items = unit_factors(n, 16, n)
    users = unit_factors(q, 16, n + 1)
    tau, mask = _mapped(items)
    q_tau, q_mask = _mapped(users)
    spill = np.asarray(JDeviceIndex.build(tau, CFG.p, bucket, mask=mask).spill)
    jm, tm = _q_metas(tau, mask, spill, bn, items)
    _assert_slab_equal(jm, tm)
    alive = np.ones(n, bool)
    if with_alive:
        alive[::7] = False
    pool = min(pool, jm.n_pad)
    want = jgr._gam_retrieve_q(
        jnp.asarray(users), jm.factors_q, jm.scales, jnp.asarray(q_tau),
        jnp.asarray(q_mask), jnp.asarray(alive), jm.item_bits_t,
        jm.block_union, jm.block_spill, jm.spill8, kappa=pool,
        min_overlap=mo, bq=bq, bn=jm.bn, words=jm.words, n_pad=jm.n_pad,
        interpret=True, loop_merge=False)
    got = tgr.gam_retrieve_q_plain(
        _t(users), _t(q_tau), _t(q_mask), tm, pool, min_overlap=mo, bq=bq,
        alive=_t(alive) if with_alive else None)
    decoded = jquant.dequantize_int8(jm.factors_q, np.asarray(jm.scales)[0],
                                     jm.bn)
    excused = _assert_pool_close(got, want, users, decoded)
    assert excused <= q // 4, f"{excused} of {q} queries excused"


def test_plain_gam_retrieve_q_chunked_walk_matches_one_chunk(monkeypatch):
    items = unit_factors(700, 16, 23)
    users = unit_factors(9, 16, 24)
    tau, mask = _mapped(items)
    q_tau, q_mask = _mapped(users)
    tm = tgr.build_retrieval_meta(tau, mask, CFG.p, bn=32, factors=items,
                                  quantize="int8", device="cpu")
    args = (_t(users), _t(q_tau), _t(q_mask), tm, 40)
    whole = tgr.gam_retrieve_q_plain(*args, min_overlap=2)
    monkeypatch.setattr(tgr, "_PLAIN_CHUNK", 9 * 32)      # one block a chunk
    chunked = tgr.gam_retrieve_q_plain(*args, min_overlap=2)
    for a, b in zip(whole, chunked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("n,q,kappa,pool,mo", [(350, 16, 10, 40, 2),
                                               (123, 5, 10, 20, 4),
                                               (513, 11, 17, 17, 1),
                                               (64, 6, 30, 64, 17)])
def test_rerank_pool_matches_reference(n, q, kappa, pool, mo):
    items = unit_factors(n, 16, 70 + n)
    users = unit_factors(q, 16, 71 + n)
    tau, mask = _mapped(items)
    q_tau, q_mask = _mapped(users)
    jm, _ = _q_metas(tau, mask, None, 32, items)
    pool_res = jgr._gam_retrieve_q(
        jnp.asarray(users), jm.factors_q, jm.scales, jnp.asarray(q_tau),
        jnp.asarray(q_mask), jnp.ones(n, bool), jm.item_bits_t,
        jm.block_union, jm.block_spill, jm.spill8, kappa=pool,
        min_overlap=mo, bq=8, bn=jm.bn, words=jm.words, n_pad=jm.n_pad,
        interpret=True, loop_merge=False)
    want = jgr._rerank_pool(pool_res, users, items, kappa)
    # a result built from four fields, as the reference's: no sums
    four = tgr.GamRetrieveResult(*(_t(a) for a in pool_res))
    assert four.seg_counts is None
    got = tgr.rerank_pool(four, _t(users), _t(items), kappa)
    assert got.seg_counts is None
    _assert_retrieve_equal(got, want, users, items)
    # the re-ranked scores are the kernels' exact f32 scores of their rows
    real = got.rows.numpy() >= 0
    exact = gam_score_plain(_t(users), _t(items),
                            torch.ones((q, n), dtype=torch.bool)).numpy()
    np.testing.assert_array_equal(
        got.vals.numpy()[real],
        np.take_along_axis(exact, np.maximum(got.rows.numpy(), 0), 1)[real])


def test_int8_kernel_wrapper_refuses_cpu_tensors():
    items = unit_factors(64, 16, 1)
    tau, mask = _mapped(items)
    tm = tgr.build_retrieval_meta(tau, mask, CFG.p, bn=32, factors=items,
                                  quantize="int8", device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tgr.gam_retrieve_q(_t(items[:2]), _t(tau[:2]), _t(mask[:2]), tm, 10)
    assert tgr.gam_retrieve_q.launches == 0


# the first blocks of the segments that seg_counts sums (17 blocks of 32
# rows): one over every block, eight uneven ones, one that is empty
SEGMENTS = {"one": None, "eight_uneven": (0, 1, 3, 4, 8, 9, 13, 15),
            "with_empty": (0, 2, 2, 7)}


@pytest.mark.parametrize("segments", list(SEGMENTS))
@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_plain_segment_sums_are_block_counts_by_segment(segments, quantize):
    """``seg_counts`` is ``blk_counts`` summed over each segment's blocks,
    exactly, in int32; the int8 path carries the pool's sums through
    ``rerank_pool``."""
    items = unit_factors(530, 16, 81)
    users = unit_factors(11, 16, 82)
    tau, mask = _mapped(items)
    q_tau, q_mask = _mapped(users)
    tm = tgr.build_retrieval_meta(tau, mask, CFG.p, bn=32, factors=items,
                                  quantize=quantize, device="cpu")
    assert tm.n_blocks == 17
    seg = SEGMENTS[segments]
    if quantize == "int8":
        pool = tgr.gam_retrieve_q_plain(_t(users), _t(q_tau), _t(q_mask), tm,
                                        40, min_overlap=2, segments=seg)
        got = tgr.rerank_pool(pool, _t(users), _t(items), 10)
        assert got.seg_counts is pool.seg_counts
    else:
        got = tgr.gam_retrieve_plain(_t(users), _t(items), _t(q_tau),
                                     _t(q_mask), tm, 10, min_overlap=2,
                                     segments=seg)
    blk = got.blk_counts.numpy().astype(np.int64)
    starts = [0] if seg is None else list(seg)
    want = np.stack([blk[:, a:b].sum(axis=1) for a, b in
                     zip(starts, starts[1:] + [tm.n_blocks])], axis=1)
    assert got.seg_counts.dtype == torch.int32
    np.testing.assert_array_equal(got.seg_counts.numpy(), want)
    assert want.sum() > 0


@pytest.mark.parametrize("segments", [(), (1, 4), (0, 5, 3), (0, 18)])
def test_segments_must_start_at_block_zero_and_rise(segments):
    items = unit_factors(530, 16, 81)
    tau, mask = _mapped(items)
    tm = tgr.build_retrieval_meta(tau, mask, CFG.p, bn=32, device="cpu")
    with pytest.raises(ValueError, match="segments"):
        tgr.gam_retrieve_plain(_t(items[:3]), _t(items), _t(tau[:3]),
                               _t(mask[:3]), tm, 5, segments=segments)


def test_fetch_answer_copies_the_full_counts_only_when_asked():
    items = unit_factors(530, 16, 81)
    users = unit_factors(6, 16, 83)
    tau, mask = _mapped(items)
    q_tau, q_mask = _mapped(users)
    tm = tgr.build_retrieval_meta(tau, mask, CFG.p, bn=32, device="cpu")
    res = tgr.gam_retrieve_plain(_t(users), _t(items), _t(q_tau), _t(q_mask),
                                 tm, 10, min_overlap=2, segments=(0, 9))
    fa = tgr.fetch_answer
    summed, full = fa.summed, fa.full
    ans = fa(res, full_counts=False)
    assert (fa.summed, fa.full) == (summed + 1, full)
    assert ans.blk_counts is None and ans.skipped is None
    assert ans.seg_counts.dtype == np.int64
    np.testing.assert_array_equal(ans.seg_counts, res.seg_counts.numpy())
    np.testing.assert_array_equal(ans.vals, res.vals.numpy())
    np.testing.assert_array_equal(ans.rows, res.rows.numpy())
    assert ans.nbytes == 6 * 10 * 8 + 6 * 2 * 4
    whole = fa(res, full_counts=True)
    assert (fa.summed, fa.full) == (summed + 1, full + 1)
    np.testing.assert_array_equal(whole.blk_counts, res.blk_counts.numpy())
    np.testing.assert_array_equal(whole.skipped, res.skipped.numpy())
    assert whole.nbytes == (ans.nbytes + res.blk_counts.numel() * 4
                            + res.skipped.numel())
