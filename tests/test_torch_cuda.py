"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present (decided
inside the test, never at import).  The file imports nothing of JAX, so it
also runs where JAX is not installed, without the suite's conftest:

    PYTHONPATH=src python -m pytest -q -m cuda --noconftest tests/test_torch_cuda.py
"""
import importlib
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.compress import quantize_int8  # noqa: E402
from repro_torch.core.inverted_index import build_segment  # noqa: E402
from repro_torch.core.mapping import GamConfig, sparse_map  # noqa: E402
gr = importlib.import_module("repro_torch.kernels.gam_retrieve")  # noqa: E402
gs = importlib.import_module("repro_torch.kernels.gam_score")  # noqa: E402
tp = importlib.import_module("repro_torch.kernels.tess_project")  # noqa: E402
from repro_torch.retriever import RetrieverSpec, open_retriever  # noqa: E402

pytestmark = pytest.mark.cuda

CFG = GamConfig(k=16, scheme="parse_tree", threshold=0.2)


def unit_factors(n: int, k: int = 16, seed: int = 0) -> np.ndarray:
    z = np.random.default_rng(seed).normal(size=(n, k)).astype(np.float32)
    return z / np.linalg.norm(z, axis=1, keepdims=True)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("b,k", [(4, 8), (100, 16), (257, 10), (32, 64),
                                 (1, 12), (5000, 256)])
def test_tess_project_kernel_equals_plain(dev, b, k):
    z = torch.from_numpy(np.random.default_rng(b + k).normal(size=(b, k))
                         .astype(np.float32)).to(dev)
    z[:, k // 2:] *= (z[:, k // 2:].abs() > 0.5)        # thresholded zeros
    pat, a = tp.tess_project(z)
    torch.cuda.synchronize()
    want_pat, want_a = tp.tess_project_plain(z)
    assert torch.equal(pat, want_pat)
    assert torch.equal(a, want_a)


def near_tie_rows(z: np.ndarray, ulp: int = 4) -> np.ndarray:
    """Rows whose top two float64 scaled running sums of Algorithm 2 are
    within ``ulp`` f32 ulp: their t* depends on rounding."""
    az = -np.sort(-np.abs(np.asarray(z, np.float64)), axis=-1)
    zs = np.cumsum(az, axis=-1) / np.sqrt(np.arange(1, az.shape[-1] + 1))
    top2 = -np.sort(-zs, axis=-1)[:, :2]
    return top2[:, 0] - top2[:, 1] <= ulp * np.spacing(
        top2[:, 0].astype(np.float32))


@pytest.mark.parametrize("b,k", [(7, 257), (64, 300), (3, 1000), (2, 4100)])
def test_tess_project_wide_kernel_equals_plain(dev, b, k):
    """The one-CTA-per-row kernel past TESS_THREAD_MAX_K (its first width,
    and rows wider than the 48 KB default shared memory): bit for bit as the
    plain version."""
    z = torch.from_numpy(np.random.default_rng(b * k).normal(size=(b, k))
                         .astype(np.float32)).to(dev)
    z[:, k // 2:] *= (z[:, k // 2:].abs() > 0.5)        # thresholded zeros
    z[0] = 0.0                                          # an all-zero row
    pat, a = tp.tess_project(z)
    torch.cuda.synchronize()
    want_pat, want_a = tp.tess_project_plain(z)
    assert torch.equal(pat, want_pat)
    assert torch.equal(a, want_a)


@pytest.mark.parametrize("k", [512, 2048])
def test_tess_project_wide_rows_equal_plain_except_near_ties(dev, k):
    """32,000 unit rows (the GAM head maps the vocab at k = d_model): equal
    to the plain version except rows certified as near-ties, counted."""
    z = np.random.default_rng(k).normal(size=(32000, k)).astype(np.float32)
    z /= np.linalg.norm(z, axis=1, keepdims=True)
    zt = torch.from_numpy(z).to(dev)
    before = tp.tess_project.launches
    pat, a = tp.tess_project(zt)
    torch.cuda.synchronize()
    assert tp.tess_project.launches == before + 1
    want_pat, want_a = tp.tess_project_plain(zt)
    diff = (pat != want_pat).any(dim=1).cpu().numpy()
    rows = np.nonzero(diff)[0]
    assert near_tie_rows(z[rows]).all(), rows[:8]
    same = torch.from_numpy(~diff).to(dev)
    assert torch.equal(a[same], want_a[same])
    print(f"k={k}: {rows.size} near-tie rows of 32000")


@pytest.mark.parametrize("k", [1, 16, 17, 32, 33, 256, 257, 1024, 1025, 2048,
                               4100, tp.TESS_MAX_K])
def test_tess_project_routes_at_their_edges_equal_plain(dev, k):
    """Each route's edges (narrow: 4/8/16/32 keys a thread; warp: 2..32 keys
    a lane; CTA: past 48 KB and at TESS_MAX_K), with rows that are not a
    multiple of a CTA's rows (128 narrow, 4 warp): bit for bit as the plain
    version, duplicates, thresholded zeros, -0.0 and an all-zero row
    included."""
    b = 2 if k == tp.TESS_MAX_K else (258 if k <= 32 else 7)
    r = np.random.default_rng(k)
    z = r.normal(size=(b, k)).astype(np.float32)
    z[0] = 0.0
    z[1] = np.round(z[1] * 2) / 2 * np.where(r.random(k) < 0.3, -0.0, 1.0)
    z[2:, k // 2:] *= np.abs(z[2:, k // 2:]) > 0.5
    zt = torch.from_numpy(z).to(dev)
    pat, a = tp.tess_project(zt)
    torch.cuda.synchronize()
    want_pat, want_a = tp.tess_project_plain(zt)
    assert torch.equal(pat, want_pat)
    assert torch.equal(a, want_a)


@pytest.mark.parametrize("k", [10, 33])
def test_tess_project_on_views_at_any_offset(dev, k):
    """Contiguous views that start one row or one float into an allocation
    (the narrow route stages from the 16-byte address below)."""
    base = torch.from_numpy(np.random.default_rng(k).normal(
        size=(1001 * k + 1,)).astype(np.float32)).to(dev)
    for z in (base[k:k + 1000 * k].view(1000, k),
              base[1:1 + 1000 * k].view(1000, k)):
        pat, a = tp.tess_project(z)
        torch.cuda.synchronize()
        want_pat, want_a = tp.tess_project_plain(z)
        assert torch.equal(pat, want_pat)
        assert torch.equal(a, want_a)


def test_tess_project_rejects_rows_past_shared_memory(dev):
    z = torch.zeros((2, tp.TESS_MAX_K + 1), device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        tp.tess_project(z)


@pytest.mark.parametrize("q,n,k", [(4, 64, 8), (128, 512, 16), (37, 1000, 10),
                                   (1, 2048, 64), (130, 513, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gam_score_kernel_equals_plain(dev, q, n, k, dtype):
    r = np.random.default_rng(q * n + k)
    u = torch.from_numpy(r.normal(size=(q, k)).astype(np.float32)).to(dev, dtype)
    v = torch.from_numpy(r.normal(size=(n, k)).astype(np.float32)).to(dev, dtype)
    mask = torch.from_numpy(r.random((q, n)) < 0.3).to(dev)
    got = gs.gam_score(u, v, mask)
    torch.cuda.synchronize()
    want = gs.gam_score_plain(u, v, mask)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("q,n,k", [(8, 32000, 512), (256, 100003, 10),
                                   (7, 1001, 10), (3, 4099, 33),
                                   (70, 1027, 32), (9, 515, 100)])
def test_gam_score_kernel_at_route_edges_equals_plain(dev, q, n, k):
    """The GAM head's and the oracle's shapes, N not a multiple of 4, both
    routes' edges (k 32 / 33), ragged query chunks: every output the plain
    version's but where its fma emulation double-rounds (at most one ulp,
    about one step in 2^29: counted, and at most one output in 2^20)."""
    r = np.random.default_rng(q * n + k)
    u = torch.from_numpy(r.normal(size=(q, k)).astype(np.float32)).to(dev)
    v = torch.from_numpy(r.normal(size=(n, k)).astype(np.float32)).to(dev)
    mask = torch.from_numpy(r.random((q, n)) < 0.3).to(dev)
    before = gs.gam_score.launches
    got = gs.gam_score(u, v, mask)
    torch.cuda.synchronize()
    assert gs.gam_score.launches == before + 1
    want = gs.gam_score_plain(u, v, mask)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    differ = got != want
    ulps = (got.view(torch.int32).long() - want.view(torch.int32).long()).abs()
    assert int(ulps.max()) <= 1
    assert int(differ.sum()) <= max(1, got.numel() >> 20), int(differ.sum())
    assert bool((got[~mask] == gs.NEG).all())


RETRIEVE_CASES = [
    (350, 16, 10, 2, 512, 128, 32),
    (300, 7, 5, 1, 4, 64, 8),
    (123, 3, 50, 3, 256, 32, 8),
    (513, 11, 17, 2, 8, 96, 8),
    (200, 9, 10, 0, 512, 64, 12),
    (5000, 300, 128, 1, 64, 256, 32),
]


def _catalog(dev, n, q, bucket, bn, quantize="none"):
    cfg = CFG
    items = torch.from_numpy(unit_factors(n, 16, n)).to(dev)
    users = torch.from_numpy(unit_factors(q, 16, n + 1)).to(dev)
    tau, vals = sparse_map(items, cfg)
    q_tau, q_vals = sparse_map(users, cfg)
    _, _, spill = build_segment(tau.cpu().numpy(), cfg.p, bucket,
                                (vals != 0).cpu().numpy())
    meta = gr.build_retrieval_meta(tau, vals != 0, cfg.p, spill_rows=spill,
                                   bn=bn, factors=items, quantize=quantize,
                                   device=dev)
    return items, users, q_tau, q_vals, meta


def _max_ulp(a: torch.Tensor, b: torch.Tensor) -> int:
    a = a.contiguous().view(torch.int32).long()
    b = b.contiguous().view(torch.int32).long()
    return int((a - b).abs().max()) if a.numel() else 0


@pytest.mark.parametrize("n,q,kappa,mo,bucket,bn,bq", RETRIEVE_CASES)
def test_gam_retrieve_kernel_equals_plain(dev, n, q, kappa, mo, bucket, bn, bq):
    items, users, q_tau, q_vals, meta = _catalog(dev, n, q, bucket, bn)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    alive[::7] = False
    for al in (None, alive):
        got = gr.gam_retrieve(users, items, q_tau, q_vals != 0, meta,
                              min(kappa, n), min_overlap=mo, bq=bq, alive=al)
        torch.cuda.synchronize()
        want = gr.gam_retrieve_plain(users, items, q_tau, q_vals != 0, meta,
                                     min(kappa, n), min_overlap=mo, bq=bq,
                                     alive=al)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("ranks,quantize", [(2, "none"), (4, "none"),
                                             (2, "int8")])
def test_gam_retrieve_over_a_ranks_rows_equals_plain(dev, ranks, quantize):
    """What each rank of an ``items`` mesh launches: the kernel over its
    own shards' rows (``slice_meta`` of the index, as the placement cuts
    it) against its plain version."""
    from repro_torch.service.sharded_index import ShardedGamIndex, slice_meta
    items = unit_factors(6000, 16, 3)
    users = torch.from_numpy(unit_factors(70, 16, 4)).to(dev)
    idx = ShardedGamIndex.build(items, CFG, n_shards=8, min_overlap=2,
                                bucket=512, quantize=quantize, device=dev)
    q_tau, q_vals = sparse_map(users, CFG)
    meta, factors = idx.metas[0], idx.factors_g[0]
    span = meta.n_rows // ranks
    for r in range(ranks):
        local = slice_meta(meta, r * span, span)
        rows = factors[r * span:(r + 1) * span].contiguous()
        alive = idx.alive_g[0][r * span:(r + 1) * span].contiguous()
        if quantize == "int8":
            args = (users, q_tau, q_vals != 0, local, 40)
            got = gr.gam_retrieve_q(*args, min_overlap=2, alive=alive)
            want = gr.gam_retrieve_q_plain(*args, min_overlap=2, alive=alive)
        else:
            args = (users, rows, q_tau, q_vals != 0, local, 10)
            got = gr.gam_retrieve(*args, min_overlap=2, alive=alive)
            want = gr.gam_retrieve_plain(*args, min_overlap=2, alive=alive)
        torch.cuda.synchronize()
        assert torch.equal(got.rows, want.rows), r
        assert torch.equal(got.blk_counts, want.blk_counts), r
        assert torch.equal(got.skipped, want.skipped), r
        assert _max_ulp(got.vals, want.vals) <= 4, r


# past the shared-memory fast path: kappa-lists and/or query rows in global
# memory (kappa > GAM_RETRIEVE_SMEM_KAPPA, k > GAM_RETRIEVE_SMEM_K)
WIDE_CASES = [
    # n, q, kappa, k, scheme, mo, bn, bq
    (5000, 37, 200, 16, "parse_tree", 1, 256, 32),
    (3000, 9, 512, 16, "parse_tree", 0, 128, 8),
    (300, 20, 10, 1536, "one_hot", 2, 64, 8),
    (700, 11, 200, 1536, "one_hot", 1, 128, 8),
]


def _wide_catalog(dev, n, q, k, scheme, bn, quantize="none"):
    cfg = GamConfig(k=k, scheme=scheme, threshold=0.5 / k ** 0.5)
    items = torch.from_numpy(unit_factors(n, k, n + k)).to(dev)
    users = torch.from_numpy(unit_factors(q, k, n + k + 1)).to(dev)
    tau, vals = sparse_map(items, cfg)
    q_tau, q_vals = sparse_map(users, cfg)
    _, _, spill = build_segment(tau.cpu().numpy(), cfg.p, 64,
                                (vals != 0).cpu().numpy())
    meta = gr.build_retrieval_meta(tau, vals != 0, cfg.p, spill_rows=spill,
                                   bn=bn, factors=items, quantize=quantize,
                                   device=dev)
    return items, users, q_tau, q_vals != 0, meta


@pytest.mark.parametrize("n,q,kappa,k,scheme,mo,bn,bq", WIDE_CASES)
def test_gam_retrieve_kernel_equals_plain_past_shared_memory(
        dev, n, q, kappa, k, scheme, mo, bn, bq):
    """Replaces the test that the kernel refused kappa > 128: any kappa and
    k now run, bit for bit as the plain version."""
    items, users, q_tau, q_mask, meta = _wide_catalog(dev, n, q, k, scheme,
                                                      bn)
    assert kappa > gr.GAM_RETRIEVE_SMEM_KAPPA or k > gr.GAM_RETRIEVE_SMEM_K
    got = gr.gam_retrieve(users, items, q_tau, q_mask, meta, kappa,
                          min_overlap=mo, bq=bq)
    torch.cuda.synchronize()
    want = gr.gam_retrieve_plain(users, items, q_tau, q_mask, meta, kappa,
                                 min_overlap=mo, bq=bq)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_gam_device_retriever_on_card_equals_cpu(dev):
    spec = RetrieverSpec(cfg=CFG, backend="gam-device", min_overlap=2)
    items, users = unit_factors(3000, 16, 3), unit_factors(70, 16, 4)
    before = gr.gam_retrieve.launches
    on_card = open_retriever(spec, items=items).query(users, explain=True)
    on_cpu = open_retriever(spec, items=items, device="cpu").query(
        users, explain=True)
    assert gr.gam_retrieve.launches == before + 1
    np.testing.assert_array_equal(on_card.ids, on_cpu.ids)
    np.testing.assert_array_equal(on_card.scores, on_cpu.scores)
    assert on_card.explain == on_cpu.explain


@pytest.mark.parametrize("n,q,pool,mo,bucket,bn,bq", RETRIEVE_CASES)
def test_gam_retrieve_q_kernel_equals_plain(dev, n, q, pool, mo, bucket, bn,
                                            bq):
    """Pool rows, counts and skip map exact; pool scores within 4 ulp."""
    _, users, q_tau, q_vals, meta = _catalog(dev, n, q, bucket, bn, "int8")
    pool = min(pool, meta.n_pad)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    alive[::7] = False
    for al in (None, alive):
        args = (users, q_tau, q_vals != 0, meta, pool)
        got = gr.gam_retrieve_q(*args, min_overlap=mo, bq=bq, alive=al)
        torch.cuda.synchronize()
        want = gr.gam_retrieve_q_plain(*args, min_overlap=mo, bq=bq, alive=al)
        for name in ("rows", "blk_counts", "skipped"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert _max_ulp(got.vals, want.vals) <= 4


def test_int8_slab_on_card_equals_cpu_slab(dev):
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(4096, 10)) * 3).astype(np.float32)
    x[512:1024] = 0.0                                   # an all-zero block
    cpu_q, cpu_s = quantize_int8(torch.from_numpy(x), block=256)
    card_q, card_s = quantize_int8(torch.from_numpy(x).to(dev), block=256)
    assert torch.equal(card_q.cpu(), cpu_q)
    assert torch.equal(card_s.cpu().view(torch.int32), cpu_s.view(torch.int32))
    meta_card = _catalog(dev, 3000, 4, 64, 256, "int8")[-1]
    meta_cpu = _catalog(torch.device("cpu"), 3000, 4, 64, 256, "int8")[-1]
    assert torch.equal(meta_card.factors_q.cpu(), meta_cpu.factors_q)
    assert torch.equal(meta_card.scales.cpu().view(torch.int32),
                       meta_cpu.scales.view(torch.int32))


@pytest.mark.parametrize("pool", [256, 512])
@pytest.mark.parametrize("n,q,_kappa,k,scheme,mo,bn,bq", WIDE_CASES)
def test_gam_retrieve_q_kernel_equals_plain_wide_pool(
        dev, pool, n, q, _kappa, k, scheme, mo, bn, bq):
    """Replaces the test that the int8 kernel refused a pool > 128: pools of
    256 and 512 (and k = 1536) equal the plain version (rows, counts and
    skip map exact, scores within 4 ulp)."""
    _, users, q_tau, q_mask, meta = _wide_catalog(dev, n, q, k, scheme, bn,
                                                  "int8")
    pool = min(pool, meta.n_pad)
    args = (users, q_tau, q_mask, meta, pool)
    got = gr.gam_retrieve_q(*args, min_overlap=mo, bq=bq)
    torch.cuda.synchronize()
    want = gr.gam_retrieve_q_plain(*args, min_overlap=mo, bq=bq)
    for name in ("rows", "blk_counts", "skipped"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert _max_ulp(got.vals, want.vals) <= 4


# the fast route's edges (csrc/gam_retrieve.cu, tile_kernel): queries that
# do not fill a 16-query tile, words across the 256-bit chunk of the 1-bit
# mma, min_overlap 0 with pad rows and items, n_rows cutting into a block,
# int8 blocks whose slab bytes bn * k are not a multiple of 16, spill rows
# (a 16-entry bucket)
EDGE_CASES = [
    # n, n_rows, q, k, scheme, kappa, pool, mo, bn, bq, words
    (700, None, 1, 10, "parse_tree", 10, 40, 2, 64, 32, 7),
    (700, None, 9, 11, "parse_tree", 10, 40, 1, 96, 8, 8),
    (900, None, 17, 16, "one_hot_dary8", 12, 24, 2, 128, 32, 9),
    (600, None, 255, 16, "parse_tree", 10, 40, 2, 64, 32, 17),
    (500, None, 33, 10, "parse_tree", 10, 40, 0, 96, 12, 7),
    (300, 333, 20, 9, "parse_tree", 8, 32, 0, 8, 8, 6),
    (400, None, 40, 10, "parse_tree", 10, 40, 2, 12, 16, 7),
    (500, None, 64, 11, "parse_tree", 10, 40, 1, 24, 8, 8),
]


def _edge_catalog(dev, n, n_rows, q, k, scheme, bn, words):
    d = 1                                   # "one_hot_dary8": D-ary, d 8
    if scheme.startswith("one_hot_dary"):
        scheme, d = "one_hot_dary", int(scheme[len("one_hot_dary"):])
    cfg = GamConfig(k=k, scheme=scheme, d=d, threshold=0.2)
    rows = n_rows or n
    items = torch.from_numpy(unit_factors(rows, k, rows + k)).to(dev)
    users = torch.from_numpy(unit_factors(q, k, rows + k + 1)).to(dev)
    tau, vals = sparse_map(items[:n], cfg)
    q_tau, q_vals = sparse_map(users, cfg)
    _, _, spill = build_segment(tau.cpu().numpy(), cfg.p, 16,
                                (vals != 0).cpu().numpy())
    meta = gr.build_retrieval_meta(tau, vals != 0, cfg.p, n_rows=rows,
                                   spill_rows=spill, bn=bn, factors=items,
                                   quantize="int8", device=dev)
    assert meta.words == words
    return items, users, q_tau, q_vals != 0, meta


def _both_entries_equal_plain(dev, items, users, q_tau, q_mask, meta, kappa,
                              pool, **kw):
    """Both entries on the fast route, each equal to its plain version
    (f32: every field bit for bit; int8: rows, counts and skip map exact,
    scores within 4 ulp), with and without an alive mask."""
    q, k = users.shape
    for width, i8 in ((kappa, False), (pool, True)):
        plan = gr.retrieve_plan(q, k, meta.words, width, meta.n_blocks, i8,
                                dev)
        assert plan["route"] == "fast", plan
    alive = torch.ones(meta.n_rows, dtype=torch.bool, device=dev)
    alive[::7] = False
    for al in (None, alive):
        args = (users, items, q_tau, q_mask, meta, kappa)
        got = gr.gam_retrieve(*args, alive=al, **kw)
        torch.cuda.synchronize()
        want = gr.gam_retrieve_plain(*args, alive=al, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        qargs = (users, q_tau, q_mask, meta, pool)
        got = gr.gam_retrieve_q(*qargs, alive=al, **kw)
        torch.cuda.synchronize()
        want = gr.gam_retrieve_q_plain(*qargs, alive=al, **kw)
        for name in ("rows", "blk_counts", "skipped"):
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert _max_ulp(got.vals, want.vals) <= 4


@pytest.mark.parametrize("n,n_rows,q,k,scheme,kappa,pool,mo,bn,bq,words",
                         EDGE_CASES)
def test_gam_retrieve_fast_route_edges_equal_plain(
        dev, n, n_rows, q, k, scheme, kappa, pool, mo, bn, bq, words):
    items, users, q_tau, q_mask, meta = _edge_catalog(dev, n, n_rows, q, k,
                                                      scheme, bn, words)
    _both_entries_equal_plain(dev, items, users, q_tau, q_mask, meta, kappa,
                              pool, min_overlap=mo, bq=bq)


def test_gam_retrieve_fast_route_ties_break_by_lowest_row(dev):
    """Forty copies of eight rows: equal scores by row ascending, across
    tiles, splits and the merge (the reference's
    test_score_ties_break_by_lowest_row, on the card)."""
    base = unit_factors(8, 16, 0)
    items = torch.from_numpy(np.concatenate([base] * 40)).to(dev)
    users = torch.from_numpy(base[:4]).to(dev)
    tau, vals = sparse_map(items, CFG)
    q_tau, q_vals = sparse_map(users, CFG)
    meta = gr.build_retrieval_meta(tau, vals != 0, CFG.p, bn=16,
                                   factors=items, quantize="int8", device=dev)
    _both_entries_equal_plain(dev, items, users, q_tau, q_vals != 0, meta,
                              12, 24, min_overlap=1, bq=8)
    got = gr.gam_retrieve(users, items, q_tau, q_vals != 0, meta, 12,
                          min_overlap=1, bq=8)
    rows, s = got.rows.cpu().numpy(), got.vals.cpu().numpy()
    ties = s[:, :-1] == s[:, 1:]
    assert ties.any()
    assert (rows[:, :-1][ties] < rows[:, 1:][ties]).all()


def test_gam_retrieve_fast_route_block_skipped_by_one_bq_tile(dev):
    """A clustered catalog, bq 8 and 32 queries (one 32-query CTA over four
    bq-tiles): blocks that some of the CTA's bq-tiles skip and others keep
    are computed, and every output still equals the plain version."""
    rng = np.random.default_rng(2)
    centers = unit_factors(8, 16, 7)
    items = np.repeat(centers, 64, axis=0) + \
        0.04 * rng.normal(size=(512, 16)).astype(np.float32)
    items /= np.linalg.norm(items, axis=1, keepdims=True)
    users = centers[np.repeat(np.arange(4), 8)] + \
        0.04 * rng.normal(size=(32, 16)).astype(np.float32)
    users /= np.linalg.norm(users, axis=1, keepdims=True)
    items = torch.from_numpy(items).to(dev)
    users = torch.from_numpy(users.astype(np.float32)).to(dev)
    tau, vals = sparse_map(items, CFG)
    q_tau, q_vals = sparse_map(users, CFG)
    meta = gr.build_retrieval_meta(tau, vals != 0, CFG.p, bn=64,
                                   factors=items, quantize="int8", device=dev)
    sk = gr.gam_retrieve(users, items, q_tau, q_vals != 0, meta, 10,
                         min_overlap=4, bq=8).skipped.cpu().numpy()
    assert (sk.any(axis=0) & ~sk.all(axis=0)).any()
    _both_entries_equal_plain(dev, items, users, q_tau, q_vals != 0, meta,
                              10, 40, min_overlap=4, bq=8)


def test_int8_gam_device_retriever_on_card_equals_cpu(dev):
    spec = RetrieverSpec(cfg=CFG, backend="gam-device", min_overlap=2,
                         quantize="int8", compress_postings=True,
                         rerank_factor=4)
    items, users = unit_factors(3000, 16, 3), unit_factors(70, 16, 4)
    before_q, before_f32 = gr.gam_retrieve_q.launches, gr.gam_retrieve.launches
    on_card = open_retriever(spec, items=items).query(users, explain=True)
    on_cpu = open_retriever(spec, items=items, device="cpu").query(
        users, explain=True)
    assert gr.gam_retrieve_q.launches == before_q + 1
    assert gr.gam_retrieve.launches == before_f32
    np.testing.assert_array_equal(on_card.ids, on_cpu.ids)
    np.testing.assert_array_equal(on_card.scores, on_cpu.scores)
    assert on_card.explain == on_cpu.explain


# ------------------------------------------------------- decode_attention

DECODE_SHAPES = [
    # b, hkv, g, hd, s: the reference suite's shapes, the slice's serving
    # shape (tinyllama-1.1b, batch 8, capacity 1064), the decode_32k widths
    # at a smaller batch, an odd head dim (scalar loads) and wide groups
    (1, 1, 1, 32, 64), (2, 2, 4, 64, 128), (3, 1, 8, 64, 100),
    (2, 4, 2, 128, 257), (1, 2, 16, 64, 1024), (8, 4, 8, 64, 1064),
    (4, 4, 8, 64, 32768), (2, 3, 6, 100, 333), (2, 1, 16, 256, 520),
    (1, 1, 48, 256, 130), (2, 2, 3, 8, 7),
    # the other families' serving layouts (batch 8): olmoe-1b-7b (hd 128,
    # G 1, capacity 1,064), whisper-tiny's decoder (hd 64, G 1, capacity
    # 44) and internvl2-26b (hd 128, G 6, 256 image tokens + 808)
    (8, 16, 1, 128, 1064), (8, 6, 1, 64, 44), (8, 8, 6, 128, 1064),
]


def _decode_inputs(dev, b, hkv, g, hd, s, dtype, seed):
    r = np.random.default_rng(seed)
    mk = (lambda *shape: torch.from_numpy(r.normal(size=shape).astype(
        np.float32)).to(dev, dtype))
    return mk(b, hkv, g, hd), mk(b, s, hkv, hd), mk(b, s, hkv, hd)


@pytest.mark.parametrize("b,hkv,g,hd,s", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_equals_plain(dev, b, hkv, g, hd, s, dtype):
    """f32 within 1e-5 (the kernel's split softmax sums in another order
    than the plain version).  bf16 within one bf16 step: both sides compute
    in f32 on the same bf16 inputs and round once, so rtol 2^-7 of the value
    over an atol of 1e-5."""
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    q, k, v = _decode_inputs(dev, b, hkv, g, hd, s, dtype, b * s + hd)
    rtol, atol = (1e-5, 1e-5) if dtype == torch.float32 else (2.0 ** -7, 1e-5)
    for length in (s - 1, s // 2, 0):
        n_len = torch.tensor(length, dtype=torch.int32, device=dev)
        before = da.decode_attention.launches
        got = da.decode_attention(q, k, v, n_len)
        torch.cuda.synchronize()
        assert da.decode_attention.launches == before + 1
        want = da.decode_attention_plain(q, k, v, n_len)
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)


@pytest.mark.parametrize("b,hkv,g,hd,s", [(8, 4, 8, 64, 1064),
                                           (2, 1, 48, 128, 700),
                                           (1, 2, 3, 48, 300)])
def test_decode_attention_bf16_length_in_last_splits_first_tile(dev, b, hkv,
                                                                 g, hd, s):
    """``length`` ends at the first position, and inside the first tile, of
    the last split (that split walks one partial tile), and at the second
    position of the one before it (the last split then walks none).  One
    bf16 step, as above."""
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    _, _, _, tile, chunk, n_split = da.decode_splits(b, hkv, g, hd, s, sms, 2)
    assert n_split > 2
    q, k, v = _decode_inputs(dev, b, hkv, g, hd, s, torch.bfloat16, s + g)
    last = (n_split - 1) * chunk
    for length in (last, min(last + tile // 2, s - 1), last - chunk + 1):
        got = da.decode_attention(q, k, v, length)
        want = da.decode_attention_plain(q, k, v, length)
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -7,
                                   atol=1e-5)


def test_bf16_attention_kernels_are_bit_identical_across_runs(dev):
    """No atomics: the same inputs give the same bits, run after run."""
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    from repro_torch.kernels import flash_prefill as fp
    q, k, v = _decode_inputs(dev, 8, 4, 8, 64, 1064, torch.bfloat16, 5)
    runs = [da.decode_attention(q, k, v, 1054) for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    g = torch.Generator(dev).manual_seed(5)
    q, k, v = (torch.randn(sh, device=dev, generator=g).to(torch.bfloat16)
               for sh in ((2, 300, 2, 8, 64), (2, 300, 2, 64),
                          (2, 300, 2, 64)))
    runs = [fp.flash_prefill(q, k, v) for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])


def test_decode_attention_kernel_ignores_positions_past_length(dev):
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    q, k, v = _decode_inputs(dev, 2, 2, 4, 64, 600, torch.bfloat16, 3)
    out1 = da.decode_attention(q, k, v, 300)
    k[:, 301:] = 99.0
    v[:, 301:] = -99.0
    out2 = da.decode_attention(q, k, v, 300)
    assert torch.equal(out1, out2)


def test_decode_kernel_model_path_equals_einsum_path(dev):
    """Reduced tinyllama widened to G = 8 on the card: the decode steps
    through the kernel equal the reference's einsum path within 1e-4 (f32),
    and the kernel launches once per layer and step."""
    from repro_torch.configs import get_reduced_config
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    from repro_torch.models import Model
    cfg = get_reduced_config("tinyllama-1.1b").with_(n_heads=8, n_kv_heads=1,
                                                     vocab=300)
    plain, kern = Model(cfg), Model(cfg.with_(use_decode_kernel=True))
    params = plain.init(0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 300, (4, 20))).to(dev)
    _, cp = plain.prefill(params, {"tokens": tokens}, 40)
    _, ck = kern.prefill(params, {"tokens": tokens}, 40)
    tok = tokens[:, :1]
    before = da.decode_attention.launches
    for _ in range(5):
        lp, cp = plain.decode_step(params, cp, tok)
        lk, ck = kern.decode_step(params, ck, tok)
        torch.testing.assert_close(lk, lp, rtol=1e-4, atol=1e-4)
        tok = lp[:, 0].argmax(-1, keepdim=True)
    assert da.decode_attention.launches == before + 5 * cfg.n_layers


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "whisper-tiny",
                                  "internvl2-26b"])
def test_decode_kernel_family_path_equals_einsum_path(dev, arch):
    """The reduced MoE, encoder-decoder and VLM models on the card: the
    decode steps through the kernel equal the einsum path within 1e-4 (f32;
    the reduced MoE config is dropless), one launch per layer and step."""
    from repro_torch.configs import get_reduced_config
    da = importlib.import_module("repro_torch.kernels.decode_attention")
    from repro_torch.models import Model
    cfg = get_reduced_config(arch).with_(vocab=300)
    plain, kern = Model(cfg), Model(cfg.with_(use_decode_kernel=True))
    params = plain.init(0)
    r = np.random.default_rng(1)
    batch = {"tokens": torch.from_numpy(r.integers(0, 300, (4, 12))).to(dev)}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(r.normal(
            size=(4, 48, cfg.d_frontend)).astype(np.float32)).to(dev)
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.from_numpy(r.normal(
            size=(4, cfg.n_image_tokens, cfg.d_frontend)).astype(
                np.float32)).to(dev)
    capacity = 24 + plain.n_prefix()
    _, cp = plain.prefill(params, batch, capacity)
    _, ck = kern.prefill(params, batch, capacity)
    tok = batch["tokens"][:, :1]
    before = da.decode_attention.launches
    for _ in range(5):
        lp, cp = plain.decode_step(params, cp, tok)
        lk, ck = kern.decode_step(params, ck, tok)
        torch.testing.assert_close(lk, lp, rtol=1e-4, atol=1e-4)
        tok = lp[:, 0].argmax(-1, keepdim=True)
    assert da.decode_attention.launches == before + 5 * cfg.n_layers


# ------------------------------------------------------------ flash_prefill

PREFILL_SHAPES = [(1, 64, 1, 1, 32), (2, 128, 2, 4, 64), (1, 96, 1, 8, 64),
                  (2, 256, 4, 2, 32), (1, 100, 2, 3, 48), (1, 77, 1, 8, 128),
                  (8, 1024, 4, 8, 64),
                  # S < 16, S not a multiple of 64, odd G and hd, G past 16
                  (2, 9, 2, 8, 64), (1, 13, 1, 3, 48), (1, 200, 2, 6, 100),
                  (1, 130, 1, 128, 8), (2, 70, 1, 1, 64)]


@pytest.mark.parametrize("b,s,hkv,g,hd", PREFILL_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_prefill_kernel_equals_plain(dev, b, s, hkv, g, hd, dtype):
    """f32 within 2e-5, the reference's tolerance (the kernel's online
    softmax sums in another order than the plain version).  bf16 within one
    bf16 step: both sides compute in f32 on the same bf16 inputs and round
    once, so rtol 2^-7 of the value over an atol of 1e-5.  The last shape is
    tinyllama's prefill."""
    from repro_torch.kernels import flash_prefill as fp
    r = np.random.default_rng(b * s + hd + g)
    mk = (lambda *shape: torch.from_numpy(r.normal(size=shape).astype(
        np.float32)).to(dev, dtype))
    q, k, v = mk(b, s, hkv, g, hd), mk(b, s, hkv, hd), mk(b, s, hkv, hd)
    before = fp.flash_prefill.launches
    got = fp.flash_prefill(q, k, v)
    torch.cuda.synchronize()
    assert fp.flash_prefill.launches == before + 1
    want = fp.flash_prefill_plain(q, k, v)
    assert got.dtype == dtype and got.shape == q.shape
    rtol, atol = (2e-5, 2e-5) if dtype == torch.float32 else (2.0 ** -7, 1e-5)
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def test_flash_prefill_kernel_is_causal(dev):
    from repro_torch.kernels import flash_prefill as fp
    g = torch.Generator(dev).manual_seed(11)
    q = torch.randn((1, 200, 2, 4, 64), device=dev, generator=g)
    k = torch.randn((1, 200, 2, 64), device=dev, generator=g)
    v = torch.randn((1, 200, 2, 64), device=dev, generator=g)
    out1 = fp.flash_prefill(q, k, v)
    k[:, 130:] = 77.0
    v[:, 130:] = -77.0
    out2 = fp.flash_prefill(q, k, v)
    assert torch.equal(out1[:, :130], out2[:, :130])


# ------------------------------------------------------------ gam_coarse


def _coarse_inputs(dev, b, d, v, lo, hi, seed=None):
    r = np.random.default_rng(b * d + v if seed is None else seed)
    h = torch.from_numpy(r.normal(size=(b, d)).astype(np.float32)).to(dev)
    pat = torch.from_numpy(r.integers(lo, hi, size=(d, v)).astype(
        np.int8)).to(dev)
    inv = torch.from_numpy(r.random(v).astype(np.float32)).to(dev)
    return h, pat, inv


def _coarse_within_bound(gc, h, pat, inv, got):
    want = gc.gam_coarse_plain(h, pat, inv)
    return bool(((got - want).abs() <= gc.coarse_tolerance(h, pat,
                                                            inv)).all())


@pytest.mark.parametrize("b,d,v,lo,hi", [
    (1, 64, 500, -1, 2), (4, 128, 4096, -1, 2), (8, 32, 100, -1, 2),
    (2, 256, 2049, -1, 2), (3, 100, 33, -128, 128), (13, 300, 1001, -1, 2),
    (8, 2048, 32000, -1, 2), (8, 512, 32000, -1, 2),
    (1, 2048, 32000, -1, 2), (16, 2048, 32000, -1, 2),
    (64, 2048, 32000, -1, 2), (256, 2048, 32000, -1, 2),
    (64, 1000, 4000, -128, 128), (256, 77, 1041, -128, 128),
    (300, 33, 160, -1, 2), (5, 1, 17, -128, 128), (7, 2047, 32001, -1, 2),
    (32, 2048, 32000, -1, 2), (24, 300, 1001, -128, 128),
    (100, 2048, 32000, -1, 2), (128, 77, 1041, -128, 128)])
def test_gam_coarse_kernel_equals_plain(dev, b, d, v, lo, hi):
    """Within the rounding bound of two d-term f32 sums in other orders
    (``coarse_tolerance``); at tinyllama's head width (d 2048, V 32,000)
    for B 1, 8, 16, 32, 64, 100 and 256, at the GAM head's d 512, at d not
    a multiple of 16, V = 1 mod 16, and B past one pass (300): every config
    of the plan (B <= 8, 16, 32, 64, 128, 256) on both staging routes."""
    from repro_torch.kernels import gam_coarse as gc
    h, pat, inv = _coarse_inputs(dev, b, d, v, lo, hi)
    before = gc.gam_coarse.launches
    got = gc.gam_coarse(h, pat, inv)
    torch.cuda.synchronize()
    assert gc.gam_coarse.launches == before + 1
    assert tuple(got.shape) == (b, v) and bool(torch.isfinite(got).all())
    assert _coarse_within_bound(gc, h, pat, inv, got)


@pytest.mark.parametrize("offset", [1, 3, 8, 16])
@pytest.mark.parametrize("v", [4096, 1001])
def test_gam_coarse_kernel_on_a_pattern_view_at_any_offset(dev, offset, v):
    """A contiguous view whose pointer lies ``offset`` bytes into a larger
    buffer: the plan's byte-load route unless the view is 16-byte aligned
    and V % 16 == 0."""
    from repro_torch.kernels import gam_coarse as gc
    b, d = 8, 200
    h, pat, inv = _coarse_inputs(dev, b, d, v, -128, 128)
    buf = torch.zeros(d * v + 64, dtype=torch.int8, device=dev)
    view = buf[offset:offset + d * v].view(d, v)
    view.copy_(pat)
    plan = gc.coarse_plan(b, d, v, view.data_ptr() % 16)
    assert plan.vec == (v % 16 == 0 and view.data_ptr() % 16 == 0)
    got = gc.gam_coarse(h, view, inv)
    torch.cuda.synchronize()
    assert torch.equal(got, gc.gam_coarse(h, pat, inv))
    assert _coarse_within_bound(gc, h, pat, inv, got)


@pytest.mark.parametrize("offset", [1, 2, 4])
@pytest.mark.parametrize("b,v", [(8, 4096), (64, 4096), (8, 1001)])
def test_gam_coarse_kernel_on_an_inv_view_at_any_offset(dev, offset, b, v):
    """inv_sqrt_nnz as a contiguous view ``offset`` floats into a larger
    buffer (4, 8 or 16 bytes past 16-byte alignment), on the TMA route
    (V % 16 == 0) and the byte-load route: the same answer as from an
    aligned copy."""
    from repro_torch.kernels import gam_coarse as gc
    h, pat, inv = _coarse_inputs(dev, b, 200, v, -128, 128)
    buf = torch.zeros(v + 8, dtype=torch.float32, device=dev)
    view = buf[offset:offset + v]
    view.copy_(inv)
    got = gc.gam_coarse(h, pat, view)
    torch.cuda.synchronize()
    assert torch.equal(got, gc.gam_coarse(h, pat, inv))
    assert _coarse_within_bound(gc, h, pat, inv, got)


@pytest.mark.parametrize("b,d,v", [(1, 2048, 4096), (8, 2048, 4096),
                                   (16, 512, 1001), (24, 2048, 4096),
                                   (64, 2048, 4096), (100, 512, 1001),
                                   (256, 2048, 4096)])
def test_gam_coarse_kernel_keeps_the_third_term_of_h(dev, b, d, v):
    """On inputs whose answer lies in h's third bf16 term
    (``third_term_probe``), the kernel is within an eighth of the error a
    product of two terms would make, against the product in f64: each
    config of the plan, on both staging routes."""
    from repro_torch.kernels import gam_coarse as gc
    h, pat, inv = gc.third_term_probe(b, d, v, seed=b + d, device=dev)
    got = gc.gam_coarse(h, pat, inv)
    torch.cuda.synchronize()
    err3, err2 = gc.third_term_errors(got, h, pat, inv)
    assert err3 <= err2 / 8, (err3, err2)
    assert _coarse_within_bound(gc, h, pat, inv, got)


@pytest.mark.parametrize("b,d,v", [(8, 2048, 32000), (64, 512, 4096),
                                   (3, 333, 1001)])
def test_gam_coarse_kernel_on_h_from_2_to_minus_60_to_2_to_60(dev, b, d, v):
    """h with magnitudes from 2^-60 to 2^60 in every row, each value
    followed by its negation, against int8 over its whole range."""
    from repro_torch.kernels import gam_coarse as gc
    r = np.random.default_rng(d)
    half = (2.0 ** r.integers(-60, 61, size=(b, -(-d // 2)))
            * r.uniform(1, 2, (b, -(-d // 2)))).astype(np.float32)
    h = np.empty((b, d), np.float32)
    h[:, 0::2] = half
    h[:, 1::2] = -half[:, :d // 2]
    h = torch.from_numpy(h).to(dev)
    pat = torch.from_numpy(r.integers(-128, 128, size=(d, v)).astype(
        np.int8)).to(dev)
    inv = torch.from_numpy(r.uniform(0.01, 1.0, v).astype(np.float32)).to(dev)
    got = gc.gam_coarse(h, pat, inv)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _coarse_within_bound(gc, h, pat, inv, got)


def test_gam_coarse_kernel_reruns_are_bit_identical(dev):
    """One accumulator an output summed in a fixed order, no atomics."""
    from repro_torch.kernels import gam_coarse as gc
    for b, d, v in ((8, 2048, 32000), (64, 2048, 32000), (256, 300, 5000),
                    (5, 100, 1001), (100, 2048, 32000)):
        h, pat, inv = _coarse_inputs(dev, b, d, v, -128, 128)
        first = gc.gam_coarse(h, pat, inv)
        for _ in range(3):
            assert torch.equal(gc.gam_coarse(h, pat, inv), first)


# ------------------------------------------------------------ sharded tier


@pytest.mark.parametrize("quantize", ["none", "int8"])
def test_sharded_retriever_on_card_equals_cpu(dev, quantize, tmp_path):
    """The service tier on the card answers like the same backend on the
    CPU, bit for bit: build, mutations, a background compaction, a
    repartition to narrow blocks (bn 8 and 16) and a snapshot round trip;
    ``gam_retrieve`` launches once per bn-group and once for the delta."""
    gr = importlib.import_module("repro_torch.kernels.gam_retrieve")
    items = unit_factors(700, 16, 5)
    users = unit_factors(24, 16, 6)
    spec = RetrieverSpec(cfg=CFG, backend="sharded", n_shards=4,
                         min_overlap=2, bucket=512, quantize=quantize,
                         rerank_factor=2,
                         options=(("compact_slice_rows", 128),
                                  ("rebalance_target_blocks", 16)))
    rs = {d: open_retriever(spec, items=items, device=d)
          for d in ("cpu", "cuda")}

    def same(tag, **kw):
        a = rs["cpu"].query(users, **kw)
        b = rs["cuda"].query(users, **kw)
        np.testing.assert_array_equal(a.ids, b.ids, err_msg=tag)
        np.testing.assert_array_equal(a.scores, b.scores, err_msg=tag)
        np.testing.assert_array_equal(a.n_scored, b.n_scored, err_msg=tag)

    same("build")
    same("build exact", exact=True)
    for r in rs.values():
        r.upsert(np.arange(690, 720), unit_factors(30, 16, 7))
        r.delete(np.arange(0, 700, 11))
    kernel = gr.gam_retrieve_q if quantize == "int8" else gr.gam_retrieve
    before = kernel.launches
    same("mutations")
    assert kernel.launches == before + 2       # one group + the delta
    for r in rs.values():
        r.compact(async_=True)
    while rs["cuda"].maintenance_stats()["compaction"]["active"]:
        same("mid-compaction")
    for lengths, bns in (((100, 200, 150, 200), (8, 16, 16, 64)),
                         ((300, 100, 100, 150), (16, 8, 8, 16))):
        for r in rs.values():
            ids, fac = r._catalog_arrays()
            part = type(r.base.partition).from_lengths(
                (lengths[0], lengths[1], lengths[2],
                 ids.size - sum(lengths[:3])), bns)
            r.compact(partition=part)
            r.upsert([5000], unit_factors(1, 16, 8))
        n_groups = len(rs["cuda"].base.metas)
        before = kernel.launches
        same(f"partition {bns}")
        assert kernel.launches == before + n_groups + 1
    # the repartitioner's own plan: 16 blocks a shard gives bn 8-16 here
    parts = [r.repartition(async_=False) for r in rs.values()]
    assert parts[0] == parts[1] and max(parts[1].bns) <= 16
    same("repartitioned")
    path = str(tmp_path / "sharded.npz")
    rs["cuda"].snapshot(path)
    back = open_retriever(spec, snapshot=path, device="cuda")
    a, b = back.query(users), rs["cpu"].query(users)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)


# ------------------------------------------- the CSR index and the baselines


@pytest.mark.parametrize("compress", [False, True])
def test_gam_retriever_on_card_equals_cpu(dev, compress, tmp_path):
    """``gam`` on the card (map through ``tess_project``, posting walk and
    scoring on the device) answers like ``device="cpu"``, bit for bit, and
    its snapshot restores on the CPU."""
    spec = RetrieverSpec(cfg=CFG, backend="gam", min_overlap=2,
                         compress_postings=compress)
    items, users = unit_factors(3000, 16, 3), unit_factors(70, 16, 4)
    before = tp.tess_project.launches
    on_card = open_retriever(spec, items=items)
    on_cpu = open_retriever(spec, items=items, device="cpu")
    for exact in (True, False):
        a = on_card.query(users, explain=True, exact=exact)
        b = on_cpu.query(users, explain=True, exact=exact)
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)
        np.testing.assert_array_equal(a.n_scored, b.n_scored)
        assert a.explain == b.explain
    assert tp.tess_project.launches >= before + 2      # build + queries
    assert on_card.index.device.type == "cuda"
    assert on_card.stats() == on_cpu.stats()
    path = str(tmp_path / "gam.npz")
    on_card.snapshot(path)
    back = open_retriever(spec, snapshot=path, device="cpu").query(users)
    np.testing.assert_array_equal(back.ids, b.ids)      # b: pruned
    np.testing.assert_array_equal(back.scores, b.scores)


def test_inverted_index_on_card_equals_cpu(dev):
    from repro_torch.core.inverted_index import InvertedIndex
    tau, vals = sparse_map(torch.from_numpy(unit_factors(4000, 16, 9)).to(dev),
                           CFG)
    q_tau, q_vals = sparse_map(
        torch.from_numpy(unit_factors(50, 16, 10)).to(dev), CFG)
    card = InvertedIndex(tau, CFG.p, vals != 0, device=dev)
    cpu = InvertedIndex(tau.cpu(), CFG.p, (vals != 0).cpu(), device="cpu")
    assert torch.equal(card.postings.cpu(), cpu.postings)
    assert torch.equal(card.offsets.cpu(), cpu.offsets)
    ccard, ccpu = card.compress(), cpu.compress()
    np.testing.assert_array_equal(ccard.slot_patterns.data,
                                  ccpu.slot_patterns.data)
    np.testing.assert_array_equal(ccard.pattern_items.data,
                                  ccpu.pattern_items.data)
    for mo in (1, 2, 3):
        want = cpu.candidates(q_tau.cpu(), mo, (q_vals != 0).cpu())
        for idx in (card, ccard):
            got = idx.candidates(q_tau, mo, q_vals != 0)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)
    flat = ccard.decompress()
    assert torch.equal(flat.postings, card.postings)


BASELINE_CASES = [("SrpLsh", dict(n_bits=8, n_tables=4)),
                  ("SuperBitLsh", dict(n_bits=8, n_tables=4)),
                  ("CroHash", dict(n_proj=32, top_l=2, n_tables=4))]


@pytest.mark.parametrize("kind,kwargs", BASELINE_CASES,
                         ids=[c for c, _ in BASELINE_CASES])
def test_baseline_hashing_on_card_equals_cpu(dev, kind, kwargs):
    """The hash codes, tables, candidates and answers on the card are the
    CPU's bit for bit (both project with the same f32 fma arithmetic)."""
    from repro_torch.core import baselines as tb
    items, users = unit_factors(5000, 16, 11), unit_factors(64, 16, 12)
    card = getattr(tb, kind)(items, **kwargs, device=dev)
    cpu = getattr(tb, kind)(items, **kwargs, device="cpu")
    assert torch.equal(card.table_codes.cpu(), cpu.table_codes)
    assert torch.equal(card.table_items.cpu(), cpu.table_items)
    for g, w in zip(card.candidates(users), cpu.candidates(users)):
        assert torch.equal(g.cpu(), w)
    a, b = card.query(users, 10), cpu.query(users, 10)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)
    np.testing.assert_array_equal(a.n_scored, b.n_scored)


def test_pca_tree_on_card_equals_cpu_but_near_medians(dev):
    """The tree built on the card descends like the CPU's: the power
    iteration's matmuls may round apart, so a query may take another leaf
    only where its projection lies within 1e-5 of a median."""
    from repro_torch.core import baselines as tb
    items, users = unit_factors(8192, 16, 13), unit_factors(64, 16, 14)
    card = tb.PcaTree(items, depth=9, device=dev)
    cpu = tb.PcaTree(items, depth=9, device="cpu")
    assert card.levels == cpu.levels
    torch.testing.assert_close(card.split_v.abs().cpu(), cpu.split_v.abs(),
                               rtol=0, atol=1e-4)
    leaf_a, leaf_b = card.leaf_of(users).cpu(), cpu.leaf_of(users)
    u = torch.from_numpy(users)
    node = torch.zeros(64, dtype=torch.int64)
    near = torch.zeros(64, dtype=torch.bool)
    for _ in range(cpu.levels):         # the CPU tree's path of each query
        split = cpu.child[node, 0] >= 0
        gap = (u * cpu.split_v[node]).sum(1) - cpu.split_med[node]
        near |= split & (gap.abs() <= 1e-5)
        go = (gap > 0).to(torch.int64)
        node = torch.where(split, cpu.child[node].gather(1, go[:, None])[:, 0],
                           node)
    assert ((leaf_a == leaf_b) | near).all()
    # where both trees give a query the same candidates, the same answer
    a, b = card.query(users, 10), cpu.query(users, 10)
    (qa, ra), (qb, rb) = card.candidates(users), cpu.candidates(users)
    qa, ra = qa.cpu(), ra.cpu()
    for qi in range(64):
        if torch.equal(ra[qa == qi], rb[qb == qi]):
            np.testing.assert_array_equal(a.ids[qi], b.ids[qi])
            np.testing.assert_array_equal(a.scores[qi], b.scores[qi])


# --------------------------------------------- the learning loop on the card

# trained factors on the card against the CPU's: the per-row sums run in
# the same order on both (``scatter_rows``), the dot products and the
# batch means reduce in another, so within these
MF_FACTOR_TOL = dict(rtol=0, atol=1e-5)
STREAM_TOL = dict(rtol=1e-5, atol=1e-6)


def test_scatter_rows_on_card_equals_cpu_bit_for_bit(dev):
    from repro_torch.factorization.mf import scatter_rows
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 943, 8192)
    g = rng.normal(size=(8192, 10)).astype(np.float32)
    card = scatter_rows(943, torch.as_tensor(rows, device=dev),
                        torch.as_tensor(g, device=dev))
    cpu = scatter_rows(943, torch.as_tensor(rows), torch.as_tensor(g))
    assert torch.equal(card.cpu(), cpu)


def test_train_mf_on_card_twice_gives_the_same_bits(dev):
    from repro_torch.data import movielens_like_ratings
    from repro_torch.factorization import MfConfig, train_mf
    rows, cols, vals = movielens_like_ratings(seed=0)
    cfg = MfConfig(k=10, epochs=3)
    u0, v0, h0 = train_mf(rows, cols, vals, 943, 1682, cfg, device=dev)
    u1, v1, h1 = train_mf(rows, cols, vals, 943, 1682, cfg, device=dev)
    np.testing.assert_array_equal(u0, u1)
    np.testing.assert_array_equal(v0, v1)
    assert h0 == h1
    uc, vc, hc = train_mf(rows, cols, vals, 943, 1682, cfg, device="cpu")
    np.testing.assert_allclose(u0, uc, **MF_FACTOR_TOL)
    np.testing.assert_allclose(v0, vc, **MF_FACTOR_TOL)
    np.testing.assert_allclose(h0, hc, rtol=1e-6)


@pytest.mark.parametrize("cfg", [dict(), dict(update_users=False,
                                               clip_norm=0.5, batch=100)])
def test_streaming_mf_on_card_within_tolerance_of_cpu(dev, cfg):
    from repro_torch.online import DriftSimulator, OnlineMFConfig, StreamingMF
    sims = [DriftSimulator(n_users=8, n_items=300, k=16, seed=13, drift=0.25,
                           events_per_round=512) for _ in range(2)]
    cfg = OnlineMFConfig(k=16, lr=0.5, momentum=0.6, seed=3, **cfg)
    card, cpu = StreamingMF(cfg, device=dev), StreamingMF(cfg, device="cpu")
    for t, sim in zip((card, cpu), sims):
        t.warm_start(u=sim.users, v=sim.items_at_start)
    for _ in range(4):
        a, b = card.partial_fit(sims[0].step()), cpu.partial_fit(sims[1].step())
        np.testing.assert_allclose(a["mse"], b["mse"], rtol=1e-5)
        np.testing.assert_allclose(card.item_factors(), cpu.item_factors(),
                                   **STREAM_TOL)
        np.testing.assert_allclose(card.user_factors(), cpu.user_factors(),
                                   **STREAM_TOL)
        np.testing.assert_allclose(card._gsq["v"].cpu().numpy(),
                                   cpu._gsq["v"].numpy(), **STREAM_TOL)
    assert card.stats()["n_grows"] == cpu.stats()["n_grows"]


def test_mf_state_round_trip_through_converters_on_card(dev):
    from repro_torch.data import movielens_like_ratings
    from repro_torch.factorization import MfConfig, train_mf
    from repro_torch.factorization.convert import (
        mf_state_from_reference, mf_state_to_reference)
    from repro_torch.online import OnlineMFConfig, StreamingMF
    rows, cols, vals = movielens_like_ratings(seed=2, n_users=100,
                                              n_items=150)
    u, v, _, state = train_mf(rows, cols, vals, 100, 150,
                              MfConfig(k=10, epochs=2, batch=512),
                              return_state=True, device=dev)
    assert state.params["u"].device.type == "cuda"
    params, vel, offset = mf_state_to_reference(state)
    back = mf_state_from_reference(params, vel, offset, device=dev)
    for key in ("u", "v"):
        assert torch.equal(back.params[key], state.params[key])
        assert torch.equal(back.vel[key], state.vel[key])
    t = StreamingMF.from_state(back, OnlineMFConfig(k=10), device=dev)
    np.testing.assert_array_equal(t.user_factors(), u)
    np.testing.assert_array_equal(t.item_factors(), v)
    # the numpy spelling, as a state from the reference arrives
    t_np = StreamingMF.from_state(type(state)(params, vel, offset),
                                  OnlineMFConfig(k=10), device=dev)
    assert torch.equal(t_np._vel["v"], t._vel["v"])


# ------------------------------------------------------- multi-host serving


@pytest.mark.parametrize("n_hosts,replication", [(2, 1), (2, 2), (3, 2)])
def test_multihost_on_card_equals_cpu(dev, n_hosts, replication):
    """``sharded-multihost`` on the card answers like the same backend on
    the CPU and like ``sharded`` on the card, bit for bit, through
    mutations, a failover, a background compaction and a repartition;
    ``gam_retrieve`` launches once per bn-group of each routed slice plus
    once for the delta; carved slices are contiguous copies on the card."""
    gr = importlib.import_module("repro_torch.kernels.gam_retrieve")
    items = unit_factors(700, 16, 15)
    users = unit_factors(24, 16, 16)

    def spec(backend, **kw):
        return RetrieverSpec(cfg=CFG, backend=backend, n_shards=4,
                             min_overlap=2, bucket=512,
                             options=(("compact_slice_rows", 128),), **kw)

    mh = spec("sharded-multihost", n_hosts=n_hosts, replication=replication)
    rs = {"cpu": open_retriever(mh, items=items, device="cpu"),
          "cuda": open_retriever(mh, items=items, device="cuda"),
          "sharded": open_retriever(spec("sharded"), items=items,
                                    device="cuda")}

    def same(tag, **kw):
        a = rs["cuda"].query(users, **kw)
        for other in ("cpu", "sharded"):
            b = rs[other].query(users, **kw)
            np.testing.assert_array_equal(a.ids, b.ids, err_msg=tag)
            np.testing.assert_array_equal(a.scores, b.scores, err_msg=tag)
            np.testing.assert_array_equal(a.n_scored, b.n_scored,
                                          err_msg=tag)

    same("build")
    same("build exact", exact=True)
    for r in rs.values():
        r.upsert(np.arange(690, 720), unit_factors(30, 16, 17))
        r.delete(np.arange(0, 700, 13))
    base = rs["cuda"].base
    n_slices = base.placement.n_slices
    before = gr.gam_retrieve.launches
    rs["cuda"].query(users)
    want = sum(len(base.get_slice(sl).metas) for sl in range(n_slices)) + 1
    assert gr.gam_retrieve.launches == before + want
    for sl in range(n_slices):
        sub = base.get_slice(sl)
        if sub is not base.global_index:
            assert sub.device.type == "cuda"
            assert all(m.item_bits_t.is_contiguous() for m in sub.metas)
    same("mutations")
    if replication >= 2:
        for r in (rs["cpu"], rs["cuda"]):
            r.mark_down(1)
        same("host 1 down")
    for r in rs.values():
        r.compact(async_=True)
    while rs["cuda"].maintenance_stats()["compaction"]["active"]:
        same("mid-compaction")
    parts = [r.repartition(async_=False) for r in rs.values()]
    assert parts[0] == parts[1] == parts[2]
    same("repartitioned")
    same("repartitioned exact", exact=True)


def _run(cmd, timeout):
    """``python <cmd>`` from the repository's root, under a deadline."""
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    return subprocess.run([sys.executable, *cmd], capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=root)


def test_two_processes_share_the_card_in_the_multihost_contract(dev):
    """``run_multiprocess_torch.py`` with two gloo processes, both on
    ``cuda:0``: every lifecycle step equals single-host ``sharded``."""
    for replication in (2, 1):
        out = _run(["tests/multihost/run_multiprocess_torch.py",
                    "--processes", "2", "--device", "cuda", "--items",
                    "4000", "--replication", str(replication), "--timeout",
                    "240"], timeout=300)
        assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
        assert "device cuda" in out.stdout


def test_serve_launcher_hosts_2_on_the_card(dev, tmp_path):
    out = _run(["-m", "repro_torch.launch.serve", "--service", "--hosts",
                "2", "--replication", "2", "--fail-host", "1", "--items",
                "4000", "--shards", "4", "--requests", "32", "--verify",
                "--snapshot", str(tmp_path / "mh.npz")], timeout=300)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert "0 WRONG" in out.stdout and "probe bit-identical" in out.stdout


def test_train_step_on_card_equals_cpu(dev):
    """One f32 train step of tinyllama narrowed to 2 layers and d 256 on the
    card and on the CPU, from the same weights and batch (``chip_smoke.py``
    phase 11b): the loss within 1e-5 relative, each gradient leaf within
    1e-4 x the CPU leaf's largest |g| (cuBLAS and the CPU's BLAS sum in
    other orders), the step's metrics within 1e-5 relative, and params
    within 1e-5 but where AdamW's denominator is eps-dominated there
    (sqrt(v_hat) < 100 eps: the update g / (|g| + eps) then moves with the
    tiny gradient's own relative error)."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenPipeline
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.training import AdamWConfig, adamw_init
    from repro_torch.training.optimizer import tree_leaves, tree_map

    cfg = get_config("tinyllama-1.1b").with_(
        n_layers=2, d_model=256, n_heads=4, n_kv_heads=1, head_dim=64,
        d_ff=704, dtype="float32")
    cpu, gpu = Model(cfg, device="cpu"), Model(cfg, device=dev)
    p_cpu = cpu.init(0)
    p_gpu = tree_map(lambda t: t.to(dev), p_cpu)
    tokens = TokenPipeline(vocab=cfg.vocab, seq_len=128, batch=4,
                           seed=3).batch_at(0)
    b_cpu = {"tokens": torch.as_tensor(tokens)}
    b_gpu = {"tokens": torch.as_tensor(tokens, device=dev)}

    def grads(model, params, batch):
        live = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, _ = model.loss(live, batch)
        return loss, torch.autograd.grad(loss, tree_leaves(live))

    l_cpu, g_cpu = grads(cpu, p_cpu, b_cpu)
    l_gpu, g_gpu = grads(gpu, p_gpu, b_gpu)
    assert abs(float(l_gpu) - float(l_cpu)) <= 1e-5 * abs(float(l_cpu))
    for gc, gg in zip(g_cpu, g_gpu):
        assert float((gg.cpu() - gc).abs().max()) <= \
            1e-4 * float(gc.abs().max())

    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    pc, sc, mc = make_train_step(cpu, opt_cfg)(p_cpu, adamw_init(p_cpu),
                                               b_cpu)
    pg, _, mg = make_train_step(gpu, opt_cfg)(p_gpu, adamw_init(p_gpu),
                                              b_gpu)
    for k in mc:
        assert abs(float(mg[k]) - float(mc[k])) <= \
            1e-5 * max(abs(float(mc[k])), 1e-30), k
    b2c = 1 - opt_cfg.b2
    leaves = zip(tree_leaves(pc), tree_leaves(pg), tree_leaves(sc.nu))
    for want, got, nu in leaves:
        off = (got.cpu() - want).abs() > 1e-5
        assert bool((torch.sqrt(nu[off] / b2c) < 100 * opt_cfg.eps).all())
