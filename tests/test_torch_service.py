"""The port's ``sharded`` service tier against ``repro``'s, on the CPU.

Both packages get the same numpy inputs and the same sequence of operations:
build, query, upserts, deletes, kills, background compaction (every slice,
and an abort at every phase), repartitions (heterogeneous layouts), the
int8 compressed catalog, snapshots crossing both ways (with a live delta
and mid-compaction), the QoS degrade ladder under an injected clock, the
result cache and the fault injector.

Ids, ``n_scored``, ``discarded_frac``, per-shard / per-block candidate
counts, skip maps, partitions, planner phases and metric counters match
exactly; scores within 4 ulp of the dot-product scale
(``assert_scores_close``: the reference's dot is not one fixed order, the
port's is a sequential fma loop).  Within the port, a heterogeneous
partition answers bit for bit like the uniform one.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from conftest import CFG, unit_factors  # noqa: E402
from test_torch_gam_retrieve import assert_scores_close  # noqa: E402

import repro.retriever as jr  # noqa: E402
import repro.service as js  # noqa: E402
import repro_torch.retriever as tr  # noqa: E402
import repro_torch.service as ts  # noqa: E402
from repro.core.inverted_index import \
    candidate_mask_from_table as jax_mask  # noqa: E402
from repro.core.mapping import sparse_map as jax_map  # noqa: E402
from repro_torch.core.inverted_index import \
    candidate_mask_from_table  # noqa: E402
from repro_torch.core.mapping import GamConfig, sparse_map  # noqa: E402

TCFG = GamConfig(k=CFG.k, scheme=CFG.scheme, d=CFG.d,
                 threshold=CFG.threshold)
USERS = unit_factors(12, CFG.k, 1)


def _pair(items=None, ids=None, *, jkw=None, tkw=None, **kw):
    """(reference, port) ``sharded`` retrievers over the same catalog."""
    kw.setdefault("n_shards", 2)
    kw.setdefault("min_overlap", 2)
    kw.setdefault("bucket", 512)
    jspec = jr.RetrieverSpec(cfg=CFG, backend="sharded", **kw)
    tspec = tr.RetrieverSpec(cfg=TCFG, backend="sharded", **kw)
    return (jr.open_retriever(jspec, items=items, ids=ids, **(jkw or {})),
            tr.open_retriever(tspec, items=items, ids=ids, device="cpu",
                              **(tkw or {})))


def _catalog(r):
    ids = np.sort(np.fromiter(r.catalog.keys(), np.int64, r.n_items))
    fac = (np.stack([r.catalog[int(i)] for i in ids]) if ids.size
           else np.zeros((0, CFG.k), np.float32))
    return ids, fac


def _same(got, want, users=USERS, explain=False):
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.n_scored, want.n_scored)
    np.testing.assert_array_equal(got.discarded_frac, want.discarded_frac)
    real = np.isfinite(want.scores)
    np.testing.assert_array_equal(np.isfinite(got.scores), real)
    assert_scores_close(np.where(real, got.scores, 0),
                        np.where(real, want.scores, 0), users,
                        unit_factors(1, CFG.k, 0))
    assert got.degraded == want.degraded
    assert got.degrade_rung == want.degrade_rung
    if explain:
        assert got.explain == want.explain


def _both_queries(j, t, users=USERS, kappa=None):
    for exact in (False, True):
        _same(t.query(users, kappa, exact=exact, explain=True),
              j.query(users, kappa, exact=exact, explain=True), users,
              explain=True)


def _same_base(jb, tb, users=USERS, kappa=10):
    """The main segments' raw answers, candidate counts and skip maps."""
    u = torch.as_tensor(users)
    tau, vals = sparse_map(u, TCFG)
    got = tb.query(u, tau, vals != 0, kappa, collect_tile_skips=True)
    jtau, jvals = jax_map(jnp.asarray(users), CFG)
    want = jb.query(jnp.asarray(users), jtau, jvals != 0, kappa,
                    collect_tile_skips=True)
    np.testing.assert_array_equal(got.rows, want.rows)
    np.testing.assert_array_equal(got.shard_candidates,
                                  want.shard_candidates)
    np.testing.assert_array_equal(got.block_candidates,
                                  want.block_candidates)
    np.testing.assert_array_equal(got.tile_skips, want.tile_skips)
    assert got.tiles_skipped_frac == want.tiles_skipped_frac
    dense = tb.query_dense_reference(u, tau, vals != 0, kappa)
    np.testing.assert_array_equal(dense.rows, got.rows)
    np.testing.assert_array_equal(dense.scores, got.scores)
    for jm, tm in zip(jb.metas, tb.metas):
        np.testing.assert_array_equal(tm.item_bits_t.numpy().view(np.uint32),
                                      np.asarray(jm.item_bits_t))
        np.testing.assert_array_equal(tm.block_union.numpy().view(np.uint32),
                                      np.asarray(jm.block_union))
        np.testing.assert_array_equal(tm.block_spill.numpy(),
                                      np.asarray(jm.block_spill))
        np.testing.assert_array_equal(tm.spill8.numpy(),
                                      np.asarray(jm.spill8))


def _part(p):
    return p.lengths, p.bns, p.caps


def _fresh(r, **kw):
    ids, fac = _catalog(r)
    return tr.open_retriever(r.spec, items=fac, ids=ids, device="cpu", **kw)


def _bitwise(a, b, tag=""):
    np.testing.assert_array_equal(a.ids, b.ids, err_msg=tag)
    np.testing.assert_array_equal(a.scores, b.scores, err_msg=tag)


# ------------------------------------------------------------ build + query


@pytest.mark.parametrize("n,n_shards,min_overlap,bucket", [
    (300, 1, 1, 256), (300, 3, 2, 512), (257, 4, 2, 8), (40, 2, 1, 256)])
def test_build_and_query_match_reference(n, n_shards, min_overlap, bucket):
    items = unit_factors(n, CFG.k, n)
    ids = np.random.default_rng(n).permutation(10 * n)[:n]
    j, t = _pair(items, ids, n_shards=n_shards, min_overlap=min_overlap,
                 bucket=bucket)
    assert _part(t.base.partition) == _part(j.base.partition)
    np.testing.assert_array_equal(t.base.tables.numpy(),
                                  np.asarray(j.base.tables))
    np.testing.assert_array_equal(t.base.counts.numpy(),
                                  np.asarray(j.base.counts))
    np.testing.assert_array_equal(t.base.spills.numpy(),
                                  np.asarray(j.base.spills))
    _both_queries(j, t)
    _same_base(j.base, t.base)
    st, sj = t.stats(), j.stats()
    for key in ("n_items", "n_shards", "n_live_base", "delta_len",
                "generation", "posting_load"):
        assert st[key] == sj[key], key


def test_candidate_mask_drops_padded_spill_entries_like_reference():
    """Repair: the sharded index pads each shard's spill list with the
    shard's cap; the reference's scatter drops those entries
    (``mode="drop"``), the port's first version indexed past the mask."""
    rng = np.random.default_rng(3)
    table = rng.integers(0, 41, size=(30, 6)).astype(np.int32)   # 40 = pad
    spill = np.array([2, 17, 40, 40], np.int32)
    q_tau = rng.integers(0, 30, size=(5, 8)).astype(np.int32)
    q_mask = rng.random((5, 8)) < 0.8
    got = candidate_mask_from_table(
        torch.as_tensor(table), torch.as_tensor(spill),
        torch.as_tensor(q_tau), torch.as_tensor(q_mask), sentinel=40,
        min_overlap=2)
    for i in range(5):
        want = jax_mask(jnp.asarray(table), jnp.asarray(spill),
                     jnp.asarray(q_tau[i]), jnp.asarray(q_mask[i]),
                     sentinel=40, min_overlap=2)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def test_empty_catalog_and_kappa_past_the_catalog():
    j, t = _pair(unit_factors(5, CFG.k, 3), n_shards=2)
    _both_queries(j, t, kappa=12)
    je, te = _pair(None)
    _same(te.query(USERS), je.query(USERS))


# ------------------------------------------------------------ mutations


def test_upserts_and_deletes_match_reference_and_fresh_rebuild():
    items = unit_factors(200, CFG.k, 11)
    j, t = _pair(items, n_shards=3)
    steps = [("upsert", np.arange(195, 215), unit_factors(20, CFG.k, 12)),
             ("delete", np.arange(0, 200, 7), None),
             ("upsert", [3, 500, 3], unit_factors(3, CFG.k, 13)),
             ("delete", [500, 9999], None)]
    for op, ids, fac in steps:
        for r in (j, t):
            (r.upsert(ids, fac) if op == "upsert" else r.delete(ids))
        np.testing.assert_array_equal(t.delta.ids, j.delta.ids)
        np.testing.assert_array_equal(t.base._alive_host,
                                      j.base._alive_host)
        _both_queries(j, t)
        _same_base(j.base, t.base)
        fresh = _fresh(t)
        _bitwise(t.query(USERS), fresh.query(USERS), op)
        _bitwise(t.query(USERS, exact=True), fresh.query(USERS, exact=True))
    assert t.n_items == j.n_items


def test_duplicate_ids_in_one_batch_last_write_wins():
    items = unit_factors(30, CFG.k, 23)
    j, t = _pair(items, kappa=31, min_overlap=1)
    f = unit_factors(2, CFG.k, 24)
    for r in (j, t):
        r.upsert([40, 40], f)
    assert len(t.delta) == 1
    np.testing.assert_array_equal(t.delta.factors[0], f[1])
    _same(t.query(f[1:2], 31), j.query(f[1:2], 31), f[1:2])
    assert (t.query(f[1:2], 31).ids == 40).sum() == 1


def test_kill_refreshes_block_metadata_like_reference():
    """Tombstoning a whole pattern-coherent cluster makes its blocks
    skippable at once, in both packages, with the same skip rate, block
    unions and answers."""
    rng = np.random.default_rng(28)
    nc, per = 8, 256
    centers = rng.normal(size=(nc, 16)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    items = (np.repeat(centers, per, axis=0)
             + 0.03 * rng.normal(size=(nc * per, 16)).astype(np.float32))
    items /= np.linalg.norm(items, axis=1, keepdims=True)
    users = (centers[0] + 0.03 * rng.normal(size=(6, 16))).astype(np.float32)
    users /= np.linalg.norm(users, axis=1, keepdims=True)
    j, t = _pair(items, n_shards=1, min_overlap=3, bucket=2048)
    _same(t.query(users, 10), j.query(users, 10), users)
    before = t._last_query_stats["tiles_skipped_frac"]
    for r in (j, t):
        r.delete(np.arange(per))
    _same(t.query(users, 10), j.query(users, 10), users)
    after = t._last_query_stats["tiles_skipped_frac"]
    assert after > before
    assert after == j._last_query_stats["tiles_skipped_frac"]
    _same_base(j.base, t.base, users)
    _bitwise(t.query(users, 10), _fresh(t).query(users, 10))


def test_delta_segment_matches_reference_and_keeps_its_capacity():
    jd = js.DeltaSegment(CFG, min_overlap=1)
    td = ts.DeltaSegment(TCFG, min_overlap=1, device="cpu")
    for ids, seed in (([0, 1, 2], 25), ([3], 26), ([4], 27), ([1], 28)):
        fac = unit_factors(len(ids), CFG.k, seed)
        jd.upsert(ids, fac)
        td.upsert(ids, fac)
        assert td._factors_dev.shape == jd._factors_dev.shape
        np.testing.assert_array_equal(td._factors_dev.numpy(),
                                      np.asarray(jd._factors_dev))
        np.testing.assert_array_equal(td._index.table.numpy(),
                                      np.asarray(jd._index.table))
    assert td._factors_dev.shape[0] == 8
    td.delete([7, 1])
    jd.delete([7, 1])
    np.testing.assert_array_equal(td.ids, jd.ids)
    td.clear()
    assert len(td) == 0 and td._meta is None


# ------------------------------------------------------------ compaction


def _harness_ops(j, t, ops):
    for op, ids, fac in ops:
        for r in (j, t):
            (r.upsert(ids, fac) if op == "upsert" else r.delete(ids))


def test_background_compaction_every_slice_matches_reference():
    opts = (("compact_slice_rows", 16),)
    items = unit_factors(96, CFG.k, 990)
    j, t = _pair(items, options=opts)
    _harness_ops(j, t, [("upsert", np.arange(100, 110),
                         unit_factors(10, CFG.k, 7)),
                        ("delete", np.arange(0, 96, 9), None)])
    for r in (j, t):
        r.compact(async_=True)
    assert t._planner.total_slices == j._planner.total_slices
    steps = 0
    while t.maintenance_stats()["compaction"]["active"]:
        if steps == 2:                      # mutations race the build
            _harness_ops(j, t, [("upsert", [200], unit_factors(1, CFG.k, 8)),
                                ("delete", [3], None)])
        swapped = t.compaction_step()
        assert j.compaction_step() == swapped
        steps += 1
        assert t.maintenance_stats() == j.maintenance_stats()
        _both_queries(j, t)               # each query advances one slice
        got = t.query(USERS, 8)
        _same(got, j.query(USERS, 8))
        _bitwise(got, _fresh(t).query(USERS, 8), str(steps))
        assert steps < 100
    assert t.metrics.snapshot()["n_compact_slices"] >= 4
    assert t.generation == j.generation == 1
    np.testing.assert_array_equal(t.delta.ids, [200])
    assert ([e["kind"] for e in t.events.tail()]
            == [e["kind"] for e in j.events.tail()])


def test_abort_at_every_phase_matches_reference():
    items = unit_factors(60, CFG.k, 990)
    opts = (("compact_slice_rows", 16),)
    j0, t0 = _pair(items, options=opts)
    t0.compact(async_=True)
    total = t0._planner.total_slices
    for n_steps in range(total + 1):
        j, t = _pair(items, options=opts)
        _harness_ops(j, t, [("upsert", [70, 71], unit_factors(2, CFG.k, 5))])
        for r in (j, t):
            r.compact(async_=True)
            r.compaction_step(max_slices=n_steps)
            r.abort_compaction()
        assert t.maintenance_stats() == j.maintenance_stats()
        _both_queries(j, t)
        for r in (j, t):
            r.compact()
        assert t.generation == j.generation
        _both_queries(j, t)


# ------------------------------------------------------------ repartition


def test_repartitioner_plans_match_reference():
    rng = np.random.default_rng(5)
    for n, n_shards in ((1000, 4), (37, 3), (0, 2), (500, 1)):
        w = rng.gamma(0.5, size=n) * (1 + 20 * (np.arange(n) < n // 5))
        for tb in (4, 8, 32):
            jp = js.Repartitioner(target_blocks=tb).plan(w, n_shards)
            tp = ts.Repartitioner(target_blocks=tb).plan(w, n_shards)
            assert _part(tp) == _part(jp)
            for a, b in ((tp.offsets, jp.offsets), (tp.groups, jp.groups)):
                assert a == b
    loads = rng.random(9)
    assert ts.Repartitioner.skew(loads) == js.Repartitioner.skew(loads)
    assert (_part(ts.Partition.uniform(257, 3))
            == _part(js.Partition.uniform(257, 3)))
    with pytest.raises(ValueError):
        ts.Partition((5,), (12,), (24,))


def test_map_cache_matches_reference():
    items = unit_factors(50, CFG.k, 3)
    ids = np.arange(50) * 3
    jc, tc = js.MapCache(CFG), ts.MapCache(TCFG, device="cpu")
    for sl in (slice(0, 20), slice(10, 50), slice(0, 50)):
        jt, jm = jc.lookup(ids[sl], items[sl])
        tt, tm = tc.lookup(ids[sl], items[sl])
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tm, jm)
    tc.invalidate(ids[:5])
    jc.invalidate(ids[:5])
    tc.lookup(ids, items)
    jc.lookup(ids, items)
    assert tc.stats() == jc.stats()


@pytest.mark.parametrize("async_", [False, True])
def test_repartition_matches_reference(async_):
    # a hot cluster at the front of the id order: its blocks draw most of
    # the candidate traffic, so the balanced cut gives it a short shard
    # with narrow blocks (two bn-groups at least)
    rng = np.random.default_rng(77)
    hot = rng.normal(size=16).astype(np.float32)
    items = np.concatenate([hot + 0.05 * rng.normal(size=(40, 16)),
                            rng.normal(size=(120, 16))]).astype(np.float32)
    items /= np.linalg.norm(items, axis=1, keepdims=True)
    users = (hot + 0.05 * rng.normal(size=(8, 16))).astype(np.float32)
    users /= np.linalg.norm(users, axis=1, keepdims=True)
    j, t = _pair(items, n_shards=3, options=(("rebalance_target_blocks",
                                              2),))
    for r in (j, t):
        for i in range(8):                 # traffic so the metrics have load
            r.batcher.submit(users[i])
        r.batcher.flush()
        r.upsert([500, 501], unit_factors(2, CFG.k, 79))
    jp, tp = j.repartition(async_=async_), t.repartition(async_=async_)
    assert _part(tp) == _part(jp)
    assert len(tp.groups) >= 2
    steps = 0
    while t.maintenance_stats()["compaction"]["active"]:
        _both_queries(j, t)              # a query advances one slice
        steps += 1
    assert t.maintenance_stats() == j.maintenance_stats()
    _both_queries(j, t)
    _same_base(j.base, t.base)


@pytest.mark.parametrize("lengths,bns", [
    ((100, 100, 100), (16, 16, 16)),
    ((40, 160, 100), (8, 32, 16)),
    ((10, 90, 200), (8, 8, 64))])
def test_heterogeneous_partition_equals_uniform_bit_for_bit(lengths, bns):
    """Within the port any partition answers like the uniform one, to the
    bit (one sequential fma loop whatever the tiling); against the
    reference, ids exactly and scores within 4 ulp."""
    items = unit_factors(300, CFG.k, 0)
    part = ts.Partition.from_lengths(lengths, bns)
    uni = ts.ShardedGamIndex.build(items, TCFG, n_shards=3, min_overlap=2,
                                   bucket=512, device="cpu")
    het = ts.ShardedGamIndex.build(items, TCFG, n_shards=3, min_overlap=2,
                                   bucket=512, partition=part,
                                   device="cpu")
    jhet = js.ShardedGamIndex.build(
        items, CFG, n_shards=3, min_overlap=2, bucket=512,
        partition=js.Partition.from_lengths(lengths, bns))
    assert len(het.metas) == len(jhet.metas)
    u = torch.as_tensor(USERS)
    tau, vals = sparse_map(u, TCFG)
    for exact in (False, True):
        a = uni.query(u, tau, vals != 0, 10, exact=exact)
        b = het.query(u, tau, vals != 0, 10, exact=exact)
        np.testing.assert_array_equal(het.rows_to_ids(b.rows, b.scores),
                                      uni.rows_to_ids(a.rows, a.scores))
        np.testing.assert_array_equal(b.scores, a.scores)
        d = het.query_dense_reference(u, tau, vals != 0, 10, exact=exact)
        np.testing.assert_array_equal(d.rows, b.rows)
        np.testing.assert_array_equal(d.scores, b.scores)
        np.testing.assert_array_equal(d.shard_candidates, b.shard_candidates)
    _same_base(jhet, het)


def _loaded_pair(layout):
    """A (reference, port) pair with a live delta: the uniform layout, or
    a repartition to at least two bn-groups (a hot cluster at the front of
    the id order draws the candidate traffic)."""
    rng = np.random.default_rng(77)
    hot = rng.normal(size=16).astype(np.float32)
    items = np.concatenate([hot + 0.05 * rng.normal(size=(40, 16)),
                            rng.normal(size=(120, 16))]).astype(np.float32)
    items /= np.linalg.norm(items, axis=1, keepdims=True)
    users = (hot + 0.05 * rng.normal(size=(8, 16))).astype(np.float32)
    users /= np.linalg.norm(users, axis=1, keepdims=True)
    j, t = _pair(items, n_shards=3, options=(("rebalance_target_blocks",
                                              2),))
    for r in (j, t):
        if layout == "heterogeneous":
            for i in range(8):
                r.batcher.submit(users[i])
            r.batcher.flush()
            r.repartition(async_=False)
        r.upsert([500, 501, 3], unit_factors(3, CFG.k, 79))
        r.delete([7])
        r.metrics.reset()
    assert len(t.delta) == 3
    assert (len(t.base.partition.groups) >= 2) == (layout == "heterogeneous")
    return j, t, users


@pytest.mark.parametrize("path", ["microbatch", "direct"])
@pytest.mark.parametrize("layout", ["uniform", "heterogeneous"])
def test_card_side_candidate_sums_equal_the_reference_counts(layout, path):
    """The port sums candidates by shard in the kernel and per block on
    the device; shard candidates, ``n_scored`` and the metrics' block
    loads equal the reference's, which sums the copied (Q, n_blocks)
    counts on the host."""
    j, t, users = _loaded_pair(layout)
    n_real = 5
    padded = np.concatenate([users[:n_real], np.zeros((3, CFG.k),
                                                      np.float32)])
    for r in (j, t):
        if path == "microbatch":
            r._batch_query_fn(padded, n_real)
        else:
            r.query(users)
            r.record_last_query_stats()
    np.testing.assert_array_equal(t.metrics.block_candidates,
                                  j.metrics.block_candidates)
    np.testing.assert_array_equal(t.metrics.shard_candidates,
                                  j.metrics.shard_candidates)
    assert t.metrics.block_candidates.sum() > 0
    _same(t.query(users), j.query(users), users)
    got = t.query(users, explain=True)
    _same(got, j.query(users, explain=True), users, explain=True)
    assert got.explain["n_candidates"] == got.n_scored.tolist()
    # the index's own sums against the counts it copies under explain
    u = torch.as_tensor(users)
    tau, vals = sparse_map(u, TCFG)
    full = t.base.query(u, tau, vals != 0, 10, collect_tile_skips=True)
    part = t.base.query(u, tau, vals != 0, 10, stats_rows=n_real)
    assert part.block_candidates is None and part.tile_skips is None
    np.testing.assert_array_equal(part.shard_candidates,
                                  full.shard_candidates)
    np.testing.assert_array_equal(part.block_totals,
                                  full.block_candidates[:n_real].sum(0))
    np.testing.assert_array_equal(full.block_totals,
                                  full.block_candidates.sum(0))
    assert part.tiles_skipped_frac == full.tiles_skipped_frac


def test_block_loads_fold_only_over_the_rows_they_were_summed_on():
    _, t, users = _loaded_pair("uniform")
    t.query(users)
    with pytest.raises(ValueError, match="stats_rows=5"):
        t.record_last_query_stats(5)
    t.query(users, stats_rows=5)
    t.record_last_query_stats(5)
    assert t.metrics.block_candidates.sum() > 0


# ------------------------------------------------------------ snapshots


@pytest.mark.parametrize("mid_compaction", [False, True])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_snapshots_cross_between_packages(tmp_path, writer, mid_compaction):
    opts = (("compact_slice_rows", 16),)
    items = unit_factors(90, CFG.k, 31)
    j, t = _pair(items, options=opts, n_shards=3)
    _harness_ops(j, t, [("upsert", np.arange(100, 108),
                         unit_factors(8, CFG.k, 3)),
                        ("delete", [1, 2, 50], None)])
    for r in (j, t):
        r.repartition(async_=False)          # a skew-aware layout
        r.upsert([300, 5], unit_factors(2, CFG.k, 4))   # a live delta
        if mid_compaction:
            r.compact(async_=True)
            r.compaction_step(max_slices=2)
    path = os.fspath(tmp_path / "snap.npz")
    (t if writer == "port" else j).snapshot(path)
    spec_j, spec_t = j.spec, t.spec
    tj = jr.open_retriever(spec_j, snapshot=path)
    tt = tr.open_retriever(spec_t, snapshot=path, device="cpu")
    for r in (tj, tt):
        assert not r.maintenance_stats()["compaction"]["active"]
        assert r.generation == 1
    np.testing.assert_array_equal(tt.delta.ids, [5, 300])
    _both_queries(tj, tt)
    _same_base(tj.base, tt.base)
    _same(tt.query(USERS), j.query(USERS))
    if writer == "port":
        _bitwise(tt.query(USERS), t.query(USERS))
        _bitwise(tt.query(USERS, exact=True), t.query(USERS, exact=True))


def test_compressed_int8_snapshots_cross_between_packages(tmp_path):
    kw = dict(quantize="int8", rerank_factor=2, compress_postings=True)
    items = unit_factors(150, CFG.k, 41)
    j, t = _pair(items, n_shards=2, **kw)
    _harness_ops(j, t, [("upsert", [7, 400], unit_factors(2, CFG.k, 42))])
    for writer, reader_j in ((t, True), (j, False)):
        path = os.fspath(tmp_path / f"c{int(reader_j)}.npz")
        writer.snapshot(path)
        tt = tr.open_retriever(t.spec, snapshot=path, device="cpu")
        tj = jr.open_retriever(j.spec, snapshot=path)
        _both_queries(tj, tt)
        for jm, tm in zip(tj.base.metas, tt.base.metas):
            np.testing.assert_array_equal(tm.factors_q.numpy(),
                                          np.asarray(jm.factors_q))


# ------------------------------------------------------------ int8


@pytest.mark.parametrize("rerank_factor", [1, 4])
def test_int8_sharded_matches_reference(rerank_factor):
    kw = dict(quantize="int8", rerank_factor=rerank_factor)
    items = unit_factors(220, CFG.k, 51)
    j, t = _pair(items, n_shards=3, **kw)
    for jm, tm in zip(j.base.metas, t.base.metas):
        np.testing.assert_array_equal(tm.factors_q.numpy(),
                                      np.asarray(jm.factors_q))
        np.testing.assert_array_equal(tm.scales.numpy(),
                                      np.asarray(jm.scales))
    _both_queries(j, t)
    _harness_ops(j, t, [("upsert", [3, 300], unit_factors(2, CFG.k, 52)),
                        ("delete", [10], None)])
    _both_queries(j, t)
    for r in (j, t):
        r.repartition(async_=False)
    _both_queries(j, t)


# ------------------------------------------------- QoS, cache and faults


def _manual_clock():
    now = [0.0]
    return now, lambda: now[0]


def test_degrade_ladder_rungs_match_reference():
    items = unit_factors(300, CFG.k, 0)
    users = unit_factors(6, CFG.k, 1)
    jt, jclock = _manual_clock()
    tt, tclock = _manual_clock()
    j, t = _pair(items, min_overlap=1, kappa=8, jkw={"clock": jclock},
                 tkw={"clock": tclock})
    for r in (j, t):
        r.upsert([10_000], unit_factors(1, CFG.k, 9))
    for exact, budget in ((False, 50.0), (True, 0.7), (False, 0.7),
                          (False, 0.3), (False, 0.1), (True, 0.1)):
        j._cost_est = t._cost_est = 1.0
        got = t.query(users, exact=exact, deadline_s=budget, explain=True)
        want = j.query(users, exact=exact, deadline_s=budget, explain=True)
        _same(got, want, users, explain=True)
    rungs = []
    for budget in (0.7, 0.3, 0.1):
        t._cost_est = 1.0
        rungs.append(t.query(users, deadline_s=budget).degrade_rung)
    j._cost_est = 1.0
    assert rungs == [None, "raise_overlap", "base_only"]
    for budget in (0.7, 0.3, 0.1):
        j._cost_est = 1.0
        j.query(users, deadline_s=budget)
    assert t.metrics.snapshot() == j.metrics.snapshot()


def test_result_cache_and_faults_match_reference():
    items = unit_factors(120, CFG.k, 61)
    users = unit_factors(4, CFG.k, 62)
    j, t = _pair(items, cache_capacity=8, kappa=6)
    for r in (j, t):
        r.query(users)
        r.query(users)                          # every row hits
        r.upsert([5], unit_factors(1, CFG.k, 63))   # bumps the version
        r.query(users[:2])
    assert t.cache.stats() == j.cache.stats()
    _same(t.query(users), j.query(users), users)
    for r in (j, t):
        rid = r.batcher.submit(users[0])        # probe hits before queueing
        res = r.batcher.result(rid)
        assert res is not None
    fates_t = ts.FaultInjector("delta_error=0.5", seed=7)
    fates_j = js.FaultInjector("delta_error=0.5", seed=7)
    assert ([fates_t.roll_delta_error() for _ in range(64)]
            == [fates_j.roll_delta_error() for _ in range(64)])
    t.faults = ts.FaultInjector("delta_error=1.0", seed=1)
    with pytest.raises(ts.FaultInjected):
        t.upsert([77], unit_factors(1, CFG.k, 64))
    assert 777 not in t.catalog                 # raised before any mutation


def test_microbatcher_matches_reference_under_an_injected_clock():
    items = unit_factors(100, CFG.k, 71)
    users = unit_factors(11, CFG.k, 72)
    jnow, jclock = _manual_clock()
    tnow, tclock = _manual_clock()
    j, t = _pair(items, batch_size=4, max_delay_s=1e-3,
                 jkw={"clock": jclock}, tkw={"clock": tclock})
    out = {}
    for name, r, now in (("j", j, jnow), ("t", t, tnow)):
        rids = []
        for i, u in enumerate(users):
            now[0] += 2e-4
            rids.append(r.batcher.submit(u, priority=i % 2))
        now[0] += 5e-3
        assert r.batcher.poll()
        out[name] = [r.batcher.result(i) for i in rids]
        assert r.batcher.pending == 0
    for a, b in zip(out["t"], out["j"]):
        np.testing.assert_array_equal(a.ids, b.ids)
        assert (a.latency_s, a.queue_wait_s) == (b.latency_s, b.queue_wait_s)
    assert t.metrics.snapshot() == j.metrics.snapshot()


def test_sharded_specs_the_port_refuses():
    spec = tr.RetrieverSpec(cfg=TCFG, backend="sharded")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tr.open_retriever(spec, device="cpu", mesh="mesh")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tr.open_retriever(tr.RetrieverSpec(cfg=TCFG,
                                           backend="sharded-multihost"),
                          device="cpu", mesh="mesh")
    r = tr.open_retriever(spec, items=unit_factors(20, CFG.k, 1),
                          device="cpu")
    with pytest.raises(tr.UnsupportedOp):
        r.candidate_masks(USERS)
