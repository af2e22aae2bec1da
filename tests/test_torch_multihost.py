"""The port's ``sharded-multihost`` backend against ``repro``'s, on the CPU.

Mirrors ``tests/test_multihost.py`` (placement, the merge order, cross-host
ties, failover, ``NoLiveReplica``, host load, snapshot rehosting and
scale-out, the ``MapCache``) and the multi-host cases of
``tests/test_qos.py`` (serving around faults, the breaker, hedged reads).
Both packages get the same numpy inputs and the same operations.  Within
the port, the multi-host answer equals the port's single-host ``sharded``
answer bit for bit (ids, scores, ``n_scored``, discarded fractions);
against the reference's multi-host answer, ids, ``n_scored`` and the
discarded fractions are exact and scores within 4 ulp of each query's
dot-product scale (``assert_scores_close``).

Single-process placement runs the routing and merge code the distributed
deployment runs, with the gather as the identity; the last tests run
``tests/multihost/run_multiprocess_torch.py`` with two real gloo processes
under a deadline, and the carved slices are held byte for byte against a
fresh build of each slice.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from conftest import CFG, unit_factors as _factors  # noqa: E402
from test_torch_gam_retrieve import assert_scores_close  # noqa: E402

import repro.retriever as jr  # noqa: E402
import repro.service.collective as jc  # noqa: E402
import repro_torch.retriever as tr  # noqa: E402
from repro.kernels.gam_retrieve import export_topk as j_export  # noqa: E402
from repro.service.repartition import Partition as JPartition  # noqa: E402
from repro_torch.checkpoint import load_arrays  # noqa: E402
from repro_torch.core.mapping import GamConfig, sparse_map  # noqa: E402
from repro_torch.kernels.gam_retrieve import (TOPK_EMPTY_ROW,  # noqa: E402
                                              export_topk)
from repro_torch.kernels.gam_score import NEG  # noqa: E402
from repro_torch.launch import procs  # noqa: E402
from repro_torch.retriever import convert  # noqa: E402
from repro_torch.retriever.multihost import (MultiHostIndex,  # noqa: E402
                                             _slice_index)
from repro_torch.service import collective  # noqa: E402
from repro_torch.service.collective import (HostPlacement,  # noqa: E402
                                            NoLiveReplica, merge_topk)
from repro_torch.service.faults import FaultInjector  # noqa: E402
from repro_torch.service.qos import QosPolicy  # noqa: E402
from repro_torch.service.repartition import MapCache, Partition  # noqa: E402
from repro_torch.service.sharded_index import ShardedGamIndex  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
RUNNER = ROOT / "tests" / "multihost" / "run_multiprocess_torch.py"
TCFG = GamConfig(k=CFG.k, scheme=CFG.scheme, d=CFG.d, threshold=CFG.threshold)


def _kw(backend, kw):
    kw.setdefault("min_overlap", 2)
    kw.setdefault("bucket", 512)
    kw.setdefault("n_shards", 4)
    if backend == "sharded-multihost":
        kw.setdefault("n_hosts", 2)
        kw.setdefault("replication", 2)
    return kw


def _spec(backend="sharded-multihost", **kw):
    return tr.RetrieverSpec(cfg=TCFG, backend=backend, **_kw(backend, kw))


def _jspec(backend="sharded-multihost", **kw):
    return jr.RetrieverSpec(cfg=CFG, backend=backend, **_kw(backend, kw))


def _open(backend="sharded-multihost", items=None, ids=None, snapshot=None,
          *, rkw=None, **kw):
    return tr.open_retriever(_spec(backend, **kw), items, ids,
                             snapshot=snapshot, device="cpu", **(rkw or {}))


def _jopen(backend="sharded-multihost", items=None, ids=None, snapshot=None,
           *, rkw=None, **kw):
    return jr.open_retriever(_jspec(backend, **kw), items, ids,
                             snapshot=snapshot, **(rkw or {}))


def _assert_bits(a, b, tag=""):
    """The port's multi-host answer against the port's ``sharded``: the
    same bits."""
    np.testing.assert_array_equal(a.ids, b.ids, err_msg=tag)
    np.testing.assert_array_equal(a.scores, b.scores, err_msg=tag)
    np.testing.assert_array_equal(a.n_scored, b.n_scored, err_msg=tag)
    np.testing.assert_array_equal(a.discarded_frac, b.discarded_frac,
                                  err_msg=tag)


def _assert_ref(got, want, users, items, tag=""):
    """The port's answer against the reference's: ids, counts and
    discarded fractions exact, scores within 4 ulp."""
    np.testing.assert_array_equal(got.ids, np.asarray(want.ids), err_msg=tag)
    np.testing.assert_array_equal(got.n_scored, np.asarray(want.n_scored),
                                  err_msg=tag)
    np.testing.assert_array_equal(got.discarded_frac,
                                  np.asarray(want.discarded_frac),
                                  err_msg=tag)
    ws = np.asarray(want.scores)
    real = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(got.scores), real)
    assert_scores_close(np.where(real, got.scores, 0), np.where(real, ws, 0),
                        users, items)


def _all_three(multi, single, jmulti, users, items, tag="", **q):
    got = multi.query(users, 10, **q)
    _assert_bits(got, single.query(users, 10, **q), tag)
    _assert_ref(got, jmulti.query(users, 10, **q), users, items, tag)
    return got


def _same_placement(pt: HostPlacement, pj) -> None:
    assert pt.describe() == pj.describe()


# ---------------------------------------------------------------- placement


@pytest.mark.parametrize("lengths,bns,hosts,repl", [
    ((100, 100, 100, 100), (8, 8, 8, 8), 2, 2),
    ((600, 8, 8, 8), (8, 8, 8, 8), 2, 1),
])
def test_placement_from_partition_like_reference(lengths, bns, hosts, repl):
    pt = HostPlacement.from_partition(Partition.from_lengths(lengths, bns),
                                      n_hosts=hosts, replication=repl)
    pj = jc.HostPlacement.from_partition(JPartition.from_lengths(lengths, bns),
                                         n_hosts=hosts, replication=repl)
    _same_placement(pt, pj)
    if repl == 2:
        assert pt.slices == ((0, 2), (2, 4))
        assert pt.replicas == ((0, 1), (1, 0))
        assert pt.slices_of(0) == (0, 1) and pt.slices_of(1) == (0, 1)
    else:
        # the heavy shard alone outweighs the rest: it gets its own slice
        assert pt.slices == ((0, 1), (1, 4))


def test_placement_never_emits_empty_slices():
    pt = HostPlacement.from_partition(Partition.from_lengths((100, 0, 0),
                                                             (8, 8, 8)),
                                      n_hosts=3, replication=1)
    assert all(hi > lo for lo, hi in pt.slices) and pt.n_slices == 3
    _same_placement(pt, jc.HostPlacement.from_partition(
        JPartition.from_lengths((100, 0, 0), (8, 8, 8)), n_hosts=3,
        replication=1))


def test_placement_hot_shard_collapsing_all_cuts_stays_nonempty():
    """Every quantile cut lands on one heavy shard: each slice still gets a
    non-empty run, and the skewed layout serves like ``sharded`` and like
    the reference."""
    lengths = (8, 8, 8, 1000, 8, 8, 8, 8)
    pt = HostPlacement.from_partition(
        Partition.from_lengths(lengths, (8,) * 8), n_hosts=4, replication=2)
    _same_placement(pt, jc.HostPlacement.from_partition(
        JPartition.from_lengths(lengths, (8,) * 8), n_hosts=4,
        replication=2))
    assert all(hi > lo for lo, hi in pt.slices)
    assert pt.slices[-1][1] == 8 and pt.n_slices == 4
    with pytest.raises(ValueError, match="non-empty"):
        HostPlacement(2, 1, ((0, 2), (2, 2)), ((0,), (1,)))
    lengths = (8, 8, 8, 120, 8, 8, 8, 8)
    items = _factors(sum(lengths), CFG.k, 13)
    users = _factors(6, CFG.k, 14)
    kw = dict(n_shards=8, n_hosts=4, replication=2)
    single = _open("sharded", items, n_shards=8)
    multi, jmulti = _open(items=items, **kw), _jopen(items=items, **kw)
    single.compact(partition=Partition.from_lengths(lengths, (8,) * 8))
    multi.compact(partition=Partition.from_lengths(lengths, (8,) * 8))
    jmulti.compact(partition=JPartition.from_lengths(lengths, (8,) * 8))
    _all_three(multi, single, jmulti, users, items, "hot-shard partition")


def test_placement_fewer_shards_than_hosts():
    pt = HostPlacement.from_partition(Partition.from_lengths((50,), (8,)),
                                      n_hosts=4, replication=2)
    assert pt.n_slices == 1 and pt.replicas == ((0, 1),)


def test_placement_routing_and_failover_order():
    pl = HostPlacement(3, 2, ((0, 1), (1, 2), (2, 3)),
                       ((0, 1), (1, 2), (2, 0)))
    jl = jc.HostPlacement(3, 2, ((0, 1), (1, 2), (2, 3)),
                          ((0, 1), (1, 2), (2, 0)))
    for down in (set(), {1}, {1, 2}):
        assert pl.route(down) == jl.route(down)
    assert pl.route() == (0, 1, 2)
    assert pl.route({1}) == (0, 2, 2)
    assert pl.route({1, 2}) == (0, None, 0)
    with pytest.raises(NoLiveReplica, match="slice 1"):
        pl.route_strict({1, 2})


def test_placement_validation():
    with pytest.raises(ValueError, match="replication"):
        HostPlacement(2, 3, ((0, 1),), ((0, 1),))
    with pytest.raises(ValueError, match="contiguous"):
        HostPlacement(2, 1, ((0, 1), (2, 3)), ((0,), (1,)))
    with pytest.raises(ValueError, match="distinct"):
        HostPlacement(2, 2, ((0, 2),), ((0, 0),))
    with pytest.raises(ValueError, match="out of range"):
        HostPlacement(2, 2, ((0, 2),), ((0, 5),))


# ------------------------------------------------------------ merge order


def test_merge_topk_realises_score_desc_row_asc_like_reference():
    neg = float(NEG)
    scores = np.array([[3.0, 1.0, neg, 3.0, 2.0, neg],
                       [2.0, 2.0, 2.0, 2.0, neg, neg]], np.float32)
    e = int(TOPK_EMPTY_ROW)
    rows = np.array([[7, 9, e, 4, 8, e], [5, 1, 3, 2, e, e]], np.int32)
    ms, mr = merge_topk(scores, rows, 4)
    js, jrows = jc.merge_topk(scores, rows, 4)
    np.testing.assert_array_equal(mr, jrows)
    np.testing.assert_array_equal(ms, js)
    np.testing.assert_array_equal(mr[0], [4, 7, 8, 9])     # ties: row asc
    np.testing.assert_array_equal(mr[1], [1, 2, 3, 5])
    # fewer columns than kappa pad with empty slots
    ps, pr = merge_topk(scores[:, :2], rows[:, :2], 4)
    jps, jpr = jc.merge_topk(scores[:, :2], rows[:, :2], 4)
    np.testing.assert_array_equal(pr, jpr)
    np.testing.assert_array_equal(ps, jps)


def test_export_topk_offsets_and_sentinels():
    vals = np.array([[1.0, NEG]], np.float32)
    rows = np.array([[2, -1]], np.int32)
    s, r = export_topk(vals, rows, offset=100)
    js_, jr_ = j_export(vals, rows, offset=100)
    assert r.dtype == np.int32
    np.testing.assert_array_equal(r, [[102, TOPK_EMPTY_ROW]])
    np.testing.assert_array_equal(r, jr_)
    np.testing.assert_array_equal(s, js_)


def test_allgather_is_the_identity_without_a_process_group():
    assert collective.process_group() == (1, None)
    s, r = collective.empty_accumulators(3, 4)
    cand = np.arange(6, dtype=np.int64).reshape(3, 2)
    tiles = np.array([1.5, 4.0], np.float32)
    out = collective.allgather_accumulators(s, r, cand, tiles)
    assert all(a is b for a, b in zip(out, (s, r, cand, tiles)))


# ------------------------------------------------------------ query parity


@pytest.mark.parametrize("n_hosts,replication",
                         [(1, 1), (2, 1), (2, 2), (3, 1), (3, 2), (3, 3),
                          (4, 2)])
def test_multihost_bit_identical_to_sharded(n_hosts, replication, catalog,
                                            users):
    kw = dict(n_hosts=n_hosts, replication=replication)
    single = _open("sharded", catalog)
    multi, jmulti = _open(items=catalog, **kw), _jopen(items=catalog, **kw)
    _all_three(multi, single, jmulti, users, catalog)
    _all_three(multi, single, jmulti, users, catalog, "exact", exact=True)


def test_cross_host_tie_break_is_id_asc():
    """Duplicate rows in DIFFERENT placement slices force exact score ties
    across the host boundary: the collective merge breaks them by catalog
    id like one host, like ``brute`` and like the reference."""
    base = _factors(60, CFG.k, 3)
    items = np.concatenate([base, base])          # ids 0..59 == 60..119
    single = _open("sharded", items)
    multi = _open(items=items, n_hosts=2, replication=1)
    jmulti = _jopen(items=items, n_hosts=2, replication=1)
    brute = _open("brute", items)
    kappa = 13                                     # odd: splits tie groups
    got = multi.query(base[:6], kappa, exact=True)
    _assert_bits(got, single.query(base[:6], kappa, exact=True))
    np.testing.assert_array_equal(
        brute.query(base[:6], kappa, exact=True).ids, got.ids)
    np.testing.assert_array_equal(
        np.asarray(jmulti.query(base[:6], kappa, exact=True).ids), got.ids)


def test_multihost_lifecycle_parity(catalog, users):
    single = _open("sharded", catalog)
    multi, jmulti = _open(items=catalog), _jopen(items=catalog)
    new = _factors(10, CFG.k, 4)
    for r in (single, multi, jmulti):
        r.upsert(np.arange(500, 510), new)
        r.delete([1, 2, 501])
    items = np.concatenate([catalog, new])
    _all_three(multi, single, jmulti, users, items, "after mutations")
    for r in (single, multi, jmulti):
        r.compact()
    _all_three(multi, single, jmulti, users, items, "after compact")


def test_multihost_mid_compaction_and_post_repartition_parity(users):
    items = _factors(260, CFG.k, 5)
    single = _open("sharded", items)
    multi, jmulti = _open(items=items), _jopen(items=items)
    up = _factors(12, CFG.k, 6)
    for r in (single, multi, jmulti):
        r.upsert(np.arange(400, 412), up)
        r.compact(async_=True)
    every = np.concatenate([items, up])
    steps = 0
    while multi.maintenance_stats()["compaction"]["active"]:
        _all_three(multi, single, jmulti, users, every,
                   f"mid-compaction step {steps}")
        steps += 1
        assert steps < 100
    for r in (single, jmulti):
        while r.maintenance_stats()["compaction"]["active"]:
            r.compaction_step()
    assert steps > 0
    _all_three(multi, single, jmulti, users, every, "after swap")
    pt = multi.repartition(async_=False)
    assert single.repartition(async_=False) == pt
    pj = jmulti.repartition(async_=False)
    assert (pt.lengths, pt.bns, pt.caps) == (pj.lengths, pj.bns, pj.caps)
    _all_three(multi, single, jmulti, users, every, "after repartition")
    _all_three(multi, single, jmulti, users, every,
               "after repartition (exact)", exact=True)


def test_explain_reports_slice_and_replica_like_reference(catalog, users):
    multi, jmulti = _open(items=catalog), _jopen(items=catalog)
    multi.mark_down(0)
    jmulti.mark_down(0)
    got = multi.query(users, 10, explain=True)
    want = jmulti.query(users, 10, explain=True)
    for key in ("shard", "slice", "replica", "source", "n_candidates",
                "shard_candidates", "blocks_skipped", "n_blocks"):
        assert got.explain[key] == want.explain[key], key
    assert set(np.ravel(got.explain["replica"])) <= {-1, 1}


# ------------------------------------------------------------ failover


def test_failover_reroutes_and_stays_exact(catalog, users):
    multi, jmulti = _open(items=catalog), _jopen(items=catalog)
    before = multi.query(users, 10)
    st, jst = multi.mark_down(0), jmulti.mark_down(0)
    assert st == jst
    assert 0 in st["down"] and all(h == 1 for h in st["routing"])
    assert multi.metrics.n_failovers >= 1
    _assert_bits(before, multi.query(users, 10), "served by replica")
    _assert_ref(multi.query(users, 10), jmulti.query(users, 10), users,
                catalog, "served by replica")
    multi.mark_up(0)
    multi.mark_down(1)
    _assert_bits(before, multi.query(users, 10), "served by primary again")


def test_failover_during_background_compaction(users):
    items = _factors(220, CFG.k, 7)
    single = _open("sharded", items)
    multi, jmulti = _open(items=items), _jopen(items=items)
    up = _factors(8, CFG.k, 8)
    for r in (single, multi, jmulti):
        r.upsert(np.arange(300, 308), up)
        r.compact(async_=True)
    multi.mark_down(0)
    jmulti.mark_down(0)
    every = np.concatenate([items, up])
    while multi.maintenance_stats()["compaction"]["active"]:
        _all_three(multi, single, jmulti, users, every,
                   "failed over, mid-compaction")
    for r in (single, jmulti):
        while r.maintenance_stats()["compaction"]["active"]:
            r.compaction_step()
    _all_three(multi, single, jmulti, users, every, "failed over, post-swap")


def test_all_replicas_down_is_a_loud_error(catalog, users):
    multi = _open(items=catalog, n_hosts=2, replication=1)
    multi.mark_down(0)
    with pytest.raises(NoLiveReplica):
        multi.query(users, 10)
    multi.mark_up(0)
    assert multi.query(users, 10).ids.shape == (len(users), 10)


def test_mark_down_is_idempotent_and_validated(catalog):
    multi = _open(items=catalog)
    multi.mark_down(0)
    n = multi.metrics.n_failovers
    multi.mark_down(0)                       # no double-count
    assert multi.metrics.n_failovers == n
    with pytest.raises(ValueError, match="out of range"):
        multi.mark_down(7)


def test_host_load_metrics_and_status_like_reference(catalog, users):
    multi, jmulti = _open(items=catalog), _jopen(items=catalog)
    multi.query(users, 10)
    jmulti.query(users, 10)
    ms, jms = multi.maintenance_stats(), jmulti.maintenance_stats()
    assert ms["hosts"] == jms["hosts"]
    assert ms["hosts"]["routing"] == [0, 1]
    load = np.asarray(ms["hosts"]["host_load"])
    assert load.shape == (2,) and load.sum() == 2 * len(users)
    snap = multi.metrics.snapshot()
    assert snap["n_failovers"] == 0 and snap["host_balance"] == 1.0


# ------------------------------------------------------------ spec guards


def test_spec_validation():
    with pytest.raises(ValueError, match="replication"):
        _open(n_hosts=2, replication=3)
    with pytest.raises(ValueError, match="n_hosts"):
        _open(n_hosts=0, replication=1)


def test_stream_from_empty_multihost(users):
    r, j = _open(), _jopen()
    assert (r.query(users, 5).ids == -1).all()
    up = _factors(8, CFG.k, 9)
    for x in (r, j):
        x.upsert(np.arange(8), up)
    got = r.query(users, 5, exact=True)
    assert (got.ids >= 0).all()
    _assert_ref(got, j.query(users, 5, exact=True), users, up)


# ------------------------------------------------------------ snapshots


def test_snapshot_v3_round_trip_and_rehosting_both_ways(tmp_path, catalog,
                                                        users):
    """A multi-host snapshot carries its placement, crosses between the
    packages both ways, and rehosts onto any host count: the placement is
    re-derived from the opening spec."""
    up = _factors(6, CFG.k, 10)
    multi, jmulti = _open(items=catalog), _jopen(items=catalog)
    for r in (multi, jmulti):
        r.upsert(np.arange(500, 506), up)
    before = multi.query(users, 10)
    every = np.concatenate([catalog, up])
    for writer in ("port", "reference"):
        path = os.fspath(tmp_path / f"mh_{writer}.npz")
        (multi if writer == "port" else jmulti).snapshot(path)
        _, header = load_arrays(path)
        state = header["state"]
        written = convert.placement_from_state(state)
        assert written == multi.base.placement
        assert written.describe() == state["placement"]
        part = state["base"]["partition"]
        part = Partition(tuple(part["lengths"]), tuple(part["bns"]),
                         tuple(part["caps"]))
        for n_hosts, repl in [(2, 2), (1, 1), (4, 2), (3, 1)]:
            kw = dict(n_hosts=n_hosts, replication=repl)
            restored = _open(snapshot=path, **kw)
            # re-derived from the opening spec, not read from the file
            assert restored.base.placement == HostPlacement.from_partition(
                part, n_hosts, repl)
            tag = f"{writer} file restored on {n_hosts} hosts"
            _assert_bits(before, restored.query(users, 10), tag)
            _assert_ref(restored.query(users, 10),
                        _jopen(snapshot=path, **kw).query(users, 10), users,
                        every, tag)


def test_sharded_snapshot_scales_out_to_multihost(tmp_path, catalog, users):
    """A single-host ``sharded`` file — the reference's or the port's —
    restores into the port's ``sharded-multihost``."""
    single, jsingle = _open("sharded", catalog), _jopen("sharded", catalog)
    before = single.query(users, 10)
    for writer, r in (("port", single), ("reference", jsingle)):
        path = os.fspath(tmp_path / f"s_{writer}.npz")
        r.snapshot(path)
        _, header = load_arrays(path)
        assert convert.placement_from_state(header["state"]) is None
        multi = _open(snapshot=path, n_hosts=2, replication=2)
        _assert_bits(before, multi.query(users, 10),
                     f"scaled out from the {writer}'s sharded file")


def test_multihost_snapshot_does_not_scale_in_silently(tmp_path, catalog):
    multi = _open(items=catalog)
    path = os.fspath(tmp_path / "mh.npz")
    multi.snapshot(path)
    with pytest.raises(ValueError, match="mismatch"):
        _open("sharded", snapshot=path)
    with pytest.raises(ValueError, match="mismatch"):
        _jopen("sharded", snapshot=path)


# ------------------------------------------------------------ map cache


def test_map_cache_only_remaps_changed_items_like_reference(catalog):
    multi, jmulti = _open(items=catalog), _jopen(items=catalog)
    for r in (multi, jmulti):
        r.repartition(async_=False)
    st = multi.maintenance_stats()["repartition"]["map_cache"]
    assert st == jmulti.maintenance_stats()["repartition"]["map_cache"]
    assert st["misses"] == len(catalog) and st["hits"] == 0
    up = _factors(2, CFG.k, 11)
    for r in (multi, jmulti):
        r.upsert([7, 9], up)
        r.compact()     # rebalanced layout: re-plans through the cache
    st = multi.maintenance_stats()["repartition"]["map_cache"]
    assert st == jmulti.maintenance_stats()["repartition"]["map_cache"]
    assert st["misses"] == len(catalog) + 2       # only the changed rows
    assert st["hits"] >= len(catalog) - 2


def test_map_cache_rows_match_full_mapping():
    from repro.core.mapping import sparse_map as jax_map

    items = _factors(37, CFG.k, 12)
    ids = np.arange(37, dtype=np.int64)
    cache = MapCache(TCFG, device="cpu")
    tau_c, mask_c = cache.lookup(ids[::2], items[::2])   # warm odd subset
    tau, mask = cache.lookup(ids, items)                 # mixed hit/miss
    t_j, v_j = jax_map(items, CFG)
    t_t, v_t = sparse_map(torch.as_tensor(items), TCFG)
    np.testing.assert_array_equal(tau, np.asarray(t_j))
    np.testing.assert_array_equal(mask, np.asarray(v_j) != 0.0)
    np.testing.assert_array_equal(tau, t_t.numpy())
    np.testing.assert_array_equal(tau_c, np.asarray(t_j)[::2])
    np.testing.assert_array_equal(mask_c, (v_t.numpy() != 0.0)[::2])
    cache.invalidate([0])
    assert len(cache) == 36
    cache.retain(ids[:5])
    assert len(cache) == 4                               # id 0 invalidated


# ------------------------------------------------ faults, breaker, hedging


def _qos_spec_kw():
    return dict(n_shards=2, min_overlap=1, kappa=8)


def _manual_clock():
    t = [0.0]
    return t, lambda: t[0]


def test_multihost_serves_around_faults_bit_identically():
    items, users = _factors(300, CFG.k, 0), _factors(8, CFG.k, 1)
    want = _open("sharded", items, **_qos_spec_kw()).query(users)

    def chaos(opener, faults, qos):
        return opener(items=items, rkw=dict(faults=faults, qos=qos),
                      **_qos_spec_kw())

    fi = FaultInjector("stall=0.4,drop=0.2,hosts=1", seed=5)
    svc = chaos(_open, fi, QosPolicy(breaker_failures=10**9))
    import repro.service.faults as jf
    import repro.service.qos as jq
    jfi = jf.FaultInjector("stall=0.4,drop=0.2,hosts=1", seed=5)
    jsvc = chaos(_jopen, jfi, jq.QosPolicy(breaker_failures=10**9))
    for i in range(25):
        got = svc.query(users)
        assert not got.degraded
        np.testing.assert_array_equal(got.ids, want.ids, err_msg=f"{i}")
        np.testing.assert_array_equal(got.scores, want.scores)
        jsvc.query(users)
    assert fi.n_stalls + fi.n_drops > 0             # chaos actually happened
    assert (fi.n_stalls, fi.n_drops) == (jfi.n_stalls, jfi.n_drops)
    assert svc.metrics.n_failovers == jsvc.metrics.n_failovers > 0


def test_breaker_auto_marks_down_and_probe_recovers():
    t, clock = _manual_clock()
    items, users = _factors(300, CFG.k, 0), _factors(8, CFG.k, 1)
    want = _open("sharded", items, **_qos_spec_kw()).query(users)
    svc = _open(items=items, rkw=dict(
        clock=clock, faults=FaultInjector("stall=1.0,hosts=1", seed=0),
        qos=QosPolicy(breaker_failures=2, breaker_probe_s=1.0)),
        **_qos_spec_kw())

    def same():
        got = svc.query(users)
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.scores, want.scores)

    same()                                          # round 1: streak 1
    same()                                          # round 2: breaker opens
    assert svc.health.is_open(1)
    assert svc.host_status()["down"] == [1]
    assert svc.metrics.snapshot()["breaker_opens"] == 1
    t[0] = 1.5                 # fault persists: the due probe fails
    same()
    assert svc.health.is_open(1)
    svc.faults = None          # fault clears: the next probe closes it
    t[0] = 10.0
    same()
    assert not svc.health.is_open(1)
    assert svc.host_status()["down"] == []
    snap = svc.metrics.snapshot()
    assert snap["breaker_closes"] == 1 and snap["breaker_probes"] == 2
    kinds = [e["kind"] for e in svc.events.tail(100)]
    assert "breaker_open" in kinds and "breaker_close" in kinds


def test_manual_mark_down_is_never_auto_probed():
    t, clock = _manual_clock()
    svc = _open(items=_factors(200, CFG.k, 4), rkw=dict(clock=clock),
                **_qos_spec_kw())
    svc.mark_down(1)
    t[0] = 1e6                                      # any amount of time
    svc.query(_factors(4, CFG.k, 5))
    assert svc.host_status()["down"] == [1]         # operator's call stands


def test_every_replica_faulted_raises_no_live_replica():
    svc = _open(items=_factors(200, CFG.k, 6), rkw=dict(
        faults=FaultInjector("stall=1.0", seed=0),
        qos=QosPolicy(breaker_failures=10**9)), **_qos_spec_kw())
    with pytest.raises(NoLiveReplica):
        svc.query(_factors(4, CFG.k, 7))


def test_hedged_reads_fire_and_stay_bit_identical():
    t, clock = _manual_clock()
    items, users = _factors(300, CFG.k, 0), _factors(8, CFG.k, 1)
    want = _open("sharded", items, **_qos_spec_kw()).query(users)
    svc = _open(items=items, rkw=dict(
        clock=clock, qos=QosPolicy(hedge_factor=2.0, hedge_min_samples=4)),
        **_qos_spec_kw())
    # manual clock: each host call costs 1 ms until the spike, whose
    # latency far past the learned p99 triggers the hedge
    spike = [False]
    real_topk = svc.base.slices_topk

    def topk(slice_ids, *a, **kw):
        t[0] += 1.0 if spike[0] else 0.001
        return real_topk(slice_ids, *a, **kw)

    svc.base.slices_topk = topk

    def same(tag):
        got = svc.query(users)
        np.testing.assert_array_equal(got.ids, want.ids, err_msg=tag)
        np.testing.assert_array_equal(got.scores, want.scores, err_msg=tag)

    for i in range(10):                             # learn the baseline p99
        same(f"warm {i}")
    assert svc.metrics.snapshot()["hedge_issued"] == 0
    spike[0] = True
    same("spike round")
    spike[0] = False
    same("after spike")
    snap = svc.metrics.snapshot()
    assert snap["hedge_issued"] > 0                 # hedges fired ...
    assert snap["hedge_issued"] >= snap["hedge_wins"]


# ------------------------------------------------------------ carved slices


def _fresh_slice(g: ShardedGamIndex, placement, sl, quantize):
    """A from-scratch build of placement slice ``sl``'s catalog under the
    slice's own partition."""
    part = g.partition
    s_lo, s_hi = placement.slices[sl]
    sub = Partition(part.lengths[s_lo:s_hi], part.bns[s_lo:s_hi],
                    part.caps[s_lo:s_hi])
    lo = part.starts[s_lo]
    ids = g.item_ids[lo:lo + sub.n]
    flat = g.flat_factors()
    rows = g.rows_of(ids)
    return ShardedGamIndex.build(flat[rows], TCFG, item_ids=ids,
                                 partition=sub, min_overlap=g.min_overlap,
                                 bucket=g.bucket, quantize=quantize,
                                 device="cpu")


def _tensors(index: ShardedGamIndex) -> dict:
    out = {"tables": index.tables, "counts": index.counts,
           "factors": torch.cat(index.factors_g),
           "alive": torch.cat(index.alive_g)}
    for g, m in enumerate(index.metas):
        for name in ("item_bits_t", "block_union", "block_spill", "spill8",
                     "factors_q", "scales"):
            if getattr(m, name) is not None:
                out[f"meta{g}.{name}"] = getattr(m, name)
    return out


@pytest.mark.parametrize("quantize", ["none", "int8"])
@pytest.mark.parametrize("skewed", [False, True])
def test_carved_slices_equal_a_fresh_build_byte_for_byte(quantize, skewed):
    """Each carved slice is contiguous, shares no storage with the global
    index, and equals a build of the slice from scratch byte for byte — on
    the uniform layout and on a heterogeneous one whose slices cut a
    bn-group."""
    items = _factors(700, CFG.k, 21)
    g = ShardedGamIndex.build(items, TCFG, n_shards=4, min_overlap=2,
                              bucket=512, quantize=quantize, device="cpu")
    if skewed:
        part = Partition.from_lengths((80, 420, 120, 80), (8, 16, 16, 8))
        g = ShardedGamIndex.build(items, TCFG, partition=part, min_overlap=2,
                                  bucket=512, quantize=quantize,
                                  device="cpu")
    placement = HostPlacement.from_partition(g.partition, 2, 1)
    whole = {t.untyped_storage().data_ptr() for t in _tensors(g).values()}
    for sl in range(placement.n_slices):
        carved = _slice_index(g, placement, sl)
        fresh = _fresh_slice(g, placement, sl, quantize)
        a, b = _tensors(carved), _tensors(fresh)
        assert a.keys() == b.keys()
        for name in a:
            assert a[name].is_contiguous(), name
            assert a[name].untyped_storage().data_ptr() not in whole, name
            assert a[name].dtype == b[name].dtype, name
            assert torch.equal(a[name], b[name]), (sl, name)
        np.testing.assert_array_equal(carved.item_ids, fresh.item_ids)
        # spill rows: the carved table keeps the global width, padded with
        # each shard's cap — the same entries
        for s in range(carved.n_shards):
            cap = carved.partition.caps[s]
            got = carved.spills[s][carved.spills[s] != cap]
            want = fresh.spills[s][fresh.spills[s] != cap]
            assert torch.equal(got, want)


def test_host_without_every_slice_holds_only_its_own_and_refuses_snapshot(
        tmp_path, catalog, users):
    """At replication 1 a host keeps only the slices it replicates: the
    global index is dropped, its device bytes are its slices', and it
    cannot snapshot (``UnsupportedOp``)."""
    multi = _open(items=catalog, n_hosts=2, replication=1)
    full = multi.base
    want = multi.query(users, 10)
    mine = MultiHostIndex.from_global(full.global_index, full.placement,
                                      local_host=0)
    assert not mine.has_all_slices and sorted(mine.slices) == [0]
    carved = mine.slices[0].device_bytes()
    assert mine.device_bytes() == carved
    total = full.global_index.device_bytes()
    assert sum(carved.values()) < sum(total.values())
    with pytest.raises(ValueError, match="not local"):
        mine.get_slice(1)
    multi.base = mine
    with pytest.raises(tr.UnsupportedOp, match="every placement slice"):
        multi.snapshot(os.fspath(tmp_path / "part.npz"))
    # the host's own slice still answers like the global index over it
    s, r, _, _ = mine.slices_topk((0,), *_mapped(users), 10, False)
    s2, r2, _, _ = full.slices_topk((0,), *_mapped(users), 10, False)
    np.testing.assert_array_equal(r, r2)
    np.testing.assert_array_equal(s, s2)
    assert want.ids.shape == (len(users), 10)


def _mapped(users):
    u = torch.as_tensor(users)
    tau, vals = sparse_map(u, TCFG)
    return u, tau, vals != 0.0


# ------------------------------------------------------ real processes


def test_procs_worker_env_keeps_the_card_and_drops_jax_variables():
    env = procs.worker_env({"CUDA_VISIBLE_DEVICES": "0", "JAX_PLATFORMS":
                            "cpu", "XLA_FLAGS": "x", "PATH": "/bin"})
    assert env == {"CUDA_VISIBLE_DEVICES": "0", "PATH": "/bin"}
    host, port = procs.free_coordinator().split(":")
    assert host == "127.0.0.1" and int(port) > 0


def test_run_workers_kills_a_straggler_as_124():
    codes, outs = procs.run_workers(
        [[sys.executable, "-c", "print('done')"],
         [sys.executable, "-c", "import time; time.sleep(60)"]],
        timeout=5.0, capture=True)
    assert codes == [0, 124]
    assert outs[0].strip() == "done"


@pytest.mark.parametrize("replication", [2, 1])
def test_two_gloo_processes_run_the_multihost_contract(replication,
                                                       monkeypatch):
    """``run_multiprocess_torch.py`` with two real processes joined by a
    gloo group: every lifecycle step bit-identical to single-host
    ``sharded``; at replication 1 each host holds one slice.  A hang is
    killed at the deadline and fails the test."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(RUNNER), "--processes", "2", "--device", "cpu",
         "--items", "400", "--replication", str(replication),
         "--timeout", "100", "--group-timeout", "60"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert "PASSED: 2-process multihost contract suite" in out.stdout
    assert "after repartition (exact): bit-identical" in out.stdout
