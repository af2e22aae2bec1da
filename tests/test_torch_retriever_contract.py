"""The cross-backend contract suite on the port, beside ``repro``'s.

Mirrors ``tests/test_retriever_contract.py`` for ``brute``, ``gam``,
``gam-device``, ``sharded`` and ``sharded-multihost`` (on the CPU), plus
the baseline cases.
Wherever the reference suite holds a backend against the reference's own
``gam``, the port's backend is also held against the reference's ``gam``
on the same inputs: ids, ``n_scored``, ``discarded_frac`` and ``explain``
exact, scores within 4 ulp of each query's dot-product scale
(``assert_scores_close``).  ``gam`` snapshots cross between the packages
in both directions, flat and compressed, with the reference's bytes.
``sharded-multihost`` runs the whole contract (the lifecycle, snapshots
in the reference's v3 placement format), and a host without every
placement slice refuses to snapshot.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from conftest import CFG, unit_factors as _factors  # noqa: E402
from test_torch_gam_retrieve import assert_scores_close  # noqa: E402

import repro.retriever as jr  # noqa: E402
from repro.configs import gam_mf  # noqa: E402
from repro_torch.core.mapping import GamConfig  # noqa: E402
from repro_torch.retriever import (BACKEND_IDS, RetrieverSpec,  # noqa: E402
                                   UnsupportedOp, available_backends,
                                   open_retriever, register_backend)

BACKENDS = ["brute", "gam", "gam-device", "sharded", "sharded-multihost"]
BASELINES = ["srp-lsh", "superbit-lsh", "cro", "pca-tree"]
TCFG = GamConfig(k=CFG.k, scheme=CFG.scheme, d=CFG.d,
                 threshold=CFG.threshold)


def _kw(backend, kw):
    kw.setdefault("min_overlap", 2)
    kw.setdefault("bucket", 512)
    if backend == "sharded":
        kw.setdefault("n_shards", 2)
    if backend == "sharded-multihost":
        kw.setdefault("n_shards", 4)
        kw.setdefault("n_hosts", 2)
        kw.setdefault("replication", 2)
    return kw


def _spec(backend, **kw):
    return RetrieverSpec(cfg=TCFG, backend=backend, **_kw(backend, kw))


def _jspec(backend, **kw):
    return jr.RetrieverSpec(cfg=CFG, backend=backend, **_kw(backend, kw))


def _open(backend, items=None, ids=None, **kw):
    return open_retriever(_spec(backend, **kw), items, ids, device="cpu")


def _assert_same(got, want, users, items, explain=False):
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.n_scored, want.n_scored)
    np.testing.assert_array_equal(got.discarded_frac, want.discarded_frac)
    real = np.isfinite(want.scores)
    np.testing.assert_array_equal(np.isfinite(got.scores), real)
    assert_scores_close(np.where(real, got.scores, 0),
                        np.where(real, want.scores, 0), users, items)
    if explain:
        assert got.explain == want.explain


# ------------------------------------------------------------ registry


def test_registry_lists_all_backends():
    assert set(BACKENDS + BASELINES) <= set(BACKEND_IDS)
    assert set(BACKEND_IDS) <= set(available_backends())


def test_unknown_backend_is_a_loud_keyerror():
    with pytest.raises(KeyError, match="unknown retriever backend"):
        open_retriever(RetrieverSpec(cfg=TCFG, backend="faiss"), device="cpu")


def test_sharded_multihost_host_without_every_slice_refuses_snapshot(
        tmp_path):
    """The contract row of a host that replicates only some placement
    slices (replication < n_hosts in a process group): it answers, and
    ``snapshot`` raises :class:`UnsupportedOp` writing nothing."""
    from repro_torch.retriever.multihost import MultiHostIndex
    items = _factors(120, CFG.k, 30)
    users = _factors(4, CFG.k, 31)
    r = _open("sharded-multihost", items, replication=1)
    want = r.query(users, 10)
    full = r.base
    r.base = MultiHostIndex.from_global(full.global_index, full.placement,
                                        local_host=1)
    assert not r.base.has_all_slices
    path = tmp_path / "partial.npz"
    with pytest.raises(UnsupportedOp, match="every placement slice"):
        r.snapshot(str(path))
    assert not path.exists()
    r.base = full
    r.snapshot(str(path))                      # every slice held: it writes
    restored = open_retriever(_spec("sharded-multihost", replication=1),
                              snapshot=str(path), device="cpu")
    got = restored.query(users, 10)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.scores, want.scores)


def test_register_backend_extends_registry():
    calls = []

    @register_backend("contract-test-null")
    def _factory(spec, device, **kw):
        calls.append(spec)
        return open_retriever(RetrieverSpec(cfg=spec.cfg, backend="brute"),
                              device=device)

    r = open_retriever(RetrieverSpec(cfg=TCFG, backend="contract-test-null"),
                       device="cpu")
    assert calls and r.spec.backend == "brute"
    assert "contract-test-null" in available_backends()


# ------------------------------------------------------------ the scenario


@pytest.mark.parametrize("backend", BACKENDS)
def test_full_lifecycle_scenario_against_brute_oracle(backend, tmp_path,
                                                      catalog, users):
    """The reference suite's scenario: after every mutation the exact-mode
    answers equal the brute oracle; the port's ``gam`` also answers as the
    reference's ``gam`` in pruned mode at each step."""
    k = CFG.k
    ids0 = np.arange(300, dtype=np.int64)
    r = _open(backend, catalog, ids0)
    oracle = _open("brute", catalog, ids0)
    ref = jr.open_retriever(_jspec("gam"), items=catalog, ids=ids0)
    live = dict(zip(ids0.tolist(), catalog))

    def check(tag):
        got = r.query(users, 10, exact=True)
        want = oracle.query(users, 10, exact=True)
        np.testing.assert_array_equal(got.ids, want.ids, err_msg=tag)
        np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5,
                                   atol=1e-6, err_msg=tag)
        if backend == "gam":
            _assert_same(r.query(users, 10, explain=True),
                         ref.query(users, 10, explain=True), users,
                         np.stack(list(live.values())), explain=True)

    check("after build")
    assert r.n_items == 300
    new_ids = np.array([500, 501, 502], np.int64)
    new_fac = _factors(3, k, 3)
    over_fac = _factors(2, k, 4)
    for x in (r, oracle, ref):
        x.upsert(new_ids, new_fac)
    live.update(zip(new_ids.tolist(), new_fac))
    check("after insert")
    assert r.n_items == 303
    for x in (r, oracle, ref):
        x.upsert([5, 500], over_fac)
    live.update(zip([5, 500], over_fac))
    check("after overwrite")
    assert r.n_items == 303
    for x in (r, oracle, ref):
        x.delete([0, 1, 2, 501, 999999])
    for i in (0, 1, 2, 501):
        del live[i]
    check("after delete (incl. unknown id)")
    assert r.n_items == 299

    pruned_before = r.query(users, 10)
    path = os.fspath(tmp_path / f"{backend}.npz")
    r.snapshot(path)
    restored = open_retriever(_spec(backend), snapshot=path, device="cpu")
    assert restored.n_items == 299
    pruned_after = restored.query(users, 10)
    np.testing.assert_array_equal(pruned_after.ids, pruned_before.ids)
    np.testing.assert_array_equal(pruned_after.scores, pruned_before.scores)

    r.compact()
    check("after compact")
    pruned_compacted = r.query(users, 10)
    np.testing.assert_array_equal(pruned_compacted.ids, pruned_before.ids)
    np.testing.assert_array_equal(pruned_compacted.scores,
                                  pruned_before.scores)


@pytest.mark.parametrize("backend", BACKENDS)
def test_background_compact_is_part_of_the_contract(backend):
    items = _factors(200, CFG.k, 22)
    users = _factors(6, CFG.k, 23)
    r = _open(backend, items)
    oracle = _open("brute", items)
    new = _factors(5, CFG.k, 24)
    r.upsert(np.arange(300, 305), new)
    oracle.upsert(np.arange(300, 305), new)
    before = r.query(users, 10)
    gen0 = r.maintenance_stats()["generation"]
    r.compact(async_=True)
    steps = 0
    while r.maintenance_stats()["compaction"]["active"]:
        got = r.query(users, 10, exact=True)
        want = oracle.query(users, 10, exact=True)
        np.testing.assert_array_equal(got.ids, want.ids)
        steps += 1
        assert steps < 100
    after = r.query(users, 10)
    np.testing.assert_array_equal(before.ids, after.ids)
    np.testing.assert_array_equal(before.scores, after.scores)
    if backend in ("sharded", "sharded-multihost"):
        assert steps > 0
        assert r.maintenance_stats()["generation"] == gen0 + 1
        assert len(r.delta) == 0


def test_maintenance_stats_surface():
    items = _factors(64, CFG.k, 25)
    for backend in BACKENDS + BASELINES:
        ms = open_retriever(_spec(backend), items=items,
                            device="cpu").maintenance_stats()
        assert ms["backend"] == backend
        assert ms["generation"] == 0
        assert ms["compaction"]["active"] is False


@pytest.mark.parametrize("backend", ["gam", "gam-device", "sharded",
                                     "sharded-multihost"])
def test_pruned_mode_matches_gam_candidate_semantics(backend):
    """All index backends share one candidate definition, so with a common
    generous bucket their pruned answers equal the reference's ``gam`` (and
    the port's)."""
    items = _factors(350, CFG.k, 7)
    users = _factors(10, CFG.k, 8)
    want = jr.open_retriever(_jspec("gam"), items=items).query(users, 10)
    mine = _open("gam", items).query(users, 10)
    got = _open(backend, items).query(users, 10)
    for res in (mine, got):
        np.testing.assert_array_equal(res.ids, want.ids)
        np.testing.assert_array_equal(res.n_scored, want.n_scored)
        assert_scores_close(res.scores, want.scores, users, items)
    if backend in ("sharded", "sharded-multihost"):
        dev = _open("gam-device", items).query(users, 10)
        np.testing.assert_array_equal(got.ids, dev.ids)
        np.testing.assert_array_equal(got.scores, dev.scores)


@pytest.mark.parametrize("backend", BACKENDS)
def test_score_ties_break_identically_across_backends(backend):
    base = _factors(40, CFG.k, 21)
    items = np.concatenate([base, base, base[:8]])     # many exact ties
    users = base[:6]
    ids = np.arange(items.shape[0], dtype=np.int64)
    got = _open(backend, items, ids).query(users, 12, exact=True)
    want = _open("brute", items, ids).query(users, 12, exact=True)
    np.testing.assert_array_equal(got.ids, want.ids)
    if backend == "gam":
        # pruned: the port's total order on the tied candidates
        pruned = _open("gam", items, ids).query(users, 12)
        for qi in range(6):
            s, i = pruned.scores[qi], pruned.ids[qi]
            real = i >= 0
            order = np.lexsort((i[real], -s[real]))
            np.testing.assert_array_equal(order, np.arange(real.sum()))


@pytest.mark.parametrize("backend", BACKENDS)
def test_stream_from_empty(backend):
    users = _factors(4, CFG.k, 9)
    r = _open(backend)
    res = r.query(users, 5)
    assert (res.ids == -1).all() and np.isneginf(res.scores).all()
    r.upsert(np.arange(6), _factors(6, CFG.k, 10))
    assert r.n_items == 6
    res = r.query(users, 5, exact=True)
    assert (res.ids >= 0).all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_query_default_kappa_comes_from_spec(backend):
    items = _factors(64, CFG.k, 11)
    r = _open(backend, items, kappa=7)
    assert r.query(_factors(3, CFG.k, 12)).ids.shape == (3, 7)


def test_stats_surface(make_factors):
    items = make_factors(128, CFG.k, 13)
    for backend in BACKENDS:
        st = _open(backend, items).stats()
        assert st["backend"] == backend and st["n_items"] == 128


# ------------------------------------------------------------ UnsupportedOp


@pytest.mark.parametrize("backend", BASELINES)
def test_baseline_backends_are_query_only(backend, tmp_path):
    items = _factors(150, CFG.k, 14)
    users = _factors(5, CFG.k, 15)
    r = open_retriever(RetrieverSpec(cfg=TCFG, backend=backend), items=items,
                       device="cpu")
    res = r.query(users, 10)
    assert res.ids.shape == (5, 10)
    exact = r.query(users, 10, exact=True)
    assert (exact.ids >= 0).all()
    brute = _open("brute", items).query(users, 10, exact=True)
    np.testing.assert_array_equal(exact.ids, brute.ids)
    np.testing.assert_array_equal(exact.scores, brute.scores)
    for op in (lambda: r.upsert([0], items[:1]),
               lambda: r.delete([0]),
               lambda: r.compact(),
               lambda: r.snapshot(os.fspath(tmp_path / "never.npz")),
               lambda: r.candidate_masks(users)):
        with pytest.raises(UnsupportedOp):
            op()
    assert not (tmp_path / "never.npz").exists()


def test_candidate_masks_support_matrix():
    items = _factors(100, CFG.k, 16)
    users = _factors(3, CFG.k, 17)
    masks = _open("gam-device", items).candidate_masks(users)
    assert masks.shape == (3, 100) and masks.dtype == torch.bool
    for backend in ["brute", "gam", "sharded", "sharded-multihost"]:
        with pytest.raises(UnsupportedOp):
            _open(backend, items).candidate_masks(users)


# ------------------------------------------------------------ explain


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("exact", [False, True])
def test_explain_is_pure_observation(backend, exact):
    items = _factors(250, CFG.k, 40)
    users = _factors(6, CFG.k, 41)
    r = _open(backend, items)
    r.upsert(np.arange(300, 308), _factors(8, CFG.k, 42))
    plain = r.query(users, 10, exact=exact)
    explained = r.query(users, 10, exact=exact, explain=True)
    np.testing.assert_array_equal(plain.ids, explained.ids)
    np.testing.assert_array_equal(plain.scores, explained.scores)
    np.testing.assert_array_equal(plain.n_scored, explained.n_scored)
    np.testing.assert_array_equal(plain.discarded_frac,
                                  explained.discarded_frac)
    assert plain.explain is None
    exp = explained.explain
    assert exp is not None and exp["backend"] == backend
    assert len(exp["n_candidates"]) == 6
    again = r.query(users, 10, exact=exact)
    np.testing.assert_array_equal(plain.ids, again.ids)
    np.testing.assert_array_equal(plain.scores, again.scores)
    if backend in ("gam", "sharded-multihost"):
        ref = jr.open_retriever(_jspec(backend), items=items)
        ref.upsert(np.arange(300, 308), _factors(8, CFG.k, 42))
        want = ref.query(users, 10, exact=exact, explain=True)
        assert explained.explain == want.explain
        np.testing.assert_array_equal(explained.ids, want.ids)


def test_explain_backend_schemas():
    items = _factors(300, CFG.k, 43)
    users = _factors(5, CFG.k, 44)
    q, kappa = 5, 10
    exp = _open("brute", items).query(users, kappa, explain=True).explain
    assert exp["shard_candidates"] == [[300]] * q
    assert exp["n_candidates"] == [300] * q
    exp = _open("gam", items).query(users, kappa, explain=True).explain
    assert set(exp) == {"backend", "n_candidates"}
    assert all(0 < c < 300 for c in exp["n_candidates"])
    exp = _open("gam-device", items).query(users, kappa, explain=True).explain
    assert len(exp["block_candidates"]) == q
    assert all(0 <= s <= exp["n_blocks"] for s in exp["blocks_skipped"])
    r = _open("sharded", items)
    r.upsert(np.arange(400, 410), _factors(10, CFG.k, 45))
    res = r.query(users, kappa, explain=True)
    exp = res.explain
    assert np.asarray(exp["shard_candidates"]).shape == (q, 2)
    src = np.asarray(exp["source"], object)
    from_delta = res.ids >= 400
    assert (src[from_delta] == "delta").all()
    assert (src[(res.ids >= 0) & ~from_delta] == "base").all()

    r = _open("sharded-multihost", items)
    exp = r.query(users, kappa, explain=True).explain
    sl, rep = np.asarray(exp["slice"]), np.asarray(exp["replica"])
    assert sl.shape == rep.shape == (q, kappa)
    assert (sl >= 0).all() and (rep >= 0).all()       # no delta, no failover
    assert sl.max() < r.base.placement.n_slices


@pytest.mark.parametrize("backend", BASELINES)
def test_baseline_backends_cannot_explain(backend):
    items = _factors(120, CFG.k, 48)
    users = _factors(3, CFG.k, 49)
    r = open_retriever(RetrieverSpec(cfg=TCFG, backend=backend), items=items,
                       device="cpu")
    with pytest.raises(UnsupportedOp, match="explain|provenance"):
        r.query(users, 10, explain=True)


# ------------------------------------------------------------ the gam backend


SCHEMAS = {"gam_mf": (gam_mf.GAM, gam_mf.MIN_OVERLAP), "cfg": (CFG, 2)}
SETTINGS = {"flat": {}, "varint": {"compress_postings": True},
            "int8": {"quantize": "int8"},
            "int8+varint": {"quantize": "int8", "compress_postings": True}}


def _schema_specs(schema, **kw):
    jcfg, mo = SCHEMAS[schema]
    tcfg = GamConfig(k=jcfg.k, scheme=jcfg.scheme, d=jcfg.d,
                     threshold=jcfg.threshold)
    return (jr.RetrieverSpec(cfg=jcfg, backend="gam", min_overlap=mo, **kw),
            RetrieverSpec(cfg=tcfg, backend="gam", min_overlap=mo, **kw))


def _schema_data(schema):
    k = SCHEMAS[schema][0].k
    return _factors(1500, k, 60 + k), _factors(40, k, 61 + k)


@pytest.mark.parametrize("schema", sorted(SCHEMAS))
@pytest.mark.parametrize("settings", sorted(SETTINGS))
def test_gam_matches_reference_end_to_end(schema, settings):
    items, users = _schema_data(schema)
    jspec, tspec = _schema_specs(schema, **SETTINGS[settings])
    want = jr.open_retriever(jspec, items=items)
    got = open_retriever(tspec, items=items, device="cpu")
    np.testing.assert_array_equal(got.item_tau, want.item_tau)
    np.testing.assert_array_equal(got.item_mask, want.item_mask)
    for exact in (False, True):
        for kappa in (1, 10, 2000):
            _assert_same(got.query(users, kappa, explain=True, exact=exact),
                         want.query(users, kappa, explain=True, exact=exact),
                         users, items, explain=True)
    assert got.stats() == want.stats()
    q_tau, q_mask = got.map_queries(users)
    np.testing.assert_array_equal(q_tau, want.map_queries(users)[0])
    np.testing.assert_array_equal(q_mask, want.map_queries(users)[1])


def test_gam_compressed_answers_equal_flat_bit_for_bit():
    items, users = _schema_data("gam_mf")
    _, flat = _schema_specs("gam_mf")
    _, comp = _schema_specs("gam_mf", compress_postings=True)
    a = open_retriever(flat, items=items, device="cpu")
    b = open_retriever(comp, items=items, device="cpu")
    ra, rb = a.query(users, explain=True), b.query(users, explain=True)
    for f in ("ids", "scores", "n_scored", "discarded_frac"):
        np.testing.assert_array_equal(getattr(ra, f), getattr(rb, f))
    assert ra.explain == rb.explain
    st = b.stats()
    assert st["index_bytes"] < a.index.nbytes
    assert st["n_patterns"] == b.index.n_patterns <= len(items)
    assert "index_bytes" not in a.stats()


def test_gam_mutations_match_reference():
    items, users = _schema_data("cfg")
    ids = np.arange(len(items), dtype=np.int64) * 3 + 7
    for settings in ("flat", "varint"):
        jspec, tspec = _schema_specs("cfg", **SETTINGS[settings])
        want = jr.open_retriever(jspec, items=items, ids=ids)
        got = open_retriever(tspec, items=items, ids=ids, device="cpu")
        new = _factors(40, 16, 99)
        for r in (want, got):
            r.upsert(np.concatenate([ids[:20], [1, 2, 1] + [5] * 17]), new)
            r.delete(ids[100:300])
            r.compact()
        assert got.n_items == want.n_items
        _assert_same(got.query(users, 7, explain=True),
                     want.query(users, 7, explain=True), users,
                     np.concatenate([items, new]), explain=True)


@pytest.mark.parametrize("settings", ["flat", "varint"])
@pytest.mark.parametrize("whiten", [False, True])
def test_gam_snapshots_cross_between_packages(tmp_path, settings, whiten):
    from repro_torch.checkpoint import load_arrays
    items, users = _schema_data("gam_mf")
    jspec, tspec = _schema_specs("gam_mf", whiten=whiten,
                                 **SETTINGS[settings])
    j_built = jr.open_retriever(jspec, items=items)
    t_built = open_retriever(tspec, items=items, device="cpu")
    want = j_built.query(users, explain=True)
    mine = t_built.query(users, explain=True)
    _assert_same(mine, want, users, items, explain=True)
    j_built.snapshot(str(tmp_path / "ref.npz"))
    t_built.snapshot(str(tmp_path / "port.npz"))
    ref_arrays, ref_header = load_arrays(str(tmp_path / "ref.npz"))
    port_arrays, port_header = load_arrays(str(tmp_path / "port.npz"))
    assert set(port_arrays) == set(ref_arrays)
    assert ("sp_data" in port_arrays) == (settings == "varint")
    assert ("postings" in port_arrays) == (settings == "flat")
    for name, arr in ref_arrays.items():
        np.testing.assert_array_equal(port_arrays[name], arr, err_msg=name)
        assert port_arrays[name].dtype == arr.dtype, name
    assert port_header == ref_header
    got = open_retriever(tspec, snapshot=str(tmp_path / "ref.npz"),
                         device="cpu").query(users, explain=True)
    back = jr.open_retriever(jspec, snapshot=str(tmp_path / "port.npz")
                             ).query(users, explain=True)
    again = open_retriever(tspec, snapshot=str(tmp_path / "port.npz"),
                           device="cpu")
    for a, b in ((got, mine), (back, want), (again.query(users, explain=True),
                                             mine)):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)
        assert a.explain == b.explain
    if settings == "varint":
        assert again.stats()["index_bytes"] == t_built.stats()["index_bytes"]


def test_gam_empty_snapshot_round_trips(tmp_path):
    path = str(tmp_path / "empty.npz")
    _open("gam").snapshot(path)
    r = open_retriever(_spec("gam"), snapshot=path, device="cpu")
    assert r.n_items == 0
    jr.open_retriever(_jspec("gam"), snapshot=path)


# ------------------------------------------------------------ snapshot guards


def test_restore_rejects_mismatched_spec(tmp_path):
    items = _factors(80, CFG.k, 18)
    path = os.fspath(tmp_path / "snap.npz")
    _open("gam", items).snapshot(path)
    with pytest.raises(ValueError, match="snapshot/spec mismatch"):
        open_retriever(_spec("gam", min_overlap=3), snapshot=path,
                       device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        open_retriever(RetrieverSpec(cfg=GamConfig(k=16, threshold=0.4),
                                     backend="gam", min_overlap=2,
                                     bucket=512), snapshot=path, device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        open_retriever(_spec("gam-device"), snapshot=path, device="cpu")


def test_open_retriever_rejects_items_plus_snapshot(tmp_path):
    items = _factors(10, CFG.k, 19)
    path = os.fspath(tmp_path / "s.npz")
    _open("gam", items).snapshot(path)
    with pytest.raises(ValueError, match="either items or snapshot"):
        open_retriever(_spec("gam"), items=items, snapshot=path, device="cpu")


def test_duplicate_ids_rejected_on_build():
    items = _factors(4, CFG.k, 20)
    for backend in BACKENDS + BASELINES:
        with pytest.raises(ValueError, match="unique"):
            open_retriever(RetrieverSpec(cfg=TCFG, backend=backend), items,
                           np.array([0, 1, 1, 2]), device="cpu")
