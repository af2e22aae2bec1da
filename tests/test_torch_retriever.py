"""The port's ``gam-device`` and ``brute`` backends against ``repro``'s, end to
end on the CPU: answers, explain, mutations, snapshots in both directions,
the compressed catalog (int8 slab + exact re-rank, varint posting storage),
and the settings the port refuses with a typed error.

ids, ``n_scored``, ``discarded_frac`` and every ``explain`` field match
exactly; scores within 4 ulp of the dot-product scale (see
``test_torch_gam_retrieve``).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from conftest import CFG, unit_factors  # noqa: E402
from test_torch_gam_retrieve import assert_scores_close  # noqa: E402

import repro.retriever as jr  # noqa: E402
import repro_torch.retriever as tr  # noqa: E402
from repro.configs import gam_mf  # noqa: E402
from repro_torch.core.mapping import GamConfig  # noqa: E402
from repro_torch.retriever.multihost import MultiHostIndex  # noqa: E402

N_ITEMS, N_QUERIES = 2048, 64

SCHEMAS = {"gam_mf": (gam_mf.GAM, gam_mf.MIN_OVERLAP), "cfg": (CFG, 2)}


def _specs(schema, backend="gam-device", **kw):
    jcfg, mo = SCHEMAS[schema]
    tcfg = GamConfig(k=jcfg.k, scheme=jcfg.scheme, d=jcfg.d,
                     threshold=jcfg.threshold)
    return (jr.RetrieverSpec(cfg=jcfg, backend=backend, min_overlap=mo, **kw),
            tr.RetrieverSpec(cfg=tcfg, backend=backend, min_overlap=mo, **kw))


def _data(schema):
    k = SCHEMAS[schema][0].k
    return unit_factors(N_ITEMS, k, 50 + k), unit_factors(N_QUERIES, k, 51 + k)


def _assert_same_answer(got, want, users, items, explain=False):
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.n_scored, want.n_scored)
    np.testing.assert_array_equal(got.discarded_frac, want.discarded_frac)
    real = np.isfinite(want.scores)
    np.testing.assert_array_equal(np.isfinite(got.scores), real)
    assert_scores_close(np.where(real, got.scores, 0),
                        np.where(real, want.scores, 0), users, items)
    if explain:
        assert got.explain == want.explain


@pytest.mark.parametrize("schema", ["gam_mf", "cfg"])
@pytest.mark.parametrize("bucket", [256, 4096])
def test_gam_device_matches_reference_end_to_end(schema, bucket):
    items, users = _data(schema)
    jspec, tspec = _specs(schema, bucket=bucket)
    want = jr.open_retriever(jspec, items=items)
    got = tr.open_retriever(tspec, items=items, device="cpu")
    np.testing.assert_array_equal(got.item_tau, want.item_tau)
    np.testing.assert_array_equal(got.item_mask, want.item_mask)
    for exact in (False, True):
        _assert_same_answer(got.query(users, explain=True, exact=exact),
                            want.query(users, explain=True, exact=exact),
                            users, items, explain=True)
    # explain never changes the answer
    np.testing.assert_array_equal(got.query(users).ids,
                                  got.query(users, explain=True).ids)
    ref_stats = want.stats()
    assert {k: ref_stats[k] for k in got.stats()} == got.stats()
    q_tau, q_mask = got.map_queries(users)
    np.testing.assert_array_equal(q_tau, want.map_queries(users)[0])
    np.testing.assert_array_equal(q_mask, want.map_queries(users)[1])
    np.testing.assert_array_equal(
        got.candidate_masks(users).numpy(),
        np.asarray(want.candidate_masks(users)))


@pytest.mark.parametrize("schema", ["gam_mf", "cfg"])
def test_brute_matches_reference_and_exact_path(schema):
    items, users = _data(schema)
    jspec, tspec = _specs(schema, backend="brute")
    want = jr.open_retriever(jspec, items=items).query(users, explain=True)
    got = tr.open_retriever(tspec, items=items, device="cpu").query(
        users, explain=True)
    _assert_same_answer(got, want, users, items, explain=True)
    _, gspec = _specs(schema)
    exact = tr.open_retriever(gspec, items=items, device="cpu").query(
        users, exact=True)
    np.testing.assert_array_equal(exact.ids, got.ids)


@pytest.mark.parametrize("backend", ["gam-device", "brute"])
def test_mutations_match_reference(backend):
    items, users = _data("cfg")
    ids = np.arange(N_ITEMS, dtype=np.int64) * 3 + 7
    jspec, tspec = _specs("cfg", backend=backend, bucket=1024)
    want = jr.open_retriever(jspec, items=items, ids=ids)
    got = tr.open_retriever(tspec, items=items, ids=ids, device="cpu")
    new = unit_factors(40, 16, 99)
    new_ids = np.concatenate([ids[:20], [1, 2, 1] + [5] * 17])
    for r in (want, got):
        r.upsert(new_ids, new)
        r.delete(ids[100:300])
        r.compact()
    assert got.n_items == want.n_items
    _assert_same_answer(got.query(users, 7), want.query(users, 7), users,
                        np.concatenate([items, new]))


def test_empty_catalog_answers_empty():
    _, tspec = _specs("cfg")
    res = tr.open_retriever(tspec, device="cpu").query(
        unit_factors(3, 16, 1), explain=True)
    assert (res.ids == -1).all() and np.isneginf(res.scores).all()
    assert res.explain == {"backend": "gam-device", "n_candidates": [0] * 3}


@pytest.mark.parametrize("backend", ["gam-device", "brute"])
@pytest.mark.parametrize("whiten", [False, True])
def test_snapshots_cross_between_packages(tmp_path, backend, whiten):
    items, users = _data("gam_mf")
    jspec, tspec = _specs("gam_mf", backend=backend, whiten=whiten)
    j_built = jr.open_retriever(jspec, items=items)
    t_built = tr.open_retriever(tspec, items=items, device="cpu")
    want = j_built.query(users, explain=backend == "gam-device")
    mine = t_built.query(users, explain=backend == "gam-device")
    # repro writes -> the port restores with identical answers
    j_built.snapshot(str(tmp_path / "ref.npz"))
    t_restored = tr.open_retriever(tspec, snapshot=str(tmp_path / "ref.npz"),
                                   device="cpu")
    got = t_restored.query(users, explain=backend == "gam-device")
    np.testing.assert_array_equal(got.ids, mine.ids)
    np.testing.assert_array_equal(got.scores, mine.scores)
    assert got.explain == mine.explain
    # the port writes -> repro restores with identical answers
    t_built.snapshot(str(tmp_path / "port.npz"))
    j_restored = jr.open_retriever(jspec, snapshot=str(tmp_path / "port.npz"))
    back = j_restored.query(users, explain=backend == "gam-device")
    np.testing.assert_array_equal(back.ids, want.ids)
    np.testing.assert_array_equal(back.scores, want.scores)
    assert back.explain == want.explain
    # and the port's own round trip is bit-identical
    again = tr.open_retriever(tspec, snapshot=str(tmp_path / "port.npz"),
                              device="cpu").query(
        users, explain=backend == "gam-device")
    np.testing.assert_array_equal(again.ids, mine.ids)
    np.testing.assert_array_equal(again.scores, mine.scores)


def test_snapshot_spec_mismatch_is_rejected(tmp_path):
    items, _ = _data("gam_mf")
    jspec, tspec = _specs("gam_mf")
    jr.open_retriever(jspec, items=items).snapshot(str(tmp_path / "a.npz"))
    other = tr.RetrieverSpec(cfg=tspec.cfg, backend="gam-device",
                             min_overlap=tspec.min_overlap + 1)
    with pytest.raises(ValueError, match="mismatch"):
        tr.open_retriever(other, snapshot=str(tmp_path / "a.npz"),
                          device="cpu")
    wrong_cfg = tr.RetrieverSpec(cfg=GamConfig(k=10), backend="gam-device",
                                 min_overlap=tspec.min_overlap)
    with pytest.raises(ValueError, match="schema"):
        tr.open_retriever(wrong_cfg, snapshot=str(tmp_path / "a.npz"),
                          device="cpu")
    brute = tr.RetrieverSpec(cfg=tspec.cfg, backend="brute",
                             min_overlap=tspec.min_overlap)
    with pytest.raises(ValueError, match="mismatch"):
        tr.open_retriever(brute, snapshot=str(tmp_path / "a.npz"),
                          device="cpu")


@pytest.mark.parametrize("fmt,readable", [("repro.retriever/v2", True),
                                          ("repro.retriever/v3", True),
                                          ("repro.retriever/v1", False)])
def test_older_snapshot_formats_read_as_the_reference_reads_them(
        tmp_path, fmt, readable):
    """v2/v3 headers predate quantize/rerank_factor and read with their
    defaults in both packages; v1 is refused by both."""
    from repro_torch.checkpoint import load_arrays, save_arrays
    items, users = _data("cfg")
    jspec, tspec = _specs("cfg")
    path = str(tmp_path / "old.npz")
    tr.open_retriever(tspec, items=items, device="cpu").snapshot(path)
    arrays, header = load_arrays(path)
    header["format"] = fmt
    for field in ("quantize", "rerank_factor"):
        del header["spec"][field]
    save_arrays(path, arrays, header)
    if not readable:
        for mod, spec, kw in ((tr, tspec, {"device": "cpu"}), (jr, jspec, {})):
            with pytest.raises(ValueError, match="not a readable"):
                mod.open_retriever(spec, snapshot=path, **kw)
        return
    got = tr.open_retriever(tspec, snapshot=path, device="cpu").query(users)
    want = jr.open_retriever(jspec, snapshot=path).query(users)
    _assert_same_answer(got, want, users, items)


def test_unsupported_settings_raise_typed_errors():
    _, tspec = _specs("cfg")
    cfg = tspec.cfg
    # a multi-host host that does not replicate every placement slice
    # cannot snapshot
    multi = tr.open_retriever(
        tr.RetrieverSpec(cfg=cfg, backend="sharded-multihost", n_shards=2,
                         n_hosts=2, replication=1, min_overlap=2),
        items=unit_factors(40, 16, 0), device="cpu")
    multi.base = MultiHostIndex.from_global(
        multi.base.global_index, multi.base.placement, local_host=0)
    with pytest.raises(tr.UnsupportedOp, match="every placement slice"):
        multi.snapshot(os.devnull)
    # the CSR index and the baselines hold no dense masks or provenance
    gam = tr.open_retriever(tr.RetrieverSpec(cfg=cfg, backend="gam"),
                            items=unit_factors(10, 16, 0), device="cpu")
    with pytest.raises(tr.UnsupportedOp):
        gam.candidate_masks(unit_factors(2, 16, 1))
    lsh = tr.open_retriever(tr.RetrieverSpec(cfg=cfg, backend="srp-lsh"),
                            items=unit_factors(10, 16, 0), device="cpu")
    with pytest.raises(tr.UnsupportedOp, match="explain|provenance"):
        lsh.query(unit_factors(2, 16, 1), explain=True)
    # a mesh must be a DeviceMesh: anything else says what is expected
    with pytest.raises(TypeError, match="DeviceMesh"):
        tr.open_retriever(tr.RetrieverSpec(cfg=cfg, backend="sharded"),
                          device="cpu", mesh=object())
    with pytest.raises(KeyError, match="unknown"):
        tr.open_retriever(tr.RetrieverSpec(cfg=cfg, backend="nope"),
                          device="cpu")
    brute = tr.open_retriever(tr.RetrieverSpec(cfg=cfg, backend="brute"),
                              items=unit_factors(10, 16, 0), device="cpu")
    with pytest.raises(tr.UnsupportedOp):
        brute.candidate_masks(unit_factors(2, 16, 1))
    items, _ = _data("cfg")
    with pytest.raises(ValueError, match="either"):
        tr.open_retriever(tspec, items=items, snapshot="x", device="cpu")


# ------------------------------------------------- the compressed catalog

COMPRESSED = dict(quantize="int8", compress_postings=True)


@pytest.mark.parametrize("schema", ["gam_mf", "cfg"])
@pytest.mark.parametrize("rerank_factor", [1, 2, 4])
def test_int8_gam_device_matches_reference_end_to_end(schema, rerank_factor):
    items, users = _data(schema)
    jspec, tspec = _specs(schema, rerank_factor=rerank_factor, **COMPRESSED)
    want = jr.open_retriever(jspec, items=items)
    got = tr.open_retriever(tspec, items=items, device="cpu")
    jm, tm = want._retrieve_meta, got._retrieve_meta
    np.testing.assert_array_equal(tm.factors_q.numpy(),
                                  np.asarray(jm.factors_q))
    np.testing.assert_array_equal(tm.scales.numpy(), np.asarray(jm.scales))
    for exact in (False, True):
        _assert_same_answer(got.query(users, explain=True, exact=exact),
                            want.query(users, explain=True, exact=exact),
                            users, items, explain=True)
    ref_stats = want.stats()
    assert {k: ref_stats[k] for k in got.stats()} == got.stats()
    assert got.stats()["factor_bytes"] == tm.n_pad * tm.factors_q.shape[1] \
        + 4 * tm.n_blocks


def test_int8_answers_equal_the_f32_path_where_the_pool_covers_it():
    """The re-rank makes the int8 path exact: with a pool as wide as the
    catalog it serves the f32 path's answer bit for bit."""
    items, users = _data("cfg")
    _, f32 = _specs("cfg")
    _, int8 = _specs("cfg", quantize="int8", rerank_factor=N_ITEMS)
    a = tr.open_retriever(f32, items=items, device="cpu").query(users, 10)
    b = tr.open_retriever(int8, items=items, device="cpu").query(users, 10)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)
    np.testing.assert_array_equal(a.n_scored, b.n_scored)


@pytest.mark.parametrize("settings", [
    dict(quantize="int8", compress_postings=True),
    dict(compress_postings=True),
    dict(quantize="int8"),
], ids=["int8+varint", "varint", "int8"])
def test_compressed_snapshots_cross_between_packages(tmp_path, settings):
    from repro_torch.checkpoint import load_arrays
    items, users = _data("gam_mf")
    jspec, tspec = _specs("gam_mf", whiten=True, **settings)
    j_built = jr.open_retriever(jspec, items=items)
    t_built = tr.open_retriever(tspec, items=items, device="cpu")
    want = j_built.query(users, explain=True)
    mine = t_built.query(users, explain=True)
    _assert_same_answer(mine, want, users, items, explain=True)
    j_built.snapshot(str(tmp_path / "ref.npz"))
    t_built.snapshot(str(tmp_path / "port.npz"))
    ref_arrays, ref_header = load_arrays(str(tmp_path / "ref.npz"))
    port_arrays, port_header = load_arrays(str(tmp_path / "port.npz"))
    assert set(port_arrays) == set(ref_arrays)
    assert ("table_data" in port_arrays) == settings.get("compress_postings",
                                                         False)
    assert ("table" in port_arrays) != ("table_data" in port_arrays)
    assert ("factors_q" in port_arrays) == ("quantize" in settings)
    for name, arr in ref_arrays.items():
        np.testing.assert_array_equal(port_arrays[name], arr, err_msg=name)
        assert port_arrays[name].dtype == arr.dtype, name
    assert port_header == ref_header
    # repro writes -> the port restores; the port writes -> repro restores
    got = tr.open_retriever(tspec, snapshot=str(tmp_path / "ref.npz"),
                            device="cpu").query(users, explain=True)
    back = jr.open_retriever(jspec, snapshot=str(tmp_path / "port.npz")
                             ).query(users, explain=True)
    again = tr.open_retriever(tspec, snapshot=str(tmp_path / "port.npz"),
                              device="cpu").query(users, explain=True)
    for a, b in ((got, mine), (back, want), (again, mine)):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.scores, b.scores)
        assert a.explain == b.explain


def test_int8_file_without_slab_is_requantized_as_reference(tmp_path):
    """A file whose meta says int8 but holds no slab (written before slabs
    were persisted) is re-quantized from its items by both packages."""
    from repro_torch.checkpoint import load_arrays, save_arrays
    items, users = _data("cfg")
    jspec, tspec = _specs("cfg", quantize="int8")
    path = str(tmp_path / "old.npz")
    built = tr.open_retriever(tspec, items=items, device="cpu")
    mine = built.query(users)
    built.snapshot(path)
    arrays, header = load_arrays(path)
    del arrays["factors_q"], arrays["scales"]
    save_arrays(path, arrays, header)
    got = tr.open_retriever(tspec, snapshot=path, device="cpu")
    want = jr.open_retriever(jspec, snapshot=path)
    np.testing.assert_array_equal(got._retrieve_meta.factors_q.numpy(),
                                  np.asarray(want._retrieve_meta.factors_q))
    np.testing.assert_array_equal(got.query(users).ids, mine.ids)
    _assert_same_answer(got.query(users), want.query(users), users, items)


@pytest.mark.parametrize("saved,opened", [("int8", "none"), ("none", "int8")])
def test_quantize_mismatch_is_refused(tmp_path, saved, opened):
    items, _ = _data("cfg")
    jspec, _ = _specs("cfg", quantize=saved)
    _, tspec = _specs("cfg", quantize=opened)
    path = str(tmp_path / "q.npz")
    jr.open_retriever(jspec, items=items).snapshot(path)
    with pytest.raises(ValueError, match="quantize"):
        tr.open_retriever(tspec, snapshot=path, device="cpu")


def test_int8_mutations_match_reference():
    items, users = _data("cfg")
    ids = np.arange(N_ITEMS, dtype=np.int64) * 3 + 7
    jspec, tspec = _specs("cfg", bucket=1024, **COMPRESSED)
    want = jr.open_retriever(jspec, items=items, ids=ids)
    got = tr.open_retriever(tspec, items=items, ids=ids, device="cpu")
    new = unit_factors(40, 16, 98)
    for r in (want, got):
        r.upsert(np.concatenate([ids[:20], np.arange(1, 21)]), new)
        r.delete(ids[100:300])
    _assert_same_answer(got.query(users, 7, explain=True),
                        want.query(users, 7, explain=True), users,
                        np.concatenate([items, new]), explain=True)
