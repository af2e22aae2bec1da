"""The port's ``gam-device`` and ``brute`` backends against ``repro``'s, end to
end on the CPU: answers, explain, mutations, snapshots in both directions,
and the settings this slice does not serve.

ids, ``n_scored``, ``discarded_frac`` and every ``explain`` field match
exactly; scores within 4 ulp of the dot-product scale (see
``test_torch_gam_retrieve``).
"""
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


def test_unsupported_settings_raise_typed_errors(tmp_path):
    _, tspec = _specs("cfg")
    cfg = tspec.cfg
    for bad in (dict(quantize="int8"), dict(compress_postings=True)):
        with pytest.raises(tr.UnsupportedOp, match="later|slice"):
            tr.open_retriever(tr.RetrieverSpec(cfg=cfg, backend="gam-device",
                                               **bad), device="cpu")
    with pytest.raises(tr.UnsupportedOp, match="slice"):
        tr.open_retriever(tr.RetrieverSpec(cfg=cfg, backend="gam"),
                          device="cpu")
    for name in ("sharded", "sharded-multihost", "srp-lsh", "pca-tree"):
        with pytest.raises(KeyError, match="slice"):
            tr.open_retriever(tr.RetrieverSpec(cfg=cfg, backend=name),
                              device="cpu")
    with pytest.raises(KeyError, match="unknown"):
        tr.open_retriever(tr.RetrieverSpec(cfg=cfg, backend="nope"),
                          device="cpu")
    brute = tr.open_retriever(tr.RetrieverSpec(cfg=cfg, backend="brute"),
                              items=unit_factors(10, 16, 0), device="cpu")
    with pytest.raises(tr.UnsupportedOp):
        brute.candidate_masks(unit_factors(2, 16, 1))
    # a reference file with varint-compressed postings restores in a later slice
    items, _ = _data("cfg")
    jspec, _ = _specs("cfg", compress_postings=True)
    jr.open_retriever(jspec, items=items).snapshot(str(tmp_path / "c.npz"))
    with pytest.raises(tr.UnsupportedOp, match="slice"):
        tr.open_retriever(tspec, snapshot=str(tmp_path / "c.npz"),
                          device="cpu")
    with pytest.raises(ValueError, match="either"):
        tr.open_retriever(tspec, items=items, snapshot="x", device="cpu")
