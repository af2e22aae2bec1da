"""The port's learning-loop support modules against ``repro``'s, on the CPU:
the optimizers, the seeded generators, the event batches, the metric
exporters, the deprecated shims and the load generator.

Bit-exact: every numpy generator (``synthetic_ratings``,
``movielens_like_ratings``, ``TokenPipeline``, ``DriftSimulator``,
``LoadGenerator``), the JSONL files, the Prometheus text and the shims'
answers (ids and scores of the same backend on the same catalog).  The
optimizers run f32 tensor arithmetic that XLA may fuse differently:
AdamW's params and moments within rtol 1e-6 / atol 1e-7 after several
steps, the schedule and the global norm within rtol 1e-6.
"""
import dataclasses
import json
import pickle
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from conftest import CFG, unit_factors  # noqa: E402

import repro.data as jd  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro.online as jo  # noqa: E402
import repro.retriever as jr  # noqa: E402
import repro.service as js  # noqa: E402
import repro.training as jt  # noqa: E402
import repro_torch.data as td  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import repro_torch.online as to  # noqa: E402
import repro_torch.retriever as tr  # noqa: E402
import repro_torch.service as ts  # noqa: E402
import repro_torch.training as tt  # noqa: E402
from repro_torch.configs import gam_mf  # noqa: E402
from repro_torch.core.mapping import GamConfig  # noqa: E402

OPT_TOL = dict(rtol=1e-6, atol=1e-7)
TCFG = GamConfig(k=CFG.k, scheme=CFG.scheme, d=CFG.d, threshold=CFG.threshold)
ITEMS = unit_factors(200, 16, 0)
USERS = unit_factors(8, 16, 1)


# ---------------------------------------------------------------- optimizer


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "blocks": [{"b": rng.normal(size=7).astype(np.float32)},
                       {"b": rng.normal(size=3).astype(np.float32)}]}


def _leaves(tree):
    """Leaves as numpy, dict keys sorted (JAX's pytree order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


@pytest.mark.parametrize("clip_norm", [1.0, 1e3])
def test_adamw_steps_match_reference(clip_norm):
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=10, clip_norm=clip_norm,
               weight_decay=0.1)
    jcfg, tcfg = jt.AdamWConfig(**cfg), tt.AdamWConfig(**cfg)
    params0 = _tree(0)
    jp = _map(jnp.asarray, params0)
    tp = _map(torch.as_tensor, params0)
    jstate, tstate = jt.adamw_init(jp), tt.adamw_init(tp)
    for step in range(6):
        grads = _tree(10 + step)
        jp, jstate, jm = jt.adamw_update(jcfg, _map(jnp.asarray, grads),
                                         jstate, jp)
        tp, tstate, tm = tt.adamw_update(tcfg, _map(torch.as_tensor, grads),
                                         tstate, tp)
        for a, b in zip(_leaves(_map(_np, tp)), _leaves(jp)):
            np.testing.assert_allclose(a, b, **OPT_TOL)
        for a, b in zip(_leaves(_map(_np, tstate.nu)), _leaves(jstate.nu)):
            np.testing.assert_allclose(a, b, **OPT_TOL)
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=1e-6)
    assert int(tstate.step) == int(jstate.step) == 6
    assert tstate.step.dtype == torch.int32


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _np(t):
    return t.numpy()


def test_cosine_schedule_global_norm_and_sgd_match_reference():
    cfg = dict(lr=3e-4, warmup_steps=100, total_steps=1000, min_lr_frac=0.1)
    for step in (0, 1, 50, 99, 100, 101, 550, 999, 1000, 5000):
        np.testing.assert_allclose(
            float(tt.cosine_schedule(tt.AdamWConfig(**cfg),
                                     torch.tensor(step))),
            float(jt.cosine_schedule(jt.AdamWConfig(**cfg),
                                     jnp.asarray(step))), rtol=1e-6)
    tree = _tree(3)
    np.testing.assert_allclose(float(tt.global_norm(_map(torch.as_tensor,
                                                         tree))),
                               float(jt.global_norm(_map(jnp.asarray, tree))),
                               rtol=1e-6)
    grads = _tree(4)
    got = tt.sgd_update(0.1, _map(torch.as_tensor, grads),
                        _map(torch.as_tensor, tree))
    want = jt.sgd_update(0.1, _map(jnp.asarray, grads),
                         _map(jnp.asarray, tree))
    for a, b in zip(_leaves(_map(_np, got)), _leaves(want)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------- generators


def _same_arrays(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=3, n_users=300,
                                                   n_items=500, density=0.02,
                                                   n_clusters=5)])
def test_movielens_like_ratings_bit_identical(kw):
    _same_arrays(td.movielens_like_ratings(**kw),
                 jd.movielens_like_ratings(**kw))


def test_synthetic_ratings_and_token_pipeline_bit_identical():
    _same_arrays(td.synthetic_ratings(50, 70, 8, seed=2),
                 jd.synthetic_ratings(50, 70, 8, seed=2))
    kw = dict(vocab=97, seq_len=16, batch=3, seed=4, structure_seed=1)
    tp, jp = td.TokenPipeline(**kw), jd.TokenPipeline(**kw)
    for step in (0, 1, 7):
        _same_arrays([tp.batch_at(step)], [jp.batch_at(step)])
    _same_arrays([next(iter(tp))], [next(iter(jp))])


def test_gam_mf_config_is_the_references():
    from repro.configs import gam_mf as jcfg
    assert dataclasses.asdict(gam_mf.MF) == dataclasses.asdict(jcfg.MF)
    assert dataclasses.asdict(gam_mf.GAM) == dataclasses.asdict(jcfg.GAM)
    assert gam_mf.MIN_OVERLAP == jcfg.MIN_OVERLAP
    assert gam_mf.GAM.p == jcfg.GAM.p


def test_drift_simulator_draws_bit_identical():
    kw = dict(n_users=6, n_items=90, k=8, seed=4, cold_start_per_round=3)
    t, j = to.DriftSimulator(**kw), jo.DriftSimulator(**kw)
    _same_arrays([t.users, t.items, t.hot], [j.users, j.items, j.hot])
    for _ in range(3):
        a, b = t.step(), j.step()
        _same_arrays([a.ts, a.users, a.items, a.values],
                     [b.ts, b.users, b.items, b.values])
    _same_arrays([t.true_topk(5), t.items_at_start],
                 [j.true_topk(5), j.items_at_start])
    assert t.recall(t.true_topk(5), j.true_topk(5)) == 1.0


# ------------------------------------------------------------- event batches


def test_event_batch_sorts_validates_and_concats_like_reference():
    kw = dict(ts=[3.0, 1.0, 2.0, 1.0], users=[10, 11, 12, 13],
              items=[0, 1, 2, 3], values=[0.3, 0.1, 0.2, 0.15])
    t, j = to.EventBatch(**kw), jo.EventBatch(**kw)
    assert list(t.users) == [11, 13, 12, 10]      # stable on equal ts
    _same_arrays([t.ts, t.users, t.items, t.values],
                 [j.ts, j.users, j.items, j.values])
    with pytest.raises(ValueError, match="lengths"):
        to.EventBatch(ts=[1.0], users=[0, 1], items=[0], values=[1.0])
    with pytest.raises(ValueError, match="negative"):
        to.EventBatch(ts=[1.0], users=[-1], items=[0], values=[1.0])
    cat = to.EventBatch.concat([to.EventBatch(ts=[2.0], users=[0], items=[0],
                                              values=[1.0]), t])
    assert list(cat.ts) == [1.0, 1.0, 2.0, 2.0, 3.0] and len(cat) == 5
    assert len(to.EventBatch.concat([])) == 0


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_event_batch_jsonl_crosses_between_packages(tmp_path, writer):
    rng = np.random.default_rng(0)
    kw = dict(ts=np.arange(32, dtype=np.float64) / 3,
              users=rng.integers(0, 8, 32), items=rng.integers(0, 50, 32),
              values=rng.normal(size=32))
    src, dst = ((to, jo) if writer == "port" else (jo, to))
    ev = src.EventBatch(**kw)
    path = tmp_path / "events.jsonl"
    ev.to_jsonl(path)
    other = tmp_path / "again.jsonl"
    src.EventBatch(**kw).to_jsonl(other)
    back = dst.EventBatch.from_jsonl(path)
    _same_arrays([back.ts, back.users, back.items, back.values],
                 [ev.ts, ev.users, ev.items, ev.values])
    back.to_jsonl(other)
    assert other.read_text() == path.read_text()
    (tmp_path / "min.jsonl").write_text('{"ts": 0.5, "user": 2, "item": 7}\n')
    assert list(dst.EventBatch.from_jsonl(tmp_path / "min.jsonl").values) \
        == [1.0]


# ---------------------------------------------------------------- exporters


def _hists(mod):
    lat = mod.LogHistogram(lo=1e-3, hi=1.0, bins=4)
    lat.record_many([0.0, 0.002, 0.05, 0.9, 3.0])
    frac = mod.LogHistogram.fraction()
    frac.record_many([0.1, 0.25, 0.5, 0.99])
    return {"latency_seconds": lat, "occupancy": frac,
            "empty": mod.LogHistogram.latency()}


SNAPSHOT = {"qps": 12.5, "latency_p50_ms": None, "parity": True,
            "host_load": [3, 4], "mode": "gam", "n": 7, "tiny": 1.25e-12,
            "push_staleness_p50_s": 0.3333333333333}


def test_prometheus_text_equals_reference_character_for_character():
    th, jh = _hists(tobs), _hists(jobs)
    for key in th:
        assert tobs.histogram_to_prometheus(f"svc_{key}", th[key], "help") \
            == jobs.histogram_to_prometheus(f"svc_{key}", jh[key], "help")
    got = tobs.snapshot_to_prometheus(SNAPSHOT, th)
    assert got == jobs.snapshot_to_prometheus(SNAPSHOT, jh)
    assert 'repro_host_load{index="1"} 4' in got
    assert "latency_p50_ms" not in got and "repro_parity" not in got
    assert tobs.snapshot_to_prometheus({}) == jobs.snapshot_to_prometheus({})
    # a live service's snapshot renders the same too
    svc = ts.ServiceMetrics(lambda: 5.0)
    ref = js.ServiceMetrics(lambda: 5.0)
    for m in (svc, ref):
        m.record_batch(2, 4, [0.010, 0.012], queue_waits_s=[0.008, 0.010],
                       service_s=0.002)
        m.record_push(3, 1, staleness_s=[0.5, 1.5, 2.0])
    assert tobs.snapshot_to_prometheus(svc.snapshot(), svc.histograms()) == \
        jobs.snapshot_to_prometheus(ref.snapshot(), ref.histograms())


def test_jsonl_metrics_writer_equals_reference(tmp_path):
    def run(mod, path):
        t = [100.0]
        w = mod.JsonlMetricsWriter(str(path), clock=lambda: t[0],
                                   interval_s=1.0)
        h = _hists(mod)
        assert w.maybe_write(lambda: {"qps": 1.0}, lambda: h)
        assert not w.maybe_write(lambda: {"qps": 2.0})
        t[0] += 1.5
        assert w.maybe_write(lambda: {"qps": 3.0})
        w.write({"qps": 4.0, "host_load": [1, 2]})
        return w.n_written, path.read_text()

    got = run(tobs, tmp_path / "port.jsonl")
    want = run(jobs, tmp_path / "ref.jsonl")
    assert got == want
    rows = [json.loads(ln) for ln in got[1].splitlines()]
    assert [r["qps"] for r in rows] == [1.0, 3.0, 4.0]


# ------------------------------------------------------------------- shims


def _ref(spec_kw, items=ITEMS):
    return jr.open_retriever(jr.RetrieverSpec(**spec_kw), items=items)


def test_brute_force_retriever_shim_warns_and_matches_backend():
    from repro_torch.core.retrieval import BruteForceRetriever
    with pytest.warns(DeprecationWarning, match="backend='brute'"):
        legacy = BruteForceRetriever(ITEMS, device="cpu")
    res = legacy.query(USERS, 10)
    want = tr.open_retriever(tr.RetrieverSpec(cfg=GamConfig(k=16),
                                              backend="brute"),
                             items=ITEMS, device="cpu").query(USERS, 10)
    np.testing.assert_array_equal(res.ids, want.ids)
    np.testing.assert_array_equal(res.scores, want.scores)
    ref = _ref(dict(cfg=CFG, backend="brute")).query(USERS, 10)
    np.testing.assert_array_equal(res.ids, ref.ids)


@pytest.mark.parametrize("device", [False, True])
def test_gam_retriever_shim_warns_and_matches_backend(device):
    from repro_torch.core.retrieval import GamRetriever
    backend = "gam-device" if device else "gam"
    with pytest.warns(DeprecationWarning, match=backend):
        legacy = GamRetriever(ITEMS, TCFG, min_overlap=2, device=device,
                              bucket=512, torch_device="cpu")
    res = legacy.query(USERS, 10)
    want = tr.open_retriever(
        tr.RetrieverSpec(cfg=TCFG, backend=backend, min_overlap=2,
                         bucket=512), items=ITEMS, device="cpu").query(
        USERS, 10)
    np.testing.assert_array_equal(res.ids, want.ids)
    np.testing.assert_array_equal(res.scores, want.scores)
    ref = _ref(dict(cfg=CFG, backend=backend, min_overlap=2,
                    bucket=512)).query(USERS, 10)
    np.testing.assert_array_equal(res.ids, ref.ids)
    # the old attribute surface still reads through the shim
    assert legacy.items.shape == ITEMS.shape
    assert legacy.item_tau.shape == ITEMS.shape
    assert legacy.min_overlap == 2 and legacy.cfg is TCFG


def test_gam_service_shim_warns_keeps_tuple_query_and_streams():
    with pytest.warns(DeprecationWarning, match="backend='sharded'"):
        svc = ts.GamService(np.arange(200), ITEMS, TCFG,
                            ts.ServiceConfig(n_shards=2, min_overlap=2,
                                             kappa=10), device="cpu")
    ids, scores = svc.query(USERS, 10)       # historical tuple return
    want = tr.open_retriever(
        tr.RetrieverSpec(cfg=TCFG, backend="sharded", n_shards=2,
                         min_overlap=2, kappa=10), items=ITEMS,
        device="cpu").query(USERS, 10)
    np.testing.assert_array_equal(ids, want.ids)
    np.testing.assert_array_equal(scores, want.scores)
    with pytest.warns(DeprecationWarning):
        ref = js.GamService(np.arange(200), ITEMS, CFG,
                            js.ServiceConfig(n_shards=2, min_overlap=2,
                                             kappa=10))
    np.testing.assert_array_equal(ids, ref.query(USERS, 10)[0])
    assert svc.cfg is TCFG
    svc.upsert([500], unit_factors(1, 16, 2))    # delegated streaming
    svc.delete([0])
    assert svc.n_items == 200 and len(svc.delta) == 1
    svc.compact()
    assert len(svc.delta) == 0


def test_shims_survive_pickle_round_trip():
    """The delegating __getattr__ must not recurse on a bare instance
    (pickle probes dunders before __init__ ran)."""
    from repro_torch.core.retrieval import BruteForceRetriever, GamRetriever
    with pytest.warns(DeprecationWarning):
        legacy = [BruteForceRetriever(ITEMS, device="cpu"),
                  GamRetriever(ITEMS, TCFG, min_overlap=2,
                               torch_device="cpu")]
    for shim in legacy:
        clone = pickle.loads(pickle.dumps(shim))
        np.testing.assert_array_equal(clone.query(USERS, 5).ids,
                                      shim.query(USERS, 5).ids)


def test_no_warning_from_spec_driven_path():
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        tr.open_retriever(tr.RetrieverSpec(cfg=TCFG, backend="gam",
                                           min_overlap=2),
                          items=ITEMS, device="cpu").query(USERS, 5)


def test_shims_run_on_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: None means it")
    from repro_torch.core.retrieval import BruteForceRetriever
    with pytest.warns(DeprecationWarning), \
            pytest.raises(RuntimeError, match="device='cpu'"):
        BruteForceRetriever(ITEMS)


# ------------------------------------------------------------ load generator


def test_zipf_weights_and_profiles_match_reference():
    for n, s in ((1, 1.1), (7, 0.0), (100, 1.1), (512, 2.0)):
        np.testing.assert_array_equal(ts.zipf_weights(n, s),
                                      js.zipf_weights(n, s))
    with pytest.raises(ValueError):
        ts.zipf_weights(0, 1.0)
    text = "zipf=1.3,curve=bursty,qps=50,peak=3,period=2,queries=9,seed=4"
    tp, jp = ts.LoadProfile.parse(text), js.LoadProfile.parse(text)
    assert tp.__dict__ == jp.__dict__
    for t in np.linspace(0.0, 5.0, 23):
        for curve in ("constant", "diurnal", "bursty"):
            a = ts.LoadProfile(curve=curve, qps=80.0, period_s=2.0)
            b = js.LoadProfile(curve=curve, qps=80.0, period_s=2.0)
            assert a.rate(t) == b.rate(t) and a.peak_rate == b.peak_rate
    with pytest.raises(ValueError, match="unknown load-profile key"):
        ts.LoadProfile.parse("zipff=1")


@pytest.mark.parametrize("curve", ["constant", "diurnal", "bursty"])
def test_load_generator_draws_bit_identical(curve):
    kw = dict(n_queries=32, curve=curve, qps=50.0, period_s=2.0, seed=3,
              zipf_items=1.3)
    ids = np.arange(40, 104, dtype=np.int64)
    a = ts.LoadGenerator(ts.LoadProfile(**kw), CFG.k, item_ids=ids)
    b = js.LoadGenerator(js.LoadProfile(**kw), CFG.k, item_ids=ids)
    _same_arrays([a.queries], [b.queries])
    for _ in range(3):
        _same_arrays(a.sample_queries(16), b.sample_queries(16))
        _same_arrays(a.sample_upserts(5), b.sample_upserts(5))
        _same_arrays([a.arrivals(40, t0=1.0)], [b.arrivals(40, t0=1.0)])
    with pytest.raises(ValueError, match="item_ids"):
        ts.LoadGenerator(ts.LoadProfile(), CFG.k).sample_upserts(1)
