"""The port's online-learning tier against ``repro``'s, on the CPU.

Both packages' ``DriftSimulator`` draw the same events from one seed.  The
streaming trainers consume them step by step; XLA orders the fused sums of
a step differently from the port, so their tables agree within
``STREAM_TOL`` (rtol 1e-5, atol 1e-6), the mse and gradient norm within
rtol 1e-5.  Cold-start rows, capacity growth and everything ``PushPolicy``
decides are bit-exact.  The end-to-end contract is the reference's: after
rounds of drift, ``partial_fit`` and gated pushes, the live retriever
answers bit for bit like one rebuilt from the pushed catalog.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from conftest import CFG, unit_factors  # noqa: E402

import repro.online as jo  # noqa: E402
import repro_torch.online as to  # noqa: E402
import repro_torch.retriever as tr  # noqa: E402
from repro_torch.core.mapping import GamConfig  # noqa: E402
from repro_torch.online.trainer import online_step  # noqa: E402
from repro_torch.retriever.types import dedupe_last_write  # noqa: E402
from repro_torch.service.faults import FaultInjected  # noqa: E402

K = CFG.k
TCFG = GamConfig(k=CFG.k, scheme=CFG.scheme, d=CFG.d, threshold=CFG.threshold)
STREAM_TOL = dict(rtol=1e-5, atol=1e-6)
SCALAR_RTOL = 1e-5


def _sims(**kw):
    kw = dict(dict(n_users=8, n_items=64, k=K, seed=13, drift=0.25,
                   hot_frac=0.5, events_per_round=256), **kw)
    return jo.DriftSimulator(**kw), to.DriftSimulator(**kw)


def _same_events(a, b):
    for f in ("ts", "users", "items", "values"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


# --------------------------------------------------------- streaming trainer


@pytest.mark.parametrize("cfg", [
    dict(lr=0.5, momentum=0.6, seed=3),
    # frozen users (their velocity and accumulator still move), clipped
    # gradients, and chunks of 100 events (the reference pads each to 128)
    dict(lr=0.5, momentum=0.6, seed=3, update_users=False, clip_norm=0.5,
         batch=100),
])
def test_partial_fit_matches_reference_step_by_step(cfg):
    jsim, tsim = _sims()
    j = jo.StreamingMF(jo.OnlineMFConfig(k=K, **cfg))
    t = to.StreamingMF(to.OnlineMFConfig(k=K, **cfg), device="cpu")
    for tr_ in (j, t):
        tr_.warm_start(u=jsim.users, v=jsim.items_at_start)
    for _ in range(5):
        jev, tev = jsim.step(), tsim.step()
        _same_events(jev, tev)
        a, b = j.partial_fit(jev), t.partial_fit(tev)
        assert a["n_steps"] == b["n_steps"]
        np.testing.assert_array_equal(a["touched_items"], b["touched_items"])
        np.testing.assert_allclose(b["mse"], a["mse"], rtol=SCALAR_RTOL)
        np.testing.assert_allclose(b["grad_norm"], a["grad_norm"],
                                   rtol=SCALAR_RTOL)
        np.testing.assert_allclose(t.item_factors(), j.item_factors(),
                                   **STREAM_TOL)
        np.testing.assert_allclose(t.user_factors(), j.user_factors(),
                                   **STREAM_TOL)
        for key in ("u", "v"):
            np.testing.assert_allclose(t._vel[key].numpy(),
                                       np.asarray(j._vel[key]), **STREAM_TOL)
            np.testing.assert_allclose(t._gsq[key].numpy(),
                                       np.asarray(j._gsq[key]), **STREAM_TOL)
    if not cfg.get("update_users", True):
        np.testing.assert_array_equal(t.user_factors(), jsim.users)
        assert t._gsq["u"].abs().sum() > 0 and t._vel["u"].abs().sum() > 0
    assert t.stats() | {"mse": None, "grad_norm": None} == \
        j.stats() | {"mse": None, "grad_norm": None}


@pytest.mark.parametrize("clip_norm", [0.0, 0.5])
def test_padded_step_equals_unpadded_bit_for_bit(clip_norm):
    """The reference pads every chunk to a power of two with zero-confidence
    rows; the port does not pad.  Such rows add exactly nothing."""
    _, sim = _sims()
    cfg = to.OnlineMFConfig(k=K, seed=3, clip_norm=clip_norm)
    t = to.StreamingMF(cfg, device="cpu")
    t.warm_start(u=sim.users, v=sim.items_at_start)
    ev = sim.step()
    rows, cols = torch.as_tensor(ev.users[:100]), torch.as_tensor(ev.items[:100])
    prefs = torch.as_tensor(ev.values[:100])
    confs = 1.0 + prefs.abs()
    z = torch.zeros(28, dtype=torch.int64)
    plain = online_step(t._params, t._vel, t._gsq, rows, cols, prefs, confs,
                        cfg)
    padded = online_step(t._params, t._vel, t._gsq, torch.cat([rows, z]),
                         torch.cat([cols, z]), torch.cat([prefs, 0.0 * z]),
                         torch.cat([confs, 0.0 * z]), cfg)
    for a, b in zip(plain[:3], padded[:3]):
        for key in ("u", "v"):
            assert torch.equal(a[key], b[key])
    assert torch.equal(plain[3], padded[3]) and torch.equal(plain[4],
                                                            padded[4])


def _observations(rng, users, items, n):
    u = rng.integers(0, users.shape[0], n)
    i = rng.integers(0, items.shape[0], n)
    vals = np.sum(users[u] * items[i], axis=1)
    return to.EventBatch(ts=np.arange(n, dtype=np.float64), users=u,
                         items=i, values=vals.astype(np.float32))


def test_partial_fit_reduces_mse():
    rng = np.random.default_rng(7)
    users, items = unit_factors(16, K, 1), unit_factors(32, K, 2)
    t = to.StreamingMF(to.OnlineMFConfig(k=K, lr=0.5, momentum=0.6, seed=3),
                       device="cpu")
    ev = _observations(rng, users, items, 512)
    first = t.partial_fit(ev)["mse"]
    for _ in range(8):
        last = t.partial_fit(ev)["mse"]
    assert last < first * 0.5
    stats = t.stats()
    assert stats["n_events"] == 512 * 9
    assert stats["n_users"] == 16 and stats["n_items"] == 32


def test_touched_ids_and_factor_getters():
    t = to.StreamingMF(to.OnlineMFConfig(k=K, seed=0), device="cpu")
    ev = to.EventBatch(ts=[0.0, 1.0], users=[3, 5], items=[7, 7],
                       values=[0.5, 0.25])
    fit = t.partial_fit(ev)
    np.testing.assert_array_equal(fit["touched_users"], [3, 5])
    np.testing.assert_array_equal(fit["touched_items"], [7])
    assert t.item_factors([7]).shape == (1, K)
    assert t.user_factors().shape == (6, K)
    with pytest.raises(IndexError):
        t.item_factors([99])
    with pytest.raises(TypeError):
        t.partial_fit(jo.EventBatch(ts=[0.0], users=[0], items=[0],
                                    values=[1.0]))
    assert t.partial_fit(to.EventBatch.empty())["n_steps"] == 0


def test_capacity_growth_is_pow2_path_independent_and_the_references():
    """Cold-start rows are seeded per 64-row block: growing 64 -> 512 at
    once or 64 -> 128 -> 512 gives the same rows, bit for bit the
    reference's."""
    big = dict(ts=[0.0], users=[0], items=[511], values=[1.0])
    small = dict(ts=[0.0], users=[0], items=[100], values=[1.0])
    t1 = to.StreamingMF(to.OnlineMFConfig(k=K, seed=11), device="cpu")
    t1.partial_fit(to.EventBatch(**big))
    t2 = to.StreamingMF(to.OnlineMFConfig(k=K, seed=11), device="cpu")
    t2.partial_fit(to.EventBatch(**small))
    t2.partial_fit(to.EventBatch(**big))
    j = jo.StreamingMF(jo.OnlineMFConfig(k=K, seed=11))
    j.partial_fit(jo.EventBatch(**big))
    assert t1.capacity[1] == t2.capacity[1] == j.capacity[1] == 512
    assert t2.n_grows > t1.n_grows == j.n_grows
    cold = np.setdiff1d(np.arange(512), [0, 100, 511])
    np.testing.assert_array_equal(t1.item_factors()[cold],
                                  t2.item_factors()[cold])
    np.testing.assert_array_equal(t1.item_factors()[cold],
                                  j.item_factors()[cold])
    big_u = to.StreamingMF(to.OnlineMFConfig(k=K, seed=11), n_users=300,
                           n_items=70, device="cpu")
    big_j = jo.StreamingMF(jo.OnlineMFConfig(k=K, seed=11), n_users=300,
                           n_items=70)
    assert big_u.capacity == big_j.capacity == (512, 128)
    np.testing.assert_array_equal(big_u.user_factors(), big_j.user_factors())
    np.testing.assert_array_equal(big_u.item_factors(), big_j.item_factors())


# -------------------------------------------------------------- push policy


class _RecordingRetriever:
    """Minimal upsert sink: records batches, optionally faults."""

    def __init__(self, fail=False):
        self.batches = []
        self.fail = fail

    def upsert(self, ids, factors):
        if self.fail:
            raise FaultInjected("delta_error")
        self.batches.append((np.asarray(ids).copy(),
                             np.asarray(factors).copy()))


def _policy(retriever, clock, **kw):
    kw.setdefault("min_cos", 0.99)
    kw.setdefault("staleness_s", 5.0)
    return to.PushPolicy(retriever, clock=lambda: clock[0], **kw)


def test_push_gate_cold_drift_stale_suppress():
    r = _RecordingRetriever()
    clock = [0.0]
    p = _policy(r, clock)
    f = unit_factors(1, K, 0)

    p.offer([1], f)                          # never pushed before
    ids, _ = p.flush()
    assert list(ids) == [1] and len(r.batches) == 1

    p.offer([1], 2.0 * f)                    # same direction: cos == 1
    ids, _ = p.flush()
    assert ids.size == 0 and len(r.batches) == 1
    assert list(p.pending_ids) == [1]        # suppressed stays pending

    clock[0] += 10.0                         # past the staleness budget
    ids, _ = p.flush()
    assert list(ids) == [1] and p.pending_ids.size == 0

    rot = unit_factors(1, K, 99)             # far off-axis: drift gate
    p.offer([1], rot)
    ids, fac = p.flush()
    assert list(ids) == [1]
    np.testing.assert_array_equal(fac, rot)
    assert p.n_pushed == 3 and p.n_suppressed == 1
    assert 0 < p.stats()["suppression_rate"] < 1


def test_push_seed_registers_without_pushing():
    r = _RecordingRetriever()
    p = _policy(r, [0.0])
    base = unit_factors(4, K, 3)
    p.seed(np.arange(4), base)
    assert not r.batches
    p.offer(np.arange(4), base)              # identical to what's served
    ids, _ = p.flush()
    assert ids.size == 0 and not r.batches   # all suppressed


def test_push_duplicate_offers_last_write_wins():
    r = _RecordingRetriever()
    p = _policy(r, [0.0])
    f1, f2 = unit_factors(1, K, 1), unit_factors(1, K, 2)
    p.offer([5], f1)
    p.offer([5], f2)
    ids, fac = p.flush(force=True)
    assert list(ids) == [5] and len(r.batches) == 1
    np.testing.assert_array_equal(fac, f2)   # the later offer won

    # the underlying contract helper this rides on
    d_ids, d_fac = dedupe_last_write(np.asarray([5, 6, 5], np.int64),
                                     np.stack([f1[0], f1[0], f2[0]]))
    np.testing.assert_array_equal(np.sort(d_ids), [5, 6])
    np.testing.assert_array_equal(d_fac[list(d_ids).index(5)], f2[0])


def test_push_fault_leaves_batch_pending_and_retryable():
    r = _RecordingRetriever(fail=True)
    p = _policy(r, [0.0])
    p.offer([1, 2], unit_factors(2, K, 4))
    with pytest.raises(FaultInjected):
        p.flush(force=True)
    np.testing.assert_array_equal(p.pending_ids, [1, 2])
    assert p.n_pushed == 0 and not r.batches
    ok = _RecordingRetriever()
    p.retriever = ok                         # rebind (restore / failover)
    ids, _ = p.flush(force=True)
    np.testing.assert_array_equal(np.sort(ids), [1, 2])
    assert len(ok.batches) == 1


def test_push_policy_decides_like_reference_on_a_random_offer_stream():
    """Both packages' policies over one stream of offers (repeats, drifts,
    staleness, forced flushes): every flush pushes the same ids and
    factors, and the counters agree."""
    rng = np.random.default_rng(3)
    sinks = [_RecordingRetriever(), _RecordingRetriever()]
    clock = [0.0]
    pols = [jo.PushPolicy(sinks[0], min_cos=0.98, staleness_s=3.0,
                          clock=lambda: clock[0]),
            to.PushPolicy(sinks[1], min_cos=0.98, staleness_s=3.0,
                          clock=lambda: clock[0])]
    base = unit_factors(40, K, 5)
    for p in pols:
        p.seed(np.arange(40), base)
    for step in range(12):
        clock[0] += 1.0
        ids = rng.integers(0, 60, 25)
        fac = unit_factors(60, K, 0)[ids] + rng.normal(
            scale=rng.choice([0.01, 0.3]), size=(25, K)).astype(np.float32)
        outs = []
        for p in pols:
            p.offer(ids, fac)
            outs.append(p.flush(force=step % 5 == 4))
        np.testing.assert_array_equal(outs[0][0], outs[1][0])
        np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert pols[0].stats() == pols[1].stats()
    assert pols[1].n_pushed > 0 and pols[1].n_suppressed > 0


def _sharded(items, **kw):
    spec = tr.RetrieverSpec(cfg=TCFG, backend="sharded", n_shards=2,
                            min_overlap=2, **kw)
    return tr.open_retriever(spec, items=items, device="cpu")


def test_push_wires_metrics_and_journal_from_sharded_retriever():
    items = unit_factors(32, K, 6)
    svc = _sharded(items)
    p = to.PushPolicy(svc, min_cos=0.99, staleness_s=5.0)
    assert p.metrics is svc.metrics and p.events is svc.events
    assert p.clock is svc.clock
    p.seed(np.arange(32), items)
    p.offer([0, 40], np.stack([items[0], unit_factors(1, K, 8)[0]]))
    p.flush()                                # 40 cold-pushes, 0 suppressed
    snap = svc.metrics.snapshot()
    assert snap["push_total"] == 1
    assert snap["push_suppressed"] == 1
    assert snap["push_flushes"] == 1
    assert "factor_push" in [e["kind"] for e in svc.events.tail()]
    assert svc.n_items == 33


# ------------------------------------------------- end-to-end drift parity


def _drift_spec(backend):
    kw = {} if backend == "gam" else dict(min_overlap=2, n_shards=2)
    if backend == "sharded-multihost":
        kw.update(n_hosts=2, replication=2)
    return tr.RetrieverSpec(cfg=TCFG, backend=backend, **kw)


@pytest.mark.parametrize("backend", ["gam", "sharded", "sharded-multihost"])
def test_drift_run_matches_from_scratch_rebuild(backend):
    """After rounds of drift -> partial_fit -> gated pushes, the live
    retriever answers bit for bit like one rebuilt from the pushed
    catalog; the live multi-host service also like a single-host
    ``sharded`` rebuild.  Held against the port's rebuilds only: the
    reference's own multi-host case of this test is one of the reference
    behaviours ROADMAP §3 lists."""
    _, sim = _sims()
    catalog = {i: f.copy() for i, f in enumerate(sim.items_at_start)}
    svc = tr.open_retriever(_drift_spec(backend), items=sim.items_at_start,
                            device="cpu")
    t = to.StreamingMF(to.OnlineMFConfig(k=K, lr=0.5, momentum=0.6, seed=21,
                                         update_users=False), device="cpu")
    t.warm_start(u=sim.users, v=sim.items_at_start)
    tick = [0.0]
    policy = to.PushPolicy(svc, min_cos=0.995, staleness_s=2.0,
                           clock=lambda: tick[0])
    policy.seed(np.arange(sim.n_items), sim.items_at_start)
    for _ in range(3):
        tick[0] += 1.0
        touched = t.partial_fit(sim.step())["touched_items"]
        policy.offer(touched, t.item_factors(touched))
        for i, f in zip(*policy.flush()):
            catalog[int(i)] = f.copy()
    assert policy.n_pushed > 0 and policy.n_suppressed > 0

    ids = np.asarray(sorted(catalog), np.int64)
    fresh = tr.open_retriever(_drift_spec(backend),
                              items=np.stack([catalog[int(i)] for i in ids]),
                              ids=ids, device="cpu")
    rebuilds = [fresh]
    if backend == "sharded-multihost":
        rebuilds.append(tr.open_retriever(
            _drift_spec("sharded"),
            items=np.stack([catalog[int(i)] for i in ids]), ids=ids,
            device="cpu"))
    for exact in (True, False):
        got = svc.query(sim.users, 8, exact=exact)
        for rebuilt in rebuilds:
            want = rebuilt.query(sim.users, 8, exact=exact)
            np.testing.assert_array_equal(got.ids, want.ids)
            np.testing.assert_array_equal(got.scores, want.scores)
