"""The port's lifecycle stress suite: the reference's seeded-program harness
(``tests/test_lifecycle_properties.py``) run against the port's backends on
the CPU, with the port's ``brute`` as the oracle.

Arbitrary interleavings of upsert / delete / query / compact /
compact-step / repartition / abort / snapshot-restore / fault injection /
deadline queries / feed-events / push / cached-query; after every op the
exact-mode answers must equal the oracle's (ids bit-equal, scores to
float summation order).  The ``feed_events`` / ``push`` ops drive the
port's online tier (``StreamingMF`` + ``PushPolicy`` on a fake round
clock) through the same program, mirroring whatever ``flush`` pushed into
the oracle; ``cached_query`` pins the result-cache contract (a warm repeat
is a counted hit equal to the oracle; a mutation in between makes a stale
hit impossible).  ``sharded-multihost`` waits for the multi-host slice, so
its ``mark_down`` / ``mark_up`` ops are no-ops here.  The hypothesis
variant is marked ``slow``, as the reference's is.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import CFG, unit_factors  # noqa: E402

from repro_torch.core.mapping import GamConfig  # noqa: E402
from repro_torch.online import (EventBatch, OnlineMFConfig,  # noqa: E402
                                PushPolicy, StreamingMF)
from repro_torch.retriever import RetrieverSpec, open_retriever  # noqa: E402
from repro_torch.service.faults import (FaultInjected,  # noqa: E402
                                        FaultInjector)

TCFG = GamConfig(k=CFG.k, scheme=CFG.scheme, d=CFG.d, threshold=CFG.threshold)
BACKENDS = ["brute", "gam", "gam-device", "sharded"]
ID_POOL = 64                       # ops address catalog ids 0..63
USERS = unit_factors(6, CFG.k, 991)

TAGS = ("upsert", "delete", "compact", "compact_async", "step",
        "repartition", "abort", "snapshot_restore",
        "mark_down", "mark_up", "inject_fault", "deadline_query",
        "feed_events", "push", "cached_query")
# op mix of the generated programs: mutation-heavy, maintenance-rich,
# with health churn, chaos, online-trainer pushes and hot-query cache
# probes riding along
TAG_P = (0.17, 0.11, 0.04, 0.10, 0.11, 0.04, 0.03, 0.06,
         0.05, 0.05, 0.04, 0.05, 0.06, 0.04, 0.05)


def _spec(backend):
    kw = dict(min_overlap=2, bucket=512)
    if backend == "sharded":
        # small slices so a single program crosses many planner phases;
        # cache on, so EVERY check() also exercises the hot-query memo
        kw.update(n_shards=2, cache_capacity=32,
                  options=(("compact_slice_rows", 16),))
    return RetrieverSpec(cfg=TCFG, backend=backend, **kw)


class LifecycleHarness:
    """One op stream applied to a backend and the brute oracle in lockstep;
    after EVERY op, exact-mode answers must match the oracle bit-for-bit
    (ids) / to summation order (scores)."""

    def __init__(self, backend, tmp_path, n0=48):
        items = unit_factors(n0, CFG.k, 990)
        ids = np.arange(n0, dtype=np.int64)
        self.backend = backend
        self.r = open_retriever(_spec(backend), items=items, ids=ids,
                                device="cpu")
        self.oracle = open_retriever(_spec("brute"), items=items,
                                     ids=ids, device="cpu")
        self.tmp = tmp_path
        self.n_snapshots = 0
        # online tier riding the same program: trainer over the id pool,
        # policy publishing into self.r on a fake round clock
        self.clock = [0.0]
        self.trainer = StreamingMF(OnlineMFConfig(k=CFG.k, lr=0.3, seed=17),
                                   device="cpu")
        self.trainer.warm_start(v=items)
        self.policy = PushPolicy(self.r, min_cos=0.99, staleness_s=3.0,
                                 clock=lambda: self.clock[0])
        self.policy.seed(ids, items)

    def check(self, tag=""):
        got = self.r.query(USERS, 8, exact=True)
        want = self.oracle.query(USERS, 8, exact=True)
        np.testing.assert_array_equal(got.ids, want.ids, err_msg=tag)
        np.testing.assert_allclose(got.scores, want.scores, rtol=1e-5,
                                   atol=1e-6, err_msg=tag)

    def _set_faults(self, a, b):
        """Attach / clear a seeded injector (the reference's third choice,
        a host stall, needs hosts: it leaves the injector as it is)."""
        if self.backend != "sharded":
            return
        choice = a % 3
        if choice == 0:
            self.r.faults = None
        elif choice == 1:
            # every upsert/delete raises FaultInjected (pre-mutation)
            self.r.faults = FaultInjector("delta_error=1.0", seed=b % 97)

    def apply(self, op):
        tag, a, b = op
        if tag == "upsert":
            ids, fac = [a % ID_POOL], unit_factors(1, CFG.k, 10_000 + b)
            try:
                self.r.upsert(ids, fac)
            except FaultInjected:
                pass     # raised before mutation -> oracle must skip too
            else:
                self.oracle.upsert(ids, fac)
        elif tag == "delete":
            try:
                self.r.delete([a % ID_POOL])
            except FaultInjected:
                pass
            else:
                self.oracle.delete([a % ID_POOL])
        elif tag in ("mark_down", "mark_up"):
            pass         # host health: no single-host backend has hosts
        elif tag == "inject_fault":
            self._set_faults(a, b)
        elif tag == "deadline_query":
            if self.backend == "sharded":
                if a % 2:
                    # a generous budget never degrades: exact answers stay
                    # bit-identical to the oracle
                    got = self.r.query(USERS, 8, exact=True, deadline_s=1e6)
                    assert not got.degraded and got.degrade_rung is None
                    want = self.oracle.query(USERS, 8, exact=True)
                    np.testing.assert_array_equal(got.ids, want.ids,
                                                  err_msg=str(op))
                else:
                    # a spent budget degrades to the floor — and says so
                    got = self.r.query(USERS, 8, deadline_s=0.0)
                    assert got.degraded
                    assert got.degrade_rung == "base_only"
        elif tag == "compact":
            self.r.compact()
            self.oracle.compact()
        elif tag == "compact_async":
            self.r.compact(async_=True)       # oracle never holds a delta
        elif tag == "step":
            if hasattr(self.r, "compaction_step"):
                self.r.compaction_step(max_slices=1 + a % 3)
        elif tag == "repartition":
            if self.backend == "sharded":
                self.r.repartition(async_=bool(a % 2))
        elif tag == "abort":
            if hasattr(self.r, "abort_compaction"):
                self.r.abort_compaction()
        elif tag == "feed_events":
            self.clock[0] += 1.0
            rng = np.random.default_rng((a, b))
            n = 8
            ev = EventBatch(
                ts=self.clock[0] + np.arange(n) / n,
                users=rng.integers(0, 8, size=n),
                items=rng.integers(0, ID_POOL, size=n),
                values=rng.normal(loc=1.0, scale=0.3, size=n))
            fit = self.trainer.partial_fit(ev)
            touched = fit["touched_items"]
            self.policy.offer(touched, self.trainer.item_factors(touched))
        elif tag == "push":
            self.clock[0] += 1.0
            try:
                p_ids, p_fac = self.policy.flush(force=bool(a % 2))
            except FaultInjected:
                pass     # batch stays pending -> oracle must skip too
            else:
                if p_ids.size:
                    self.oracle.upsert(p_ids, p_fac)
        elif tag == "cached_query":
            cache = getattr(self.r, "cache", None)
            if cache is not None:
                # the cache contract, pinned mid-program: a repeated query
                # HITS, the hit is bit-identical to the brute oracle, and a
                # mutation in between makes a stale hit impossible by
                # construction — generation mismatch => counted miss.
                # Drain any in-flight build first: queries auto-advance it,
                # and its swap would bump the version mid-sequence.
                while self.r.maintenance_stats()["compaction"]["active"]:
                    self.r.compaction_step()
                rows = USERS[a % len(USERS)][None]
                first = self.r.query(rows, 8, exact=True)   # warm the memo
                h0 = cache.n_hits
                again = self.r.query(rows, 8, exact=True)
                assert cache.n_hits == h0 + 1, str(op)
                want = self.oracle.query(rows, 8, exact=True)
                np.testing.assert_array_equal(again.ids, want.ids,
                                              err_msg=str(op))
                np.testing.assert_array_equal(again.ids, first.ids)
                np.testing.assert_array_equal(again.scores, first.scores)
                v0 = cache.version
                up_ids = [b % ID_POOL]
                up_fac = unit_factors(1, CFG.k, 20_000 + b)
                try:
                    self.r.upsert(up_ids, up_fac)
                except FaultInjected:
                    pass
                else:
                    self.oracle.upsert(up_ids, up_fac)
                    assert cache.version == v0 + 1, str(op)
                    m0, i0 = cache.n_misses, cache.n_invalidations
                    after = self.r.query(rows, 8, exact=True)
                    assert cache.n_misses == m0 + 1, str(op)
                    assert cache.n_invalidations == i0 + 1, str(op)
                    want = self.oracle.query(rows, 8, exact=True)
                    np.testing.assert_array_equal(after.ids, want.ids,
                                                  err_msg=str(op))
        elif tag == "snapshot_restore":
            path = os.fspath(self.tmp / f"s{self.n_snapshots}.npz")
            self.n_snapshots += 1
            self.r.snapshot(path)
            self.r = open_retriever(_spec(self.backend), snapshot=path,
                                    device="cpu")
            self.policy.retriever = self.r   # policy follows the restore
        else:                                  # pragma: no cover
            raise AssertionError(op)
        self.check(tag=str(op))

    def run(self, ops):
        for op in ops:
            self.apply(op)
        # drain any still-active build: the swap itself must be invisible
        while (self.backend.startswith("sharded")
               and self.r.maintenance_stats()["compaction"]["active"]):
            self.r.compaction_step()
            self.check("drain")


def random_program(seed, n_ops):
    rng = np.random.default_rng(seed)
    tags = rng.choice(len(TAGS), size=n_ops, p=TAG_P)
    ab = rng.integers(0, 2**16, size=(n_ops, 2))
    return [(TAGS[t], int(a), int(b)) for t, (a, b) in zip(tags, ab)]


# ------------------------------------------------------ deterministic tier


@pytest.mark.parametrize("backend", BACKENDS)
def test_lifecycle_stress_deterministic(backend, tmp_path):
    """Seeded random interleavings on every first-class backend (the
    tier-1 slice of the stress suite; CI's slow step runs more)."""
    n_ops = 24 if backend.startswith("sharded") else 12
    h = LifecycleHarness(backend, tmp_path)
    h.run(random_program(seed=101, n_ops=n_ops))


@pytest.mark.slow
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", [1, 2])
def test_lifecycle_stress_extended(backend, seed, tmp_path):
    h = LifecycleHarness(backend, tmp_path)
    h.run(random_program(seed=seed, n_ops=40))


# ----------------------------------------- every intermediate slice is exact


def _fresh_like(svc):
    ids = np.sort(np.fromiter(svc.catalog.keys(), np.int64, svc.n_items))
    fac = np.stack([svc.catalog[int(i)] for i in ids])
    return open_retriever(svc.spec, items=fac, ids=ids, device="cpu")


def test_background_compaction_every_slice_is_exact(tmp_path):
    """Acceptance: at EVERY planner step — across map, segments, meta,
    finalize and the swap itself — pruned and exact answers stay
    bit-identical to a fresh rebuild / the brute oracle, with mutations
    racing the build."""
    h = LifecycleHarness("sharded", tmp_path, n0=96)
    h.r.upsert(np.arange(100, 110), unit_factors(10, CFG.k, 7))
    h.oracle.upsert(np.arange(100, 110), unit_factors(10, CFG.k, 7))
    h.r.delete(np.arange(0, 96, 9))
    h.oracle.delete(np.arange(0, 96, 9))
    h.r.compact(async_=True)
    gen0 = h.r.generation
    steps = 0
    while h.r.maintenance_stats()["compaction"]["active"]:
        if steps == 2:                   # mutations race the build
            h.r.upsert([200], unit_factors(1, CFG.k, 8))
            h.oracle.upsert([200], unit_factors(1, CFG.k, 8))
            h.r.delete([3])
            h.oracle.delete([3])
        h.r.compaction_step()
        steps += 1
        h.check(f"slice {steps}")
        pruned = h.r.query(USERS, 8)
        fresh = _fresh_like(h.r).query(USERS, 8)
        np.testing.assert_array_equal(pruned.ids, fresh.ids,
                                      err_msg=f"pruned slice {steps}")
        np.testing.assert_array_equal(pruned.scores, fresh.scores)
        assert steps < 100
    assert steps >= 4, "slice_rows too coarse for the stress to mean much"
    assert h.r.generation == gen0 + 1
    assert len(h.r.delta) == 1           # exactly the raced upsert survives
    assert h.r.delta.ids[0] == 200


def test_repartition_background_every_step_is_exact(tmp_path):
    """The skew-aware rebuild (heterogeneous target partition) holds the
    same every-intermediate-step exactness, driven by the query-interleaved
    auto-stepping."""
    h = LifecycleHarness("sharded", tmp_path, n0=80)
    for i in range(4):                   # traffic so the metrics have load
        h.r.query(USERS, 8)
    part = h.r.repartition(async_=True)
    assert part.n == h.r.n_items
    steps = 0
    while h.r.maintenance_stats()["compaction"]["active"]:
        h.check(f"repartition slice {steps}")   # query auto-advances 1 slice
        steps += 1
        assert steps < 100
    assert h.r.generation == 1
    got = h.r.maintenance_stats()["repartition"]["partition"]
    assert tuple(got["lengths"]) == part.lengths
    assert tuple(got["bns"]) == part.bns
    h.check("after repartition swap")


# ------------------------------------------------------------ fault injection


def test_abort_at_every_phase_keeps_exactness(tmp_path):
    """Interrupting the build after ANY number of slices (mid-map through
    post-finalize) is invisible: the planner is shadow state, queries stay
    exact, and a later sync compact still lands generation + parity."""
    probe = LifecycleHarness("sharded", tmp_path, n0=60)
    probe.r.compact(async_=True)
    total = probe.r._planner.total_slices
    for n_steps in range(total + 1):
        h = LifecycleHarness("sharded", tmp_path, n0=60)
        h.r.upsert([70, 71], unit_factors(2, CFG.k, 5))
        h.oracle.upsert([70, 71], unit_factors(2, CFG.k, 5))
        h.r.compact(async_=True)
        h.r.compaction_step(max_slices=n_steps)
        swapped = not h.r.maintenance_stats()["compaction"]["active"]
        h.r.abort_compaction()
        assert not h.r.maintenance_stats()["compaction"]["active"]
        h.check(f"after abort at step {n_steps}")
        h.r.compact()                    # sync compact still works after
        h.oracle.compact()
        h.check(f"sync compact after abort at {n_steps}")
        assert h.r.generation >= 1 + int(swapped)


def test_snapshot_mid_compaction_restores_consistent_generation(tmp_path):
    """A snapshot taken mid-compaction persists only the stable serving
    state: restore lands in the pre-swap generation with NO compaction in
    flight and answers bit-identically — no half-swapped segment is ever
    observable through the snapshot surface."""
    h = LifecycleHarness("sharded", tmp_path, n0=90)
    h.r.upsert(np.arange(100, 108), unit_factors(8, CFG.k, 3))
    h.oracle.upsert(np.arange(100, 108), unit_factors(8, CFG.k, 3))
    h.r.compact(async_=True)
    h.r.compaction_step(max_slices=2)    # mid-map
    h.r.upsert([300], unit_factors(1, CFG.k, 4))   # journaled mutation
    h.oracle.upsert([300], unit_factors(1, CFG.k, 4))
    assert h.r.maintenance_stats()["compaction"]["active"]
    at_snapshot = h.r.query(USERS, 8)

    path = os.fspath(tmp_path / "mid.npz")
    h.r.snapshot(path)
    restored = open_retriever(_spec("sharded"), snapshot=path,
                              device="cpu")
    ms = restored.maintenance_stats()
    assert ms["generation"] == 0         # pre-swap generation
    assert not ms["compaction"]["active"]
    after = restored.query(USERS, 8)
    np.testing.assert_array_equal(at_snapshot.ids, after.ids)
    np.testing.assert_array_equal(at_snapshot.scores, after.scores)

    # the live instance finishes its build; the restored one runs its own
    # fresh compaction — both stay exact and land the SAME answers
    while h.r.maintenance_stats()["compaction"]["active"]:
        h.r.compaction_step()
    h.check("live after swap")
    restored.compact(async_=True)
    while restored.maintenance_stats()["compaction"]["active"]:
        restored.compaction_step()
    assert restored.generation == 1
    a = h.r.query(USERS, 8)
    b = restored.query(USERS, 8)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.scores, b.scores)


def test_snapshot_mid_repartition_build_is_consistent(tmp_path):
    """Same fault point, heterogeneous target: the snapshot carries the OLD
    partition until the swap actually happens."""
    h = LifecycleHarness("sharded", tmp_path, n0=70)
    h.r.query(USERS, 8)                  # traffic for the planner weights
    old_part = h.r.maintenance_stats()["repartition"]["partition"]
    h.r.repartition(async_=True)
    h.r.compaction_step(max_slices=1)
    path = os.fspath(tmp_path / "midrep.npz")
    h.r.snapshot(path)
    restored = open_retriever(_spec("sharded"), snapshot=path,
                              device="cpu")
    got = restored.maintenance_stats()["repartition"]["partition"]
    assert got == old_part               # no half-applied layout
    h.check("live mid-repartition")


# ------------------------------------------------------------ hypothesis tier


@pytest.mark.slow
@pytest.mark.parametrize("backend", ["sharded", "gam-device"])
def test_lifecycle_hypothesis_interleavings(backend, tmp_path):
    """Hypothesis-generated op streams over the same flat encoding (tuples
    shrink towards short, small programs)."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    op = st.tuples(st.sampled_from(TAGS), st.integers(0, 2**16),
                   st.integers(0, 2**16))

    @settings(max_examples=12, deadline=None)
    @given(st.lists(op, min_size=1, max_size=10))
    def check(ops):
        h = LifecycleHarness(backend, tmp_path, n0=32)
        h.run(ops)

    check()
