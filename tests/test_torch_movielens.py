"""The paper's §6.2 experiment on the port
(``examples/movielens_repro_torch.py``) against the reference's, on the
CPU.

Both packages run on the reference's ``train_mf`` factors (MovieLens-100k's
shape, 943 x 1,682, 73,786 ratings, ``gam_mf.MF``), passed to the port as
numpy; the reference's line-up is built here from
``repro.retriever.open_retriever`` with the six specs of the §6 line-up
spelled out, the port's through the example's own ``build_methods`` and
``evaluate``.  Tolerances:

* ``gam`` and ``gam-sparse`` over ``u[:200]`` at kappa 10: per-user
  accuracy and discard equal to the reference's, ids equal as sets.
* The four baselines, built from one seed in each package: per-user
  discard equal and ids equal as sets, except boundary users.  A user is
  a boundary user when it lies within the rounding bound of a hyperplane,
  a CRO top-l boundary or a PCA median of the reference's structure
  (``test_torch_baselines._near_boundary``), or when its candidate sets
  in the two packages differ only by items that lie within that bound.
  Every differing user must be a boundary user, and at most
  ``MAX_BOUNDARY_USERS`` of the 200 differ (the count is printed).
* Stage 4 (streaming replay): both packages warm-start ``StreamingMF`` from
  the reference's ``MfState`` (``mf_state_from_reference``) and replay all
  ten chunks of the seeded arrival order, as the example does, under one
  counting clock. A push decision whose cosine against the last pushed
  factor lies within ``NEAR_COS`` of ``min_cos`` in either package is a
  near-tie; the pushed and the suppressed counts may differ by at most the
  number of chunks plus one per near-tie (a tie decided the other way
  leaves the item pending, so it is gated again at each later flush). The
  pushed catalog agrees within ``STREAM_TOL`` (``tests/test_torch_mf.py``)
  on every item that was never a near-tie. The port's live index answers
  bit for bit as its from-scratch rebuild at ``exact=True``, as the
  reference's does (at ``exact=False`` neither does: the live delta spills
  other rows than the rebuild, and a spilled row is scored for every
  query). Against the reference's live index, at ``exact`` False and True:
  ``n_scored`` equal, ids equal as sets, scores within ``SCORE_TOL`` (the
  catalog's ``STREAM_TOL`` carried through a dot product of k = 10 terms).
* Stage 5 (cached Zipf replay) on the catalog of stage 4: the 400 requests
  and 10 hot-item upserts of the example give the same cache hits, misses
  and invalidations in both packages, and no cached answer differs from
  the uncached one (``wrong == 0``).
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_baselines import (_near_boundary,  # noqa: E402
                                  _port_candidates, _ref_candidates)
from test_torch_examples import _load  # noqa: E402
from test_torch_mf import STREAM_TOL  # noqa: E402

import repro.online.push as j_push  # noqa: E402
import repro_torch.online.push as t_push  # noqa: E402
from repro.configs.gam_mf import MF  # noqa: E402
from repro.core.mapping import GamConfig as JConfig  # noqa: E402
from repro.core.retrieval import recovery_accuracy  # noqa: E402
from repro.data import movielens_like_ratings  # noqa: E402
from repro.factorization import train_mf  # noqa: E402
from repro.online import EventBatch as JEvents  # noqa: E402
from repro.online import OnlineMFConfig as JOnlineConfig  # noqa: E402
from repro.online import StreamingMF as JStreamingMF  # noqa: E402
from repro.retriever import RetrieverSpec as JSpec  # noqa: E402
from repro.retriever import open_retriever as j_open  # noqa: E402
from repro.service.loadgen import zipf_weights  # noqa: E402
from repro_torch.factorization.convert import (  # noqa: E402
    mf_state_from_reference)

EX = _load("movielens_repro_torch")
CPU = "cpu"
MAX_BOUNDARY_USERS = 4
NEAR_COS = 1e-6
SCORE_TOL = dict(rtol=1e-5, atol=1e-5)
BASELINES = ("srp-lsh", "superbit-lsh", "cro", "pca-tree")


N_USERS, N_ITEMS, KAPPA, LINEUP_USERS = (EX.N_USERS, EX.N_ITEMS, EX.KAPPA,
                                         EX.LINEUP_USERS)


def _ref_specs(k, n_items, *, gam_threshold=0.25, gam_min_overlap=2,
               sparse_threshold=0.15, sparse_min_overlap=3, seed=0):
    """The reference's §6 line-up, spelled out (``benchmarks/common.py``
    with the arguments of ``examples/movielens_repro.py``)."""
    plain = JConfig(k=k)
    return {
        "gam": JSpec(cfg=JConfig(k=k, scheme="parse_tree",
                                 threshold=gam_threshold),
                     backend="gam", min_overlap=gam_min_overlap),
        "gam-sparse": JSpec(cfg=JConfig(k=k, scheme="parse_tree",
                                        threshold=sparse_threshold),
                            backend="gam", min_overlap=sparse_min_overlap),
        "srp-lsh": JSpec(cfg=plain, backend="srp-lsh", seed=seed,
                         options=(("n_bits", max(4, k // 2)),
                                  ("n_tables", 4))),
        "superbit-lsh": JSpec(cfg=plain, backend="superbit-lsh", seed=seed,
                              options=(("n_bits", max(4, k // 2)),
                                       ("n_tables", 4))),
        "cro": JSpec(cfg=plain, backend="cro", seed=seed,
                     options=(("n_proj", 2 * k), ("top_l", 2),
                              ("n_tables", 4))),
        "pca-tree": JSpec(cfg=plain, backend="pca-tree",
                          options=(("depth", max(3, int(np.log2(n_items))
                                                 - 4)),)),
    }


@pytest.fixture(scope="module")
def trained():
    rows, cols, vals = movielens_like_ratings(seed=0)
    u, v, _, state = train_mf(rows, cols, vals, N_USERS, N_ITEMS, MF,
                              return_state=True)
    return {"ratings": (rows, cols, vals), "u": np.array(u),
            "v": np.array(v), "state": state}


@pytest.fixture(scope="module")
def lineups(trained):
    u, v = trained["u"], trained["v"]
    users = u[:LINEUP_USERS]
    brute = j_open(JSpec(cfg=JConfig(k=MF.k), backend="brute"),
                   items=v).query(users, KAPPA)
    ref, ref_methods = {}, {}
    for name, spec in _ref_specs(MF.k, len(v)).items():
        ref_methods[name] = j_open(spec, items=v)
        res = ref_methods[name].query(users, KAPPA)
        ref[name] = {"accuracy": recovery_accuracy(res.ids, brute.ids),
                     "discard": res.discarded_frac, "ids": res.ids}
    methods = EX.build_methods(v, MF.k, gam_threshold=0.25,
                               gam_min_overlap=2, sparse_threshold=0.15,
                               device=CPU)
    port = EX.evaluate(methods, v, users, kappa=KAPPA, device=CPU)
    return {"ref": ref, "ref_methods": ref_methods, "port": port,
            "port_methods": methods, "users": users, "items": v}


def _same_sets(a, b) -> np.ndarray:
    return np.array([set(x) == set(y) for x, y in zip(a, b)])


@pytest.mark.parametrize("name", ["gam", "gam-sparse"])
def test_lineup_gam_equals_reference(lineups, name):
    ref, port = lineups["ref"][name], lineups["port"][name]
    np.testing.assert_array_equal(port["accuracy"], ref["accuracy"])
    np.testing.assert_array_equal(port["discard"], ref["discard"])
    assert _same_sets(port["ids"], ref["ids"]).all()


@pytest.mark.parametrize("name", BASELINES)
def test_lineup_baseline_equals_reference_but_boundary(lineups, name):
    ref, port = lineups["ref"][name], lineups["port"][name]
    users, items = lineups["users"], lineups["items"]
    differ = ((port["discard"] != ref["discard"])
              | ~_same_sets(port["ids"], ref["ids"]))
    r_impl = lineups["ref_methods"][name]._impl
    p_impl = lineups["port_methods"][name]._impl
    near_items = set(np.nonzero(_near_boundary(r_impl, items))[0].tolist())
    boundary = _near_boundary(r_impl, users)
    for q, (a, b) in enumerate(zip(_ref_candidates(r_impl, users),
                                   _port_candidates(p_impl, users))):
        boundary[q] |= set(a.tolist()) ^ set(b.tolist()) <= near_items \
            and not np.array_equal(a, b)
    print(f"{name}: {int(differ.sum())} of {len(users)} users differ, "
          f"{int(boundary.sum())} boundary users")
    assert not (differ & ~boundary).any(), np.nonzero(differ & ~boundary)[0]
    assert differ.sum() <= MAX_BOUNDARY_USERS
    same = ~differ
    np.testing.assert_array_equal(port["accuracy"][same],
                                  ref["accuracy"][same])


def test_lineup_holds_the_papers_claim(lineups):
    """The reference's assertions on the port's table, and its speed-up
    is the discard's."""
    EX.check_lineup(lineups["port"])
    for r in lineups["port"].values():
        assert r["speedup"] == pytest.approx(1 / (1 - r["discard_mean"]))


# ---------------------------------------------------- stage 4: streaming


def _ticks():
    """A clock that advances one second a call: both policies see the
    same times for the same calls (staleness 4 s fires within the run)."""
    count = itertools.count()
    return lambda: float(next(count))


def _ref_stream_replay(u, v, state, rows, cols, vals, clock):
    """``examples/movielens_repro.py`` stage 4 on the reference."""
    order = np.random.default_rng(4).permutation(len(vals))
    stream = JEvents(ts=np.arange(len(vals), dtype=np.float64),
                     users=rows[order], items=cols[order],
                     values=vals[order])
    spec = JSpec(cfg=JConfig(k=MF.k, threshold=0.25), backend="sharded",
                 n_shards=2, min_overlap=2)
    svc = j_open(spec, items=v)
    catalog = {i: f.copy() for i, f in enumerate(v)}
    trainer = JStreamingMF.from_state(state, JOnlineConfig(k=MF.k, lr=0.05))
    policy = j_push.PushPolicy(svc, min_cos=0.999, staleness_s=4.0,
                               clock=clock)
    policy.seed(np.arange(v.shape[0]), v)
    chunk = EX.CHUNK
    for s in range(0, len(stream), chunk):
        ev = JEvents(ts=stream.ts[s:s + chunk],
                     users=stream.users[s:s + chunk],
                     items=stream.items[s:s + chunk],
                     values=stream.values[s:s + chunk])
        touched = trainer.partial_fit(ev)["touched_items"]
        policy.offer(touched, trainer.item_factors(touched))
        for i, f in zip(*policy.flush()):
            catalog[int(i)] = f.copy()
    for i, f in zip(*policy.flush(force=True)):
        catalog[int(i)] = f.copy()
    ids = np.asarray(sorted(catalog), np.int64)
    factors = np.stack([catalog[int(i)] for i in ids])
    fresh = j_open(spec, items=factors, ids=ids)
    return {"spec": spec, "svc": svc, "fresh": fresh, "trainer": trainer,
            "policy": policy, "ids": ids, "factors": factors}


def _recording_gate(module, out):
    """``PushPolicy._gate`` that also records (item, cosine against the
    last pushed factor) for every unforced decision on a known item."""
    orig = module.PushPolicy._gate

    def gate(self, i, fac, now, force):
        last = self._last_pushed.get(i)
        if last is not None and not force:
            out.append((int(i), module._cos(fac, last)))
        return orig(self, i, fac, now, force)
    return gate


@pytest.fixture(scope="module")
def replays(trained):
    u, v, state = trained["u"], trained["v"], trained["state"]
    rows, cols, vals = trained["ratings"]
    cos = {"ref": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_push.PushPolicy, "_gate",
                   _recording_gate(j_push, cos["ref"]))
        mp.setattr(t_push.PushPolicy, "_gate",
                   _recording_gate(t_push, cos["port"]))
        ref = _ref_stream_replay(u, v, state, rows, cols, vals, _ticks())
        port_state = mf_state_from_reference(
            {key: np.asarray(a) for key, a in state.params.items()},
            {key: np.asarray(a) for key, a in state.vel.items()},
            state.offset, device=CPU)
        port = EX.stream_replay(u, v, port_state, rows, cols, vals, CPU,
                                clock=_ticks())
    near = {i for side in cos.values() for i, c in side
            if abs(c - 0.999) <= NEAR_COS}
    live_vs_fresh = (port["svc"].query(u[:64], KAPPA, exact=True),
                     port["fresh"].query(u[:64], KAPPA, exact=True))
    return {"ref": ref, "port": port, "near": near, "n_gated": len(cos[
        "port"]), "live_vs_fresh": live_vs_fresh, "u": u,
        "ratings": trained["ratings"]}


def test_stream_replay_push_counts_equal_reference_up_to_near_ties(replays):
    ref = replays["ref"]["policy"].stats()
    port = replays["port"]["policy"].stats()
    n_near = len(replays["near"])
    cascade = -(-len(replays["ratings"][2]) // EX.CHUNK) + 1
    print(f"stage 4: {replays['n_gated']} gated decisions, {n_near} "
          f"near-ties at min_cos; pushed {port['pushed']} / "
          f"{ref['pushed']}, suppressed {port['suppressed']} / "
          f"{ref['suppressed']} (port / reference)")
    assert port["pushed"] > 0 and port["suppressed"] > 0
    for key in ("pushed", "suppressed"):
        assert abs(port[key] - ref[key]) <= cascade * n_near, key
    assert port["offered"] == ref["offered"]
    assert port["flushes"] == ref["flushes"]


def test_stream_replay_catalog_within_stream_tol(replays):
    ref, port = replays["ref"], replays["port"]
    np.testing.assert_array_equal(port["ids"], ref["ids"])
    keep = ~np.isin(port["ids"], list(replays["near"]))
    np.testing.assert_allclose(port["factors"][keep], ref["factors"][keep],
                               **STREAM_TOL)
    np.testing.assert_allclose(port["trainer"].item_factors(),
                               ref["trainer"].item_factors(), **STREAM_TOL)
    assert (port["trainer"].stats()["n_events"]
            == ref["trainer"].stats()["n_events"]
            == len(replays["ratings"][2]))


def test_stream_replay_live_index_equals_its_rebuild(replays):
    live, fresh = replays["live_vs_fresh"]
    np.testing.assert_array_equal(live.ids, fresh.ids)
    np.testing.assert_array_equal(live.scores, fresh.scores)
    np.testing.assert_array_equal(live.n_scored, fresh.n_scored)


@pytest.mark.parametrize("exact", [False, True])
def test_stream_replay_live_index_answers_as_reference(replays, exact):
    u = replays["u"][:64]
    got = replays["port"]["svc"].query(u, KAPPA, exact=exact)
    want = replays["ref"]["svc"].query(u, KAPPA, exact=exact)
    np.testing.assert_array_equal(got.n_scored, want.n_scored)
    assert _same_sets(got.ids, want.ids).all()
    np.testing.assert_allclose(got.scores, want.scores, **SCORE_TOL)


# ----------------------------------------------- stage 5: cached replay


def _ref_cached_replay(u, replay):
    """``examples/movielens_repro.py`` stage 5 on the reference."""
    profile = EX.PROFILE
    ids, fresh, trainer = replay["ids"], replay["fresh"], replay["trainer"]
    rng = np.random.default_rng(profile.seed)
    pool = rng.choice(u.shape[0], size=profile.n_queries, replace=False)
    q_w = zipf_weights(profile.n_queries, profile.zipf_q)
    i_w = zipf_weights(ids.size, profile.zipf_items)
    cached = j_open(JSpec(cfg=replay["spec"].cfg, backend="sharded",
                          n_shards=2, min_overlap=2, cache_capacity=256),
                    items=replay["factors"], ids=ids)
    wrong = 0
    for i in range(EX.N_REQUESTS):
        if i % EX.UPSERT_EVERY == EX.UPSERT_EVERY - 1:
            hot = int(ids[rng.choice(ids.size, p=i_w)])
            fnew = trainer.item_factors(np.array([hot]))
            cached.upsert([hot], fnew)
            fresh.upsert([hot], fnew)
        user = u[pool[rng.choice(profile.n_queries, p=q_w)]][None]
        a = cached.query(user, KAPPA, exact=True)
        b = fresh.query(user, KAPPA, exact=True)
        wrong += not (np.array_equal(a.ids, b.ids)
                      and np.array_equal(a.scores, b.scores))
    return {"cache": cached.cache.stats(), "wrong": wrong}


def test_cached_replay_cache_counts_equal_reference(replays):
    u = replays["u"]
    port = EX.cached_replay(u, replays["port"], CPU)
    ref = _ref_cached_replay(u, replays["ref"])
    print(f"stage 5: port {port['cache']}, reference {ref['cache']}")
    assert port["wrong"] == ref["wrong"] == 0
    for key in ("hits", "misses", "invalidations"):
        assert port["cache"][key] == ref["cache"][key], key
    assert port["cache"]["hit_rate"] > 0.3
    assert port["cache"]["invalidations"] > 0
