"""Paper §6.2 end to end on the port, on the card unless given ``--device
cpu``: learn MF factors on MovieLens-statistics data, map them with the GAM
schema, and reproduce the accuracy-vs-discard comparison against all four
baselines; then keep training: stage 4 replays the ratings as a
timestamped event stream through the online tier (StreamingMF warm-started
from the offline run, PushPolicy publishing into a live sharded retriever),
and stage 5 serves a Zipf/diurnal replay through the hot-query result
cache.

The §6 line-up (``brute_oracle``, ``build_methods``, ``evaluate``) is kept
here with the specs and parameters of ``benchmarks/common.py``, each
retriever opened on the example's device.

Run:  PYTHONPATH=src python examples/movielens_repro_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.configs.gam_mf import MF
from repro_torch.core.mapping import GamConfig
from repro_torch.core.retrieval import recovery_accuracy
from repro_torch.data import movielens_like_ratings
from repro_torch.device import resolve_device
from repro_torch.factorization import train_mf
from repro_torch.online import (EventBatch, OnlineMFConfig, PushPolicy,
                                StreamingMF)
from repro_torch.retriever import RetrieverSpec, open_retriever
from repro_torch.service.loadgen import (LoadGenerator, LoadProfile,
                                         zipf_weights)

KAPPA = 10
N_USERS, N_ITEMS = 943, 1682
LINEUP_USERS = 200                # users the line-up is evaluated over
CHUNK = 8192                      # events a partial_fit in the replay
BASELINES = ("srp-lsh", "superbit-lsh", "cro", "pca-tree")


# ------------------------------------------------------------ the line-up

def brute_oracle(items: np.ndarray, device=None):
    """Exact reference retriever over ``items`` (the ``brute`` backend)."""
    return open_retriever(
        RetrieverSpec(cfg=GamConfig(k=items.shape[1]), backend="brute"),
        items=items, device=device)


def build_methods(items: np.ndarray, k: int, *, gam_threshold: float = 0.2,
                  gam_min_overlap: int = 2, sparse_threshold: float = 0.45,
                  sparse_min_overlap: int = 3, seed: int = 0,
                  device=None) -> dict:
    """The paper's §6 line-up: GAM (ternary + parse-tree) vs 4 baselines,
    parameters chosen so discard rates are comparable (the paper matches
    sparsity levels when comparing accuracy), each opened on ``device``."""
    plain = GamConfig(k=k)
    specs = {
        "gam": RetrieverSpec(
            cfg=GamConfig(k=k, scheme="parse_tree", threshold=gam_threshold),
            backend="gam", min_overlap=gam_min_overlap),
        "gam-sparse": RetrieverSpec(   # the paper's headline-discard point
            cfg=GamConfig(k=k, scheme="parse_tree",
                          threshold=sparse_threshold),
            backend="gam", min_overlap=sparse_min_overlap),
        "srp-lsh": RetrieverSpec(
            cfg=plain, backend="srp-lsh", seed=seed,
            options=(("n_bits", max(4, k // 2)), ("n_tables", 4))),
        "superbit-lsh": RetrieverSpec(
            cfg=plain, backend="superbit-lsh", seed=seed,
            options=(("n_bits", max(4, k // 2)), ("n_tables", 4))),
        "cro": RetrieverSpec(
            cfg=plain, backend="cro", seed=seed,
            options=(("n_proj", 2 * k), ("top_l", 2), ("n_tables", 4))),
        "pca-tree": RetrieverSpec(
            cfg=plain, backend="pca-tree",
            options=(("depth", max(3, int(np.log2(len(items))) - 4)),)),
    }
    return {name: open_retriever(spec, items=items, device=device)
            for name, spec in specs.items()}


def evaluate(methods: dict, items: np.ndarray, users: np.ndarray,
             kappa: int = KAPPA, device=None) -> dict:
    """Per-method: recovery accuracy vs exact top-kappa, % discarded
    (distribution over users), implied speed-up."""
    brute = brute_oracle(items, device).query(users, kappa)
    out = {}
    for name, method in methods.items():
        res = method.query(users, kappa)
        acc = recovery_accuracy(res.ids, brute.ids)
        disc = res.discarded_frac
        out[name] = {
            "accuracy_mean": float(acc.mean()),
            "accuracy": acc,
            "discard_mean": float(disc.mean()),
            "discard_std": float(disc.std()),
            "discard": disc,
            "speedup": float(1.0 / max(1.0 - disc.mean(), 1e-9)),
            "ids": res.ids,
        }
    return out


def check_lineup(res: dict) -> None:
    """The paper's claim: at comparable discard rates GAM is far more
    accurate than each baseline."""
    gam = res["gam"]
    assert gam["accuracy_mean"] > 0.85, gam["accuracy_mean"]
    assert gam["discard_mean"] > 0.3, gam["discard_mean"]
    for b in BASELINES:
        if res[b]["discard_mean"] <= gam["discard_mean"] + 0.15:
            assert gam["accuracy_mean"] >= res[b]["accuracy_mean"] - 1e-9, b


# ------------------------------------------------------ streaming replay

def stream_replay(u, v, mf_state, rows, cols, vals, device=None, *,
                  clock=None) -> dict:
    """Stage 4: the ratings in a seeded arrival order, ``CHUNK`` events a
    ``partial_fit``, through ``PushPolicy`` into a live ``sharded`` index;
    then a forced flush, and the live index against a from-scratch
    rebuild of the pushed catalog.  ``clock`` replaces the policy's (the
    retriever's) clock."""
    # MovieLens-statistics ratings carry no timestamps; a seeded shuffle
    # stands in for arrival order
    order = np.random.default_rng(4).permutation(len(vals))
    stream = EventBatch(ts=np.arange(len(vals), dtype=np.float64),
                        users=rows[order], items=cols[order],
                        values=vals[order])

    spec = RetrieverSpec(cfg=GamConfig(k=MF.k, threshold=0.25),
                         backend="sharded", n_shards=2, min_overlap=2)
    svc = open_retriever(spec, items=v, device=device)
    catalog = {i: f.copy() for i, f in enumerate(v)}
    trainer = StreamingMF.from_state(mf_state, OnlineMFConfig(k=MF.k,
                                                              lr=0.05),
                                     device=device)
    policy = PushPolicy(svc, min_cos=0.999, staleness_s=4.0, clock=clock)
    policy.seed(np.arange(v.shape[0]), v)

    for s in range(0, len(stream), CHUNK):
        ev = EventBatch(ts=stream.ts[s:s + CHUNK],
                        users=stream.users[s:s + CHUNK],
                        items=stream.items[s:s + CHUNK],
                        values=stream.values[s:s + CHUNK])
        fit = trainer.partial_fit(ev)
        touched = fit["touched_items"]
        policy.offer(touched, trainer.item_factors(touched))
        for i, f in zip(*policy.flush()):
            catalog[int(i)] = f.copy()
    for i, f in zip(*policy.flush(force=True)):
        catalog[int(i)] = f.copy()

    ps = policy.stats()
    assert ps["pushed"] > 0 and ps["suppressed"] > 0, ps

    # zero silently wrong: the streamed-into index answers bit-identically
    # to a from-scratch rebuild of the same pushed catalog
    ids = np.asarray(sorted(catalog), np.int64)
    factors = np.stack([catalog[int(i)] for i in ids])
    fresh = open_retriever(spec, items=factors, ids=ids, device=device)
    got = svc.query(u[:64], KAPPA, exact=True)
    want = fresh.query(u[:64], KAPPA, exact=True)
    assert np.array_equal(got.ids, want.ids)
    assert np.array_equal(got.scores, want.scores)
    return {"spec": spec, "svc": svc, "fresh": fresh, "trainer": trainer,
            "policy": policy, "ids": ids, "factors": factors}


# --------------------------------------------------------- cached replay

PROFILE = LoadProfile(zipf_q=1.1, zipf_items=1.1, n_queries=64,
                      curve="diurnal", qps=200.0, peak_ratio=4.0,
                      period_s=1.0, seed=5)
N_REQUESTS = 400
UPSERT_EVERY = 40


def cached_replay(u, replay: dict, device=None) -> dict:
    """Stage 5: Zipf-popular real user rows as the repeating query
    identities, Zipf item-popularity churn from the live trainer (one
    hot-item upsert every ``UPSERT_EVERY`` requests into both sides),
    diurnal arrival pacing; the cached ``sharded`` retriever must answer
    as the uncached rebuild does, bit for bit, at every step."""
    profile = PROFILE
    ids, fresh, trainer = replay["ids"], replay["fresh"], replay["trainer"]
    arrivals = LoadGenerator(profile, MF.k).arrivals(N_REQUESTS)
    rng = np.random.default_rng(profile.seed)
    pool = rng.choice(u.shape[0], size=profile.n_queries, replace=False)
    q_w = zipf_weights(profile.n_queries, profile.zipf_q)
    i_w = zipf_weights(ids.size, profile.zipf_items)

    cached = open_retriever(
        RetrieverSpec(cfg=replay["spec"].cfg, backend="sharded", n_shards=2,
                      min_overlap=2, cache_capacity=256),
        items=replay["factors"], ids=ids, device=device)
    wrong = 0
    for i in range(N_REQUESTS):
        if i % UPSERT_EVERY == UPSERT_EVERY - 1:   # churn rides the stream
            hot = int(ids[rng.choice(ids.size, p=i_w)])
            fnew = trainer.item_factors(np.array([hot]))
            cached.upsert([hot], fnew)
            fresh.upsert([hot], fnew)
        user = u[pool[rng.choice(profile.n_queries, p=q_w)]][None]
        a = cached.query(user, KAPPA, exact=True)
        b = fresh.query(user, KAPPA, exact=True)
        wrong += not (np.array_equal(a.ids, b.ids)
                      and np.array_equal(a.scores, b.scores))
    cs = cached.cache.stats()
    assert wrong == 0                 # a cache hit is never silently stale
    assert cs["hit_rate"] > 0.3 and cs["invalidations"] > 0, cs
    return {"cache": cs, "wrong": wrong, "arrivals_s": float(arrivals[-1]),
            "peak_rate": profile.peak_rate}


# ------------------------------------------------------------------ main

def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    stage_s = {}

    def lap(stage, t0):
        stage_s[stage] = time.perf_counter() - t0
        print(f"   stage {stage}: {stage_s[stage]:.2f} s")

    print("1. generating MovieLens100k-statistics ratings (943x1682, ~6.3%)")
    t0 = time.perf_counter()
    rows, cols, vals = movielens_like_ratings(seed=0)
    print(f"   {len(vals)} observed ratings")
    lap(1, t0)

    print("2. training matrix factorisation (k=%d) ..." % MF.k)
    t0 = time.perf_counter()
    u, v, hist, mf_state = train_mf(rows, cols, vals, N_USERS, N_ITEMS, MF,
                                    return_state=True, device=dev)
    print(f"   train MSE {hist[0]:.3f} -> {hist[-1]:.3f}")
    lap(2, t0)

    print("3. GAM mapping + inverted index vs baselines")
    t0 = time.perf_counter()
    methods = build_methods(v, MF.k, gam_threshold=0.25, gam_min_overlap=2,
                            sparse_threshold=0.15, device=dev)
    res = evaluate(methods, v, u[:LINEUP_USERS], kappa=KAPPA, device=dev)
    print(f"{'method':14s} {'accuracy':>9s} {'discarded':>10s} "
          f"{'speedup':>8s}")
    for name, r in res.items():
        print(f"{name:14s} {r['accuracy_mean']:9.3f} "
              f"{r['discard_mean']:10.1%} x{r['speedup']:7.2f}")
    check_lineup(res)
    lap(3, t0)

    print("4. streaming replay: ratings as a timestamped event stream")
    t0 = time.perf_counter()
    replay = stream_replay(u, v, mf_state, rows, cols, vals, dev)
    trainer, ps = replay["trainer"], replay["policy"].stats()
    print(f"   {trainer.stats()['n_events']} events replayed, "
          f"{ps['pushed']} pushed / {ps['suppressed']} suppressed "
          f"(rate {ps['suppression_rate']:.0%}), final mse "
          f"{trainer.stats()['mse']:.3f}")
    print("   live index bit-identical to a from-scratch rebuild")
    lap(4, t0)

    print("5. serving: Zipf/diurnal replay with the hot-query result cache")
    t0 = time.perf_counter()
    served = cached_replay(u, replay, dev)
    cs, span = served["cache"], served["arrivals_s"]
    print(f"   {N_REQUESTS} requests over {span:.1f}s of diurnal arrivals "
          f"(mean {N_REQUESTS / span:.0f}/s, peak λ "
          f"{served['peak_rate']:.0f}/s): hit rate {cs['hit_rate']:.0%}, "
          f"{cs['invalidations']} invalidations, "
          f"wrong={served['wrong']}/{N_REQUESTS}")
    lap(5, t0)
    print("OK")
    return {"u": u, "v": v, "history": hist, "methods": methods,
            "lineup": res, "push": ps, "cache": cs, "wrong": served["wrong"],
            "stage_s": stage_s}


if __name__ == "__main__":
    main()
