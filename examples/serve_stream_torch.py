"""Streaming retrieval service demo on the port, through the unified
retriever API, on the card unless given ``--device cpu``: open a
``sharded`` backend, stream delta upserts/deletes into the live catalog,
query continuously through the microbatching front-end, and snapshot the
catalog MID-STREAM (non-empty delta) — verifying that streamed state answers
exactly like a fresh rebuild, and that a restore answers exactly like the
snapshot (the delta-segment and snapshot contracts).

Run:  PYTHONPATH=src python examples/serve_stream_torch.py [--device cpu]
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.core.mapping import GamConfig
from repro_torch.retriever import RetrieverSpec, open_retriever


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    device = ap.parse_args().device

    rng = np.random.default_rng(0)
    K, N, KAPPA = 16, 600, 10
    items = rng.normal(size=(N, K)).astype(np.float32)
    items /= np.linalg.norm(items, axis=1, keepdims=True)
    spec = RetrieverSpec(
        cfg=GamConfig(k=K, scheme="parse_tree", threshold=0.2),
        backend="sharded", n_shards=2, min_overlap=2, kappa=KAPPA,
        batch_size=4, max_delay_s=5e-3)

    svc = open_retriever(spec, items=items, device=device)
    print(f"booted: {svc.n_items} items over {spec.n_shards} shards")

    next_id = N
    for step in range(6):
        # continuous query traffic through the microbatcher
        reqs = [svc.batcher.submit(rng.normal(size=K).astype(np.float32))
                for _ in range(4)]                      # size trigger fires
        results = [svc.batcher.result(r) for r in reqs]
        assert all(r is not None for r in results)

        # interleaved catalog mutations: 3 inserts, 1 overwrite, 1 delete
        ins = np.arange(next_id, next_id + 3)
        next_id += 3
        svc.upsert(ins, rng.normal(size=(3, K)).astype(np.float32))
        svc.upsert([step], rng.normal(size=(1, K)).astype(np.float32))
        svc.delete([100 + step])
        print(f"step {step}: catalog={svc.n_items} delta={len(svc.delta)} "
              f"top-1 of last request: id={results[-1].ids[0]} "
              f"score={results[-1].scores[0]:.3f}")

    # streamed state must answer exactly like a fresh rebuild of the catalog
    users = rng.normal(size=(8, K)).astype(np.float32)
    res_stream = svc.query(users, KAPPA)

    cat_ids = np.sort(np.fromiter(svc.catalog.keys(), np.int64, svc.n_items))
    cat_fac = np.stack([svc.catalog[int(i)] for i in cat_ids])
    fresh = open_retriever(spec, items=cat_fac, ids=cat_ids, device=device)
    res_fresh = fresh.query(users, KAPPA)
    assert np.array_equal(res_stream.ids, res_fresh.ids)
    assert np.array_equal(res_stream.scores, res_fresh.scores)
    print("streamed state == fresh rebuild: exact match")

    # snapshot mid-stream: tombstones + a live delta segment all round-trip
    # through repro_torch.checkpoint; the restored service answers
    # bit-identically
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "catalog.npz")
        svc.snapshot(path)
        restored = open_retriever(spec, snapshot=path, device=device)
        assert len(restored.delta) == len(svc.delta) > 0
        res_restored = restored.query(users, KAPPA)
    assert np.array_equal(res_restored.ids, res_stream.ids)
    assert np.array_equal(res_restored.scores, res_stream.scores)
    print(f"snapshot -> restore with live delta ({len(svc.delta)} rows): "
          "bit-identical answers")

    # background compaction: the rebuild happens in bounded slices that ride
    # on the query traffic — answers stay exact at every intermediate step,
    # and the swap is one atomic reference flip (generation +1)
    svc.compact(async_=True)
    slices = 0
    while svc.maintenance_stats()["compaction"]["active"]:
        mid = svc.query(users, KAPPA)       # each query advances one slice
        assert np.array_equal(mid.ids, res_fresh.ids)
        slices += 1
    res_c = svc.query(users, KAPPA)
    assert np.array_equal(res_c.ids, res_fresh.ids)
    assert np.array_equal(res_c.scores, res_fresh.scores)
    print(f"background compact(): {slices} query-interleaved slices, exact "
          f"throughout; generation={svc.generation} delta={len(svc.delta)}")

    snap = svc.metrics.snapshot()
    print(f"metrics: {snap['n_requests']} requests at {snap['qps']:.1f} QPS, "
          f"p50={snap['latency_p50_ms']:.2f}ms "
          f"p99={snap['latency_p99_ms']:.2f}ms, "
          f"discard={snap['discard_mean']:.1%}, "
          f"shard balance={snap['shard_balance']:.2f}, "
          f"{snap['n_upserts']} upserts / {snap['n_deletes']} deletes / "
          f"{snap['n_compactions']} compaction")
    print("OK")


if __name__ == "__main__":
    main()
