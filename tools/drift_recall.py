#!/usr/bin/env python3
"""Recall of the online-learning loop against a frozen catalog, on the CPU,
in either package: what ``StreamingMF`` + ``PushPolicy`` do to the served
catalog's exact top-kappa as the simulator's hot items drift.

    python3 tools/drift_recall.py [--package repro_torch|repro]
        [--items 1048576] [--events 8192] [--rounds 10]

The loop is phase 8c's of ``chip_smoke.py`` (``DriftSimulator(n_users=64,
k=10, seed=17, drift=0.2, hot_frac=0.5)``, ``StreamingMF(OnlineMFConfig(
k=10, lr=0.5, momentum=0.6, reg=1e-4, batch=1024, seed=3,
update_users=False))`` warm-started from the simulator, ``PushPolicy(
min_cos=0.995, staleness_s=4.0)`` on a round clock), with the retriever
replaced by the pushed catalog itself: each round prints the recall@10 of
the exact top 10 over the pushed catalog and over the catalog at round 0
against the drifted truth, and the norms of the factors pushed that round.
With ``--package repro`` the same loop runs in the JAX reference (on the
CPU: set ``JAX_PLATFORMS=cpu``), so the two can be compared; both draw the
same events.  At 1,048,576 items the scores of 64 x 1M are sorted on the
host each round: a few minutes in all.
"""
from __future__ import annotations

import argparse
import importlib

import numpy as np

KAPPA = 10


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", default="repro_torch",
                    choices=("repro_torch", "repro"))
    ap.add_argument("--items", type=int, default=1 << 20)
    ap.add_argument("--events", type=int, default=8192)
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    online = importlib.import_module(f"{args.package}.online")
    extra = {"device": "cpu"} if args.package == "repro_torch" else {}

    sim = online.DriftSimulator(n_users=64, n_items=args.items, k=10,
                                seed=17, drift=0.2, hot_frac=0.5,
                                events_per_round=args.events)
    items0 = sim.items_at_start
    trainer = online.StreamingMF(online.OnlineMFConfig(
        k=10, lr=0.5, momentum=0.6, reg=1e-4, batch=1024, seed=3,
        update_users=False), **extra)
    trainer.warm_start(u=sim.users, v=items0)

    class Sink:                   # the pushed catalog is kept below
        def upsert(self, ids, factors):
            pass

    tick = [0.0]
    policy = online.PushPolicy(Sink(), min_cos=0.995, staleness_s=4.0,
                               clock=lambda: tick[0])
    policy.seed(np.arange(args.items), items0)
    catalog = items0.copy()

    def top(c):
        return np.argsort(-(sim.users @ c.T), axis=1,
                          kind="stable")[:, :KAPPA]

    print(f"{args.package}: {args.items} items, {args.events} events a "
          f"round")
    for rnd in range(1, args.rounds + 1):
        tick[0] += 1.0
        touched = trainer.partial_fit(sim.step())["touched_items"]
        policy.offer(touched, trainer.item_factors(touched))
        ids, fac = policy.flush()
        catalog[ids] = fac
        truth = sim.true_topk(KAPPA)
        norms = np.linalg.norm(fac, axis=1) if len(ids) else np.zeros(1)
        print(f"round {rnd}: recall@{KAPPA} online "
              f"{sim.recall(top(catalog), truth):.4f} frozen "
              f"{sim.recall(top(items0), truth):.4f}; pushed {len(ids)} "
              f"(in all {policy.n_pushed}), their norms p50 "
              f"{np.median(norms):.4f} max {norms.max():.4f}")


if __name__ == "__main__":
    main()
