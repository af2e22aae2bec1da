"""Quickstart on the port: the paper's pipeline through the unified
retriever API, on the card unless given ``--device cpu``.

Generate factors, open a GAM retriever from one spec (geometry-aware sparse
mapping + inverted index), answer top-10 queries while discarding most of
the item set, compare against the brute-force backend, and round-trip the
index through snapshot/restore.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.core import GamConfig, recovery_accuracy
from repro_torch.data import synthetic_ratings
from repro_torch.retriever import RetrieverSpec, open_retriever

K, N_ITEMS, N_USERS, KAPPA = 10, 20_000, 50, 10


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    device = ap.parse_args().device

    # 1. factors (paper §6.1: U, V ~ N(0,1); compatibility = inner product)
    users, items, _ = synthetic_ratings(N_USERS, N_ITEMS, K, seed=0)

    # 2. one spec describes the whole deployment object: the geometry-aware
    #    schema (ternary directional tessellation, Alg 2 + parse-tree
    #    permutation, supplement B.2; factors thresholded at 0.45) plus the
    #    backend choice — swap "gam" for "gam-device" (fused kernel) or
    #    "sharded" (streaming service) without touching anything below
    spec = RetrieverSpec(
        cfg=GamConfig(k=K, scheme="parse_tree", threshold=0.45),
        backend="gam", min_overlap=3)

    # 3. build: map items with phi, index the sparsity patterns
    gam = open_retriever(spec, items=items, device=device)

    # 4. answer queries: candidates from pattern overlap, exact scores there
    res = gam.query(users, KAPPA)

    # 5. compare with the brute-force backend (same API, zero pruning)
    exact = open_retriever(
        RetrieverSpec(cfg=spec.cfg, backend="brute"), items=items,
        device=device)
    acc = recovery_accuracy(res.ids, exact.query(users, KAPPA).ids)

    print(f"items discarded per user: {res.discarded_frac.mean():.1%} "
          f"(+- {res.discarded_frac.std():.1%})")
    print(f"implied retrieval speed-up: "
          f"x{1 / (1 - res.discarded_frac.mean()):.1f}")
    print(f"recovery accuracy of true top-{KAPPA}: {acc.mean():.1%}")
    assert acc.mean() > 0.75 and res.discarded_frac.mean() > 0.7

    # 6. persistence: snapshot the index (posting lists, patterns) through
    #    repro_torch.checkpoint and restore it — answers are bit-identical
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gam_index.npz")
        gam.snapshot(path)
        restored = open_retriever(spec, snapshot=path, device=device)
        res2 = restored.query(users, KAPPA)
    assert np.array_equal(res.ids, res2.ids)
    assert np.array_equal(res.scores, res2.scores)
    print(f"snapshot/restore round trip: {restored.n_items} items, "
          "bit-identical answers")
    print("OK")


if __name__ == "__main__":
    main()
