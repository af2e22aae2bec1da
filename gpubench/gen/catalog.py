"""Frozen copies of the catalog and request generators of ``chip_smoke.py``.

``clustered_catalog`` and ``requests`` are copied line for line, so the
benchmark keeps drawing the same data for a seed whatever later changes
make to the originals.  ``tests/test_gpubench_gen.py`` holds them to the
originals while those exist.
"""
from __future__ import annotations

import numpy as np

__all__ = ["clustered_catalog", "requests"]


def clustered_catalog(n, k, n_clusters, sigma, seed):
    """Cluster-sorted unit rows around ``n_clusters`` unit centers."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, k)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    per = -(-n // n_clusters)
    items = (np.repeat(centers, per, axis=0)[:n]
             + sigma * rng.normal(size=(n, k)).astype(np.float32))
    items /= np.linalg.norm(items, axis=1, keepdims=True)
    return items, centers


def requests(centers, n, batch, sigma, seed):
    """``n`` batches of queries drawn around centers, sorted by home cluster."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        sel = np.sort(rng.integers(0, len(centers), batch))
        u = centers[sel] + sigma * rng.normal(
            size=(batch, centers.shape[1])).astype(np.float32)
        out.append((u / np.linalg.norm(u, axis=1, keepdims=True))
                   .astype(np.float32))
    return out
