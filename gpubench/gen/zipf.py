"""Frozen copy of the Zipf draws of ``repro_torch.service.loadgen``.

``zipf_weights`` is copied line for line; ``zipf_ids`` is the id draw of
``LoadGenerator.sample_upserts`` (``rng.choice`` over the ids with the
Zipf pmf by rank, duplicates allowed, the last write wins).
"""
from __future__ import annotations

import numpy as np

__all__ = ["zipf_ids", "zipf_weights"]


def zipf_weights(n: int, s: float) -> np.ndarray:
    """Normalized Zipf pmf over ranks 1..n: p(r) ∝ r^-s (s=0 ⇒ uniform)."""
    if n < 1:
        raise ValueError("need n >= 1 ranks")
    w = np.arange(1, n + 1, dtype=np.float64) ** -float(s)
    return w / w.sum()


def zipf_ids(rng: np.random.Generator, ids: np.ndarray, n: int,
             s: float) -> np.ndarray:
    """``n`` draws from ``ids`` (rank = position) under Zipf(``s``)."""
    ids = np.asarray(ids, np.int64).ravel()
    return rng.choice(ids, size=n, p=zipf_weights(ids.size, s)).astype(
        np.int64)
