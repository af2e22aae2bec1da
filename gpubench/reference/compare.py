"""The comparison that decides ``correct``: served answers against the
exact reference, as three numbers, each held to its limit.

* ``n_scored_gap``: the widest relative gap between a query's reported
  candidate count and the reference's (phi and the live set);
* ``rank_gap``: the widest gap by which the j-th best served item, scored
  in float64, lies below the reference's j-th best (a slot served with an
  item that is not a live candidate, or a repeated one, or left empty where
  the reference has a candidate, counts as a gap of 3, more than any two
  scores of unit rows differ);
* ``score_err``: the widest gap between a served score and the float64
  inner product of its query and item.
"""
from __future__ import annotations

import numpy as np

from gpubench.reference.phi import phi
from gpubench.reference.retrieval import Answer, Catalog

__all__ = ["NUMBERS", "judge"]

NUMBERS = ("n_scored_gap", "rank_gap", "score_err")
_BAD = 3.0


def judge(served: Answer, ref: Answer, cat: Catalog, users: np.ndarray, *,
          threshold: float, min_overlap: int, device="cpu") -> dict:
    """-> {number: value} for ``served`` (the program's or the control's
    answer to ``users``) against ``ref`` (``answer(..., "exact")``)."""
    users = np.asarray(users, np.float32)
    ids = np.asarray(served.ids, np.int64)
    q, kappa = ids.shape
    n_ref = np.asarray(ref.n_scored, np.float64)
    n_gap = np.abs(np.asarray(served.n_scored, np.float64) - n_ref) / \
        np.maximum(n_ref, 1.0)

    rows = np.clip(np.searchsorted(cat.ids, ids), 0, max(len(cat.ids) - 1, 0))
    live = (ids >= 0) & (len(cat.ids) > 0) & (cat.ids[rows] == ids)
    u_tau, u_mask = phi(users, threshold, device=device)
    x_tau, x_mask = cat.tau[rows], cat.mask[rows]               # (q, kappa, k)
    hits = ((u_tau[:, None, :, None] == x_tau[:, :, None, :])
            & u_mask[:, None, :, None] & x_mask[:, :, None, :])
    cand = live & (hits.sum(axis=(2, 3)) >= min_overlap)
    srt = np.sort(np.where(ids >= 0, ids, -1 - np.arange(kappa)), axis=1)
    repeated = np.zeros_like(live)
    repeated[:, 1:] = srt[:, 1:] == srt[:, :-1]
    valid = cand & ~np.any(repeated, axis=1, keepdims=True)
    exact = np.einsum("qk,qjk->qj", users.astype(np.float64),
                      cat.factors[rows].astype(np.float64))
    bad = (ids >= 0) & ~valid

    s = -np.sort(-np.where(valid, exact, -_BAD + 1.0), axis=1)  # -2: empty
    r = np.asarray(ref.scores, np.float64)
    gap = np.where(np.isfinite(r), r - s, 0.0)
    rank_gap = np.where(bad.any(axis=1), _BAD, gap.max(axis=1, initial=0.0))
    err = np.where(valid, np.abs(np.asarray(served.scores, np.float64)
                                 - exact), 0.0)
    return {"n_scored_gap": float(n_gap.max(initial=0.0)),
            "rank_gap": float(rank_gap.max(initial=0.0)),
            "score_err": float(err.max(initial=0.0))}
