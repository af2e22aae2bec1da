"""Leaf types of the unified retriever API (no intra-package imports).

Counterpart of ``repro.retriever.types``: results are host numpy arrays in
catalog-id space, the same contract in both packages.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["RetrievalResult", "UnsupportedOp", "dedupe_last_write"]


def dedupe_last_write(ids: np.ndarray,
                      factors: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Resolve duplicate ids within ONE upsert batch: the last write wins.

    The single definition of the contract's batch-duplicate semantics —
    every mutable backend (brute, gam/gam-device, the sharded delta tier)
    funnels through here so their mutation behaviour cannot drift apart.
    """
    if len(np.unique(ids)) != ids.size:
        _, first_rev = np.unique(ids[::-1], return_index=True)
        sel = np.sort(ids.size - 1 - first_rev)
        return ids[sel], factors[sel]
    return ids, factors


class UnsupportedOp(NotImplementedError):
    """A backend does not implement this part of the Retriever contract.

    Raised eagerly (never silently diverging) so callers can feature-test a
    backend with try/except instead of guessing from its name.
    """

    def __init__(self, backend: str, op: str, why: str = ""):
        self.backend = backend
        self.op = op
        msg = f"backend {backend!r} does not support {op}()"
        super().__init__(f"{msg}: {why}" if why else msg)


@dataclasses.dataclass
class RetrievalResult:
    """Top-kappa answer of any retriever backend, in catalog-id space.

    Empty slots (queries with fewer than kappa candidates) carry id -1 and
    score -inf; ``n_scored`` counts the items whose exact inner product was
    computed, and ``discarded_frac`` is the fraction of the live item set
    never scored (the paper's speed-up statistic).
    """

    ids: np.ndarray        # (Q, kappa) retrieved catalog ids (-1 pad)
    scores: np.ndarray     # (Q, kappa) inner products (-inf pad)
    n_scored: np.ndarray   # (Q,) how many items were actually scored
    discarded_frac: np.ndarray  # (Q,) fraction of the item set never scored
    # query(..., explain=True) provenance — None on the default path.  The
    # explain dict is PURELY diagnostic: ids/scores/n_scored/discarded_frac
    # are bit-identical with and without it (pinned by the contract suite).
    # Keys vary by backend; see docs/observability.md for the schema.
    explain: dict | None = None
    # deadline-driven graceful degradation (the sharded tiers): True iff a
    # degrade-ladder rung actually reduced the work for this answer, with
    # the rung name from repro.service.qos.DEGRADE_RUNGS — a degraded
    # answer is never silently mistaken for the full one.
    degraded: bool = False
    degrade_rung: str | None = None
