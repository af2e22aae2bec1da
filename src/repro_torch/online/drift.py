"""Seeded concept-drift workload for the online-learning tier (a copy of
``repro.online.drift``; numpy only, so both packages draw the same events).

A fixed population of unit user factors queries a catalog whose *true*
item factors drift: each round, a hot subset random-walks on the sphere
(step size ``drift``) while the cold majority stays put.  ``step()``
returns one :class:`EventBatch` of implicit-feedback events whose values
are noisy true inner products — a regression signal the streaming trainer
can chase — with timestamps that advance one unit per round (so a round
counter doubles as the staleness clock).

``true_topk`` ranks against the *current* true factors with the service
tier's exact tie order (score desc, id asc), giving the ground truth for
recall-vs-staleness curves: an index frozen at round 0 decays as the hot
set rotates away, a trained+pushed index tracks it.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.online.events import EventBatch

__all__ = ["DriftSimulator"]


def _unit(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


@dataclasses.dataclass
class DriftSimulator:
    n_users: int = 64
    n_items: int = 256
    k: int = 16
    seed: int = 0
    drift: float = 0.15                # per-round tangent step on hot items
    hot_frac: float = 0.25             # fraction of items that drift
    events_per_round: int = 512
    hot_event_frac: float = 0.7        # events targeting the hot set
    noise: float = 0.02                # value noise on u.v_true
    cold_start_per_round: int = 0      # brand-new item ids per round

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self.users = _unit(self._rng.normal(
            size=(self.n_users, self.k)).astype(np.float32))
        self.items = _unit(self._rng.normal(
            size=(self.n_items, self.k)).astype(np.float32))
        n_hot = max(int(self.hot_frac * self.n_items), 1)
        self.hot = self._rng.choice(self.n_items, size=n_hot, replace=False)
        self.hot.sort()
        self.round = 0
        self._items0 = self.items.copy()

    # --------------------------------------------------------------- rounds

    def step(self) -> EventBatch:
        """Advance one round of drift and emit its observation events."""
        self.round += 1
        rng = self._rng
        # hot items random-walk on the sphere
        tangent = rng.normal(size=(self.hot.size, self.k)).astype(np.float32)
        self.items[self.hot] = _unit(self.items[self.hot]
                                     + self.drift * tangent)
        if self.cold_start_per_round:
            fresh = _unit(rng.normal(
                size=(self.cold_start_per_round, self.k)).astype(np.float32))
            self.items = np.concatenate([self.items, fresh])
            self.n_items = self.items.shape[0]
        n = self.events_per_round
        users = rng.integers(0, self.n_users, size=n)
        n_hot_ev = int(self.hot_event_frac * n)
        items = np.concatenate([
            self.hot[rng.integers(0, self.hot.size, size=n_hot_ev)],
            rng.integers(0, self.n_items, size=n - n_hot_ev)])
        rng.shuffle(items)
        values = (np.sum(self.users[users] * self.items[items], axis=1)
                  + self.noise * rng.normal(size=n)).astype(np.float32)
        # intra-round order is the draw order; rounds are one time unit
        ts = self.round + np.arange(n, dtype=np.float64) / max(n, 1)
        return EventBatch(ts=ts, users=users.astype(np.int64),
                          items=items.astype(np.int64), values=values)

    # ------------------------------------------------------------- oracles

    @property
    def items_at_start(self) -> np.ndarray:
        """True item factors at round 0 (the frozen-index catalog)."""
        return self._items0.copy()

    def true_topk(self, kappa: int, users: np.ndarray | None = None
                  ) -> np.ndarray:
        """(Q, kappa) ids of the true current top-kappa per user, with the
        service tier's total order (score desc, catalog id asc)."""
        u = self.users if users is None else np.asarray(users, np.float32)
        scores = u @ self.items.T
        # lexsort on (-score, id): stable ascending id within equal score
        order = np.argsort(-scores, axis=1, kind="stable")
        return order[:, :kappa].astype(np.int64)

    @staticmethod
    def recall(got_ids: np.ndarray, true_ids: np.ndarray) -> float:
        """Mean fraction of the true top-kappa present in the answer."""
        got_ids = np.asarray(got_ids)
        true_ids = np.asarray(true_ids)
        hits = sum(np.intersect1d(g, t).size
                   for g, t in zip(got_ids, true_ids))
        return float(hits / true_ids.size)
