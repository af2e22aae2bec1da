"""PushPolicy: the geometry-aware publisher between a streaming trainer and
a live retriever (a copy of ``repro.online.push`` over the port's retriever
contract; numpy only).

The paper's mapping assigns sparsity patterns by *angular* position on the
tessellated sphere, so a re-trained factor only needs a re-map + upsert
when it has rotated far enough to plausibly cross a cell boundary.  The
policy exploits exactly that: an offered factor is pushed when

* it has never been pushed (cold-start item), or
* ``cos(candidate, last_pushed) < min_cos`` — the angular-drift gate, or
* it has been dirty longer than the ``staleness_s`` budget — drift *rate*
  below the gate still reaches the index eventually, bounding how stale a
  served factor can get.

Suppressed candidates stay pending (their dirty clocks keep running), so
the staleness budget is a hard bound, not a hint.  ``flush()`` resolves
duplicate offers through the retriever contract's ``dedupe_last_write``
(last write wins — the same semantics every upsert batch has) and lands
the survivors in ONE ``retriever.upsert`` call, which routes them through
the delta segment + incremental MapCache like any other live mutation.
Policy state (`last_pushed`, dirty clocks, the pending set) only mutates
after the upsert returns, so an injected fault leaves the policy
consistent and the batch retryable.

Pushes, suppressions and the staleness-at-push distribution are recorded
in ``ServiceMetrics`` (``push_total`` / ``push_suppressed`` /
``push_flushes`` / ``push_staleness_seconds``), each flush runs under a
``push`` trace span, and the retriever's ``EventJournal`` receives a
``factor_push`` entry — all auto-wired from the retriever when it exposes
``metrics`` / ``tracer`` / ``events`` attributes (the sharded tiers do).
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.retriever.types import dedupe_last_write

__all__ = ["PushPolicy"]


def _cos(a: np.ndarray, b: np.ndarray) -> float:
    na = float(np.linalg.norm(a))
    nb = float(np.linalg.norm(b))
    if na == 0.0 or nb == 0.0:
        return 1.0 if na == nb else 0.0
    return float(np.dot(a, b) / (na * nb))


class PushPolicy:
    def __init__(self, retriever, *, min_cos: float = 0.995,
                 staleness_s: float = 60.0, clock=None, metrics=None,
                 tracer=None, events=None):
        self.retriever = retriever     # rebindable (e.g. after a restore)
        self.min_cos = float(min_cos)
        self.staleness_s = float(staleness_s)
        self.clock = clock if clock is not None else getattr(
            retriever, "clock", time.monotonic)
        self.metrics = (metrics if metrics is not None
                        else getattr(retriever, "metrics", None))
        self.tracer = (tracer if tracer is not None
                       else getattr(retriever, "tracer", None))
        self.events = (events if events is not None
                       else getattr(retriever, "events", None))
        self._last_pushed: dict[int, np.ndarray] = {}
        self._dirty_since: dict[int, float] = {}
        self._pending: list[tuple[int, np.ndarray]] = []
        self.n_offered = 0
        self.n_pushed = 0
        self.n_suppressed = 0
        self.n_flushes = 0

    # ------------------------------------------------------------- producing

    def seed(self, ids, factors) -> None:
        """Register factors already in the index (the initial catalog) as
        pushed, without pushing — the angular gate then measures drift
        against what the retriever actually serves."""
        factors = np.asarray(factors, np.float32)
        for i, f in zip(np.asarray(ids, np.int64), factors):
            self._last_pushed[int(i)] = f.copy()

    def offer(self, ids, factors) -> int:
        """Queue re-trained factors as push candidates (in offer order, so
        a flush resolves duplicates last-write-wins).  Returns the number
        queued."""
        ids = np.asarray(ids, np.int64).ravel()
        factors = np.asarray(factors, np.float32)
        if factors.ndim != 2 or factors.shape[0] != ids.size:
            raise ValueError(f"factors shape {factors.shape} does not match "
                             f"{ids.size} ids")
        now = self.clock()
        for i, f in zip(ids, factors):
            i = int(i)
            self._pending.append((i, f.copy()))
            self._dirty_since.setdefault(i, now)
        self.n_offered += int(ids.size)
        return int(ids.size)

    @property
    def pending_ids(self) -> np.ndarray:
        """Distinct ids currently awaiting a push decision."""
        return np.unique(np.asarray([i for i, _ in self._pending], np.int64))

    # -------------------------------------------------------------- flushing

    def _gate(self, i: int, fac: np.ndarray, now: float,
              force: bool) -> tuple[bool, float, str]:
        age = now - self._dirty_since.get(i, now)
        last = self._last_pushed.get(i)
        if force:
            return True, age, "forced"
        if last is None:
            return True, age, "cold"
        if _cos(fac, last) < self.min_cos:
            return True, age, "drift"
        if age >= self.staleness_s:
            return True, age, "stale"
        return False, age, "suppressed"

    def flush(self, force: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """Gate every pending candidate and land the passers in one upsert.

        Returns ``(ids, factors)`` actually pushed (both empty when nothing
        passed the gate).  Suppressed candidates stay pending with their
        dirty clocks intact.  On an upsert failure (e.g. injected fault)
        no policy state has mutated — the whole batch stays pending.
        """
        empty = (np.empty(0, np.int64),
                 np.empty((0, self._dim()), np.float32))
        if not self._pending:
            return empty
        ids = np.asarray([i for i, _ in self._pending], np.int64)
        fac = np.stack([f for _, f in self._pending])
        ids, fac = dedupe_last_write(ids, fac)
        now = self.clock()
        sel, ages = [], []
        for j, i in enumerate(ids):
            push, age, _why = self._gate(int(i), fac[j], now, force)
            if push:
                sel.append(j)
                ages.append(age)
        n_sup = ids.size - len(sel)
        if sel:
            p_ids, p_fac = ids[sel], fac[sel]
            tracer = self.tracer
            if tracer is not None:
                with tracer.trace_or_span("push", n=len(sel),
                                          suppressed=n_sup):
                    self.retriever.upsert(p_ids, p_fac)
            else:
                self.retriever.upsert(p_ids, p_fac)
        else:
            p_ids, p_fac = empty
        # ---- the upsert landed (or nothing passed): now mutate state
        pushed_set = {int(i) for i in p_ids}
        for i, f in zip(p_ids, p_fac):
            self._last_pushed[int(i)] = f.copy()
            self._dirty_since.pop(int(i), None)
        self._pending = [(int(i), fac[j]) for j, i in enumerate(ids)
                         if int(i) not in pushed_set]
        self.n_pushed += len(sel)
        self.n_suppressed += n_sup
        self.n_flushes += 1
        if self.metrics is not None and hasattr(self.metrics, "record_push"):
            self.metrics.record_push(len(sel), n_sup, staleness_s=ages)
        if self.events is not None and (sel or n_sup):
            self.events.emit("factor_push", n=len(sel), suppressed=n_sup,
                             forced=bool(force))
        return p_ids, p_fac

    def _dim(self) -> int:
        if self._pending:
            return int(self._pending[0][1].shape[0])
        for f in self._last_pushed.values():
            return int(f.shape[0])
        return 0

    def stats(self) -> dict:
        return {"offered": self.n_offered, "pushed": self.n_pushed,
                "suppressed": self.n_suppressed, "flushes": self.n_flushes,
                "pending": len(self.pending_ids),
                "tracked": len(self._last_pushed),
                "suppression_rate": (self.n_suppressed
                                     / max(self.n_suppressed + self.n_pushed,
                                           1))}
