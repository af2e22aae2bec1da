"""Exact hot-query result cache with generation-tag invalidation.

Production retrieval traffic is heavily Zipf-skewed: a small set of hot
queries accounts for most requests (the regime "Efficient Inner Product
Approximation in Hybrid Spaces" targets).  :class:`ResultCache` memoizes
``(query-row bytes, kappa, exact, min_overlap) -> top-kappa`` so a repeated
hot query skips the phi-map, both kernel launches and the merge entirely —
the QoS ladder's true zero-cost rung.

Exactness is by construction, never by TTL guesswork:

* **Keys are the raw query bytes.**  No hashing of float vectors into
  buckets — two queries collide only when their f32 rows are bit-identical,
  in which case the cached answer IS the recomputed answer.
* **Entries are generation-tagged.**  Every catalog mutation on the owning
  retriever (upsert, delete, compaction swap, repartition, restore, factor
  push — pushes land as upserts) bumps :attr:`version`; a lookup whose
  entry carries any older version is a miss and the entry is dropped
  (counted as an invalidation).  A stale hit is therefore impossible: the
  cache can only ever return a result computed against the *current*
  catalog state, which is why cached answers are bit-identical to the
  uncached path at every step of a mutation stream (pinned by the
  ``cached_query`` op of the lifecycle property suite).

Capacity is a plain LRU bound; ``ttl_s`` optionally ages entries out on the
injected clock (latency hygiene only — correctness never depends on it, and
SPMD multi-host deployments should leave it ``None`` so per-host caches
stay in deterministic lockstep; see ``docs/load_testing.md``).

Counters (hits / misses / evictions / invalidations) are mirrored into an
attached :class:`~repro_torch.service.metrics.ServiceMetrics` via
``record_cache_event``, which is how they reach the Prometheus exporter.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict

import numpy as np

__all__ = ["CachedResult", "ResultCache"]


@dataclasses.dataclass(frozen=True)
class CachedResult:
    """One memoized query row, exactly as the uncached path returned it."""
    ids: np.ndarray             # (kappa,) catalog ids, -1 pads
    scores: np.ndarray          # (kappa,) f32, -inf pads
    n_scored: int               # candidates scored for this row
    discarded_frac: float       # 1 - n_scored / n_live at compute time
    version: int                # cache generation the row was computed under
    t_insert: float             # clock() at insert (TTL bookkeeping)


class ResultCache:
    def __init__(self, capacity: int, ttl_s: float | None = None, *,
                 clock=time.monotonic, metrics=None):
        if capacity < 1:
            raise ValueError("ResultCache capacity must be >= 1 "
                             "(capacity 0 means: do not construct one)")
        self.capacity = int(capacity)
        self.ttl_s = None if ttl_s is None else float(ttl_s)
        self.clock = clock
        self.metrics = metrics          # ServiceMetrics or None
        self._entries: OrderedDict[tuple, CachedResult] = OrderedDict()
        self.version = 0                # bumped by every catalog mutation
        self.n_hits = 0
        self.n_misses = 0
        self.n_evictions = 0
        self.n_invalidations = 0        # stale entries dropped (version/TTL)

    # ------------------------------------------------------------- keying

    @staticmethod
    def key(row: np.ndarray, kappa: int, exact: bool) -> tuple:
        """Cache key for one query row: the row's exact f32 bytes plus every
        result-bearing query knob.  Spec-level result knobs (min_overlap,
        bucket, quantize, ...) need no slot here — they are frozen per
        retriever and each retriever owns its cache."""
        return (np.asarray(row, np.float32).tobytes(), int(kappa),
                bool(exact))

    # ------------------------------------------------------------- lookup

    def _live(self, key: tuple) -> CachedResult | None:
        """The entry for ``key`` iff it is current — no hit/miss accounting.
        Entries from an older version (or past TTL) are dropped here and
        counted as invalidations: generation mismatch ⇒ miss, by
        construction."""
        row = self._entries.get(key)
        if row is None:
            return None
        if row.version != self.version or (
                self.ttl_s is not None
                and self.clock() - row.t_insert > self.ttl_s):
            del self._entries[key]
            self.n_invalidations += 1
            self._emit("invalidation")
            return None
        return row

    def get(self, key: tuple, *, count_miss: bool = True
            ) -> CachedResult | None:
        """Counting single-row lookup.  ``count_miss=False`` makes a probe
        that records a hit but not a miss (the microbatcher probes before
        enqueueing; a queued row is counted by the retriever's own
        lookup)."""
        row = self._live(key)
        if row is None:
            if count_miss:
                self.n_misses += 1
                self._emit("miss")
            return None
        self._entries.move_to_end(key)
        self.n_hits += 1
        self._emit("hit")
        return row

    def get_batch(self, keys: list[tuple]) -> list[CachedResult] | None:
        """All-or-nothing lookup: the rows iff EVERY key is live (counted as
        ``len(keys)`` hits), else None (``len(keys)`` misses).  A partially
        cached batch cannot skip the fixed-shape kernel launch, so it is a
        miss for every row — accounting matches the work actually saved."""
        rows = [self._live(k) for k in keys]
        if any(r is None for r in rows):
            self.n_misses += len(keys)
            self._emit("miss", len(keys))
            return None
        for k in keys:
            self._entries.move_to_end(k)
        self.n_hits += len(keys)
        self._emit("hit", len(keys))
        return rows

    def put(self, key: tuple, ids: np.ndarray, scores: np.ndarray,
            n_scored: int, discarded_frac: float) -> None:
        """Memoize one computed row under the CURRENT version.  The arrays
        are copied so later in-place edits by the caller cannot corrupt the
        memo (cached answers must stay bit-identical)."""
        self._entries[key] = CachedResult(
            ids=np.array(ids, np.int64), scores=np.array(scores, np.float32),
            n_scored=int(n_scored), discarded_frac=float(discarded_frac),
            version=self.version, t_insert=self.clock())
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.n_evictions += 1
            self._emit("eviction")

    # -------------------------------------------------------- invalidation

    def bump(self) -> int:
        """Advance the cache generation — every entry computed before this
        instant becomes unreturnable.  Called by the owning retriever on
        EVERY catalog mutation; returns the new version."""
        self.version += 1
        return self.version

    # ---------------------------------------------------------- reporting

    def _emit(self, event: str, n: int = 1) -> None:
        if self.metrics is not None:
            self.metrics.record_cache_event(event, n)

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def hit_rate(self) -> float | None:
        total = self.n_hits + self.n_misses
        return None if total == 0 else self.n_hits / total

    def stats(self) -> dict:
        return {"capacity": self.capacity, "size": len(self._entries),
                "version": self.version, "hits": self.n_hits,
                "misses": self.n_misses, "evictions": self.n_evictions,
                "invalidations": self.n_invalidations,
                "hit_rate": self.hit_rate}
