"""Service observability: QPS, latency percentiles, occupancy, discard,
shard/block balance and maintenance (compaction / repartition) counters.

Pure-Python accumulation (no jax) so it can be updated from the request path
without touching device state; ``snapshot()`` renders the dict that
``launch/serve.py --service`` prints and ``benchmarks/service_bench.py``
records.  The per-shard and per-block candidate accumulators double as the
load signal the :class:`~repro_torch.service.repartition.Repartitioner` reads:
``shard_skew()`` / ``block_skew()`` (max/mean) decide when a rebalancing
compaction is worth scheduling.

Latency / queue-wait / service-time / occupancy / discard distributions live
in fixed log-spaced-bucket :class:`~repro_torch.obs.histogram.LogHistogram`\\ s:
O(bins) memory over any run length (the old windowed sample lists re-sliced
O(max_samples) on every record), and :meth:`merge` folds two metrics objects
associatively — per-batch, per-shard or per-host — which is what makes the
snapshot collective-safe on the multi-host tier.  Percentile keys are
unchanged (``latency_p50_ms``/``latency_p99_ms``); their values are now
bucketed approximations with ~2% relative error (``LogHistogram.latency``).
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch.obs.histogram import LogHistogram

__all__ = ["ServiceMetrics"]


class ServiceMetrics:
    def __init__(self, clock=time.monotonic):
        self._clock = clock
        self.reset()

    def reset(self) -> None:
        """Zero every counter and restart the QPS clock (e.g. after jit
        warm-up, so steady-state numbers exclude build/compile time)."""
        self._t0 = self._clock()
        self.n_requests = 0
        self.n_batches = 0
        self.n_upserts = 0
        self.n_deletes = 0
        self.n_compactions = 0
        self.n_async_compactions = 0
        self.n_compact_slices = 0
        self.n_compact_aborts = 0
        self.n_repartitions = 0
        self.n_failovers = 0                   # slice reroutes after mark_down
        # ----------------------------------------------------------- QoS
        self.n_shed = 0                        # typed request sheds, total
        self.n_shed_queue_full = 0             # admission-control rejections
        self.n_shed_deadline = 0               # queue-wait budget expirations
        self.n_shed_no_live_replica = 0        # serve-loop NoLiveReplica sheds
        self.shed_by_class = {}                # priority class -> shed count
        self.n_evicted = 0                     # uncollected results evicted
        self.n_degraded = 0                    # queries answered degraded
        self.n_degraded_skip_exact = 0
        self.n_degraded_raise_overlap = 0
        self.n_degraded_base_only = 0
        self.n_hedges = 0                      # hedged slice reads issued
        self.n_hedge_wins = 0                  # hedge answered first
        self.n_breaker_opens = 0
        self.n_breaker_probes = 0
        self.n_breaker_closes = 0
        # ------------------------------------------------------ result cache
        self.n_cache_hits = 0                  # queries answered from cache
        self.n_cache_misses = 0                # lookups that fell through
        self.n_cache_evictions = 0             # LRU capacity evictions
        self.n_cache_invalidations = 0         # generation/TTL-stale drops
        # -------------------------------------------------- online learning
        self.n_pushes = 0                      # factor pushes landed
        self.n_push_suppressed = 0             # angular gate said "not yet"
        self.n_push_flushes = 0                # PushPolicy.flush() calls
        self.last_repartition_skew = None      # shard skew that triggered it
        self._host_queries = None              # (H,) queries served per host
        self.latency_hist = LogHistogram.latency()      # s, per request
        self.queue_wait_hist = LogHistogram.latency()   # s, enqueue -> flush
        self.service_hist = LogHistogram.latency()      # s, flush -> done
        self.occupancy_hist = LogHistogram.fraction()   # real/padded, batch
        self.discard_hist = LogHistogram.fraction()     # frac, per request
        self.push_staleness_hist = LogHistogram.latency()  # s dirty -> push
        self._shard_cand = None                # (S,) accumulated candidates
        self._block_cand = None                # (n_blocks,) accumulated

    def histograms(self) -> dict[str, LogHistogram]:
        """Named distribution map, as the exporters consume it."""
        return {"latency_seconds": self.latency_hist,
                "queue_wait_seconds": self.queue_wait_hist,
                "service_seconds": self.service_hist,
                "occupancy": self.occupancy_hist,
                "discard": self.discard_hist,
                "push_staleness_seconds": self.push_staleness_hist}

    # ---------------------------------------------------------- recording

    def record_batch(self, n_real: int, batch_size: int, latencies_s,
                     queue_waits_s=None, service_s: float | None = None
                     ) -> None:
        """One fired microbatch: per-request total latencies, plus the
        queue-wait / service-time split when the batcher provides it
        (queue wait = enqueue to flush start, service = the batch's shared
        query-fn time; total = wait + service per request)."""
        self.n_requests += n_real
        self.n_batches += 1
        self.occupancy_hist.record(n_real / max(batch_size, 1))
        self.latency_hist.record_many(latencies_s)
        if queue_waits_s is not None:
            self.queue_wait_hist.record_many(queue_waits_s)
        if service_s is not None:
            self.service_hist.record(float(service_s))

    def record_query_stats(self, discard_fracs=None,
                           shard_candidates=None,
                           block_candidates=None) -> None:
        if discard_fracs is not None:
            self.discard_hist.record_many(discard_fracs)
        if shard_candidates is not None:
            sc = np.asarray(shard_candidates, np.float64)
            if sc.ndim == 2:                   # (Q, S) -> per-shard totals
                sc = sc.sum(axis=0)
            # a repartition changes S: restart the accumulation window
            if self._shard_cand is not None and \
                    self._shard_cand.shape != sc.shape:
                self._shard_cand = None
            self._shard_cand = (sc if self._shard_cand is None
                                else self._shard_cand + sc)
        if block_candidates is not None:
            bc = np.asarray(block_candidates, np.float64)
            if bc.ndim == 2:                   # (Q, n_blocks) -> totals
                bc = bc.sum(axis=0)
            if self._block_cand is not None and \
                    self._block_cand.shape != bc.shape:
                self._block_cand = None
            self._block_cand = (bc if self._block_cand is None
                                else self._block_cand + bc)

    def record_upsert(self, n: int) -> None:
        self.n_upserts += int(n)

    def record_delete(self, n: int) -> None:
        self.n_deletes += int(n)

    def record_compact(self, async_: bool = False) -> None:
        self.n_compactions += 1
        if async_:
            self.n_async_compactions += 1

    def record_compact_slice(self) -> None:
        self.n_compact_slices += 1

    def record_compact_abort(self) -> None:
        self.n_compact_aborts += 1

    def record_host_queries(self, per_host) -> None:
        """(H,) queries served per host for one batch — the multi-host
        load-balance signal (window restarts when H changes)."""
        ph = np.asarray(per_host, np.float64)
        if self._host_queries is not None and \
                self._host_queries.shape != ph.shape:
            self._host_queries = None
        self._host_queries = (ph if self._host_queries is None
                              else self._host_queries + ph)

    def record_failover(self, n: int = 1) -> None:
        """Placement slices rerouted to a surviving replica by mark_down."""
        self.n_failovers += int(n)

    def record_shed(self, reason: str, priority: int = 0) -> None:
        """One typed request shed: ``queue_full`` (admission control),
        ``deadline`` (queue-wait budget expired before service) or
        ``no_live_replica`` (serve-loop shed on an unservable slice)."""
        self.n_shed += 1
        if reason == "queue_full":
            self.n_shed_queue_full += 1
        elif reason == "deadline":
            self.n_shed_deadline += 1
        elif reason == "no_live_replica":
            self.n_shed_no_live_replica += 1
        p = int(priority)
        self.shed_by_class[p] = self.shed_by_class.get(p, 0) + 1

    def record_evicted(self, n: int = 1) -> None:
        """Finished results dropped by the microbatcher's max_results bound
        before the client collected them."""
        self.n_evicted += int(n)

    def record_degraded(self, rung: str) -> None:
        """One query answered via the degrade ladder; ``rung`` is the
        deepest rung that fired (repro.service.qos.DEGRADE_RUNGS)."""
        self.n_degraded += 1
        if rung == "skip_exact":
            self.n_degraded_skip_exact += 1
        elif rung == "raise_overlap":
            self.n_degraded_raise_overlap += 1
        elif rung == "base_only":
            self.n_degraded_base_only += 1

    def record_hedge(self, won: bool) -> None:
        """One hedged slice read issued; ``won`` iff the hedge answered
        before the primary (either way the answer is bit-identical —
        replicas are exact copies)."""
        self.n_hedges += 1
        if won:
            self.n_hedge_wins += 1

    def record_breaker(self, event: str) -> None:
        """Circuit-breaker lifecycle: ``open`` / ``probe`` / ``close``."""
        if event == "open":
            self.n_breaker_opens += 1
        elif event == "probe":
            self.n_breaker_probes += 1
        elif event == "close":
            self.n_breaker_closes += 1

    def record_cache_event(self, event: str, n: int = 1) -> None:
        """Result-cache lifecycle: ``hit`` / ``miss`` / ``eviction`` (LRU
        capacity) / ``invalidation`` (a generation- or TTL-stale entry
        dropped at lookup).  Mirrored from
        :class:`~repro_torch.service.result_cache.ResultCache`."""
        if event == "hit":
            self.n_cache_hits += int(n)
        elif event == "miss":
            self.n_cache_misses += int(n)
        elif event == "eviction":
            self.n_cache_evictions += int(n)
        elif event == "invalidation":
            self.n_cache_invalidations += int(n)

    def record_cached_request(self, latency_s: float) -> None:
        """One request answered straight from the result cache (the
        microbatcher's pre-queue probe): counts toward QPS and the latency
        distribution but is not a batch — occupancy stays honest."""
        self.n_requests += 1
        self.latency_hist.record(float(latency_s))

    def record_push(self, n_pushed: int, n_suppressed: int = 0,
                    staleness_s=None) -> None:
        """One PushPolicy flush: ``n_pushed`` factors landed via upsert,
        ``n_suppressed`` held back by the angular gate, ``staleness_s``
        the dirty-to-push ages of the pushed factors."""
        self.n_push_flushes += 1
        self.n_pushes += int(n_pushed)
        self.n_push_suppressed += int(n_suppressed)
        if staleness_s is not None:
            self.push_staleness_hist.record_many(staleness_s)

    def record_repartition(self, skew_before: float | None = None) -> None:
        self.n_repartitions += 1
        if skew_before is not None:
            self.last_repartition_skew = float(skew_before)
        # the load windows describe the PRE-rebalance layout; restart them so
        # the trigger measures the new partition (otherwise a stale skew
        # statistic re-fires the repartition on every poll)
        self._shard_cand = None
        self._block_cand = None

    # ------------------------------------------------------------ merging

    def merge(self, other: "ServiceMetrics") -> "ServiceMetrics":
        """Fold ``other`` into self (in place; returns self): counters add,
        histograms merge bucket-wise (associative), the elapsed window
        starts at the earlier ``reset`` — so per-shard or per-host metrics
        objects reduce to one deployment-wide snapshot in any merge order.
        Shape-tracked accumulator windows (shard/block/host load) only fold
        when the layouts match; otherwise the larger view wins."""
        self._t0 = min(self._t0, other._t0)
        for name in ("n_requests", "n_batches", "n_upserts", "n_deletes",
                     "n_compactions", "n_async_compactions",
                     "n_compact_slices", "n_compact_aborts",
                     "n_repartitions", "n_failovers",
                     "n_shed", "n_shed_queue_full", "n_shed_deadline",
                     "n_shed_no_live_replica", "n_evicted",
                     "n_degraded", "n_degraded_skip_exact",
                     "n_degraded_raise_overlap", "n_degraded_base_only",
                     "n_hedges", "n_hedge_wins", "n_breaker_opens",
                     "n_breaker_probes", "n_breaker_closes",
                     "n_cache_hits", "n_cache_misses", "n_cache_evictions",
                     "n_cache_invalidations",
                     "n_pushes", "n_push_suppressed", "n_push_flushes"):
            setattr(self, name, getattr(self, name) + getattr(other, name))
        for p, n in other.shed_by_class.items():
            self.shed_by_class[p] = self.shed_by_class.get(p, 0) + n
        if other.last_repartition_skew is not None:
            self.last_repartition_skew = other.last_repartition_skew
        mine, theirs = self.histograms(), other.histograms()
        for key in mine:
            mine[key].merge(theirs[key])
        for name in ("_shard_cand", "_block_cand", "_host_queries"):
            a, b = getattr(self, name), getattr(other, name)
            if a is None:
                setattr(self, name, None if b is None else b.copy())
            elif b is not None and a.shape == b.shape:
                setattr(self, name, a + b)
        return self

    # ---------------------------------------------------------- load signal

    @property
    def shard_candidates(self) -> np.ndarray | None:
        """(S,) accumulated per-shard candidate totals (None pre-traffic)."""
        return self._shard_cand

    @property
    def block_candidates(self) -> np.ndarray | None:
        """(n_blocks,) accumulated per-block candidate totals."""
        return self._block_cand

    @staticmethod
    def _skew(loads) -> float | None:
        if loads is None or loads.sum() <= 0:
            return None
        return float(loads.max() / loads.mean())

    def shard_skew(self) -> float | None:
        """max/mean of the accumulated per-shard candidate load — the
        repartition trigger statistic (None before any traffic)."""
        return self._skew(self._shard_cand)

    @property
    def host_queries(self) -> np.ndarray | None:
        """(H,) accumulated queries served per host (None pre-traffic)."""
        return self._host_queries

    def host_skew(self) -> float | None:
        return self._skew(self._host_queries)

    def block_skew(self) -> float | None:
        return self._skew(self._block_cand)

    # ---------------------------------------------------------- reporting

    @staticmethod
    def _pct_ms(hist: LogHistogram, p: float) -> float | None:
        v = hist.percentile(p)
        return None if v is None else v * 1e3

    def snapshot(self) -> dict:
        elapsed = max(self._clock() - self._t0, 1e-9)
        return {
            "elapsed_s": float(elapsed),
            "n_requests": self.n_requests,
            "n_batches": self.n_batches,
            "qps": self.n_requests / elapsed,
            "latency_p50_ms": self._pct_ms(self.latency_hist, 50),
            "latency_p99_ms": self._pct_ms(self.latency_hist, 99),
            "queue_wait_p50_ms": self._pct_ms(self.queue_wait_hist, 50),
            "queue_wait_p99_ms": self._pct_ms(self.queue_wait_hist, 99),
            "service_p50_ms": self._pct_ms(self.service_hist, 50),
            "service_p99_ms": self._pct_ms(self.service_hist, 99),
            "occupancy_mean": self.occupancy_hist.mean,   # exact running mean
            "discard_mean": self.discard_hist.mean,
            "shard_balance": self.shard_skew(),  # max/mean candidate load
            "block_balance": self.block_skew(),
            "n_upserts": self.n_upserts,
            "n_deletes": self.n_deletes,
            "n_compactions": self.n_compactions,
            "n_async_compactions": self.n_async_compactions,
            "n_compact_slices": self.n_compact_slices,
            "n_compact_aborts": self.n_compact_aborts,
            "n_repartitions": self.n_repartitions,
            "last_repartition_skew": self.last_repartition_skew,
            "n_failovers": self.n_failovers,
            "host_load": (self._host_queries.tolist()
                          if self._host_queries is not None else None),
            "host_balance": self.host_skew(),
            # QoS counters: flat scalars so the Prometheus exporter renders
            # every one as a repro_* gauge (shed_by_class is a dict and
            # deliberately JSONL-only)
            "shed_total": self.n_shed,
            "shed_queue_full": self.n_shed_queue_full,
            "shed_deadline": self.n_shed_deadline,
            "shed_no_live_replica": self.n_shed_no_live_replica,
            "shed_by_class": {str(p): n
                              for p, n in sorted(self.shed_by_class.items())},
            "evicted_total": self.n_evicted,
            "degraded_total": self.n_degraded,
            "degraded_skip_exact": self.n_degraded_skip_exact,
            "degraded_raise_overlap": self.n_degraded_raise_overlap,
            "degraded_base_only": self.n_degraded_base_only,
            "hedge_issued": self.n_hedges,
            "hedge_wins": self.n_hedge_wins,
            "breaker_opens": self.n_breaker_opens,
            "breaker_probes": self.n_breaker_probes,
            "breaker_closes": self.n_breaker_closes,
            # result cache: flat scalars -> repro_cache_* gauges; hit_rate
            # None until the first lookup (exporter skips None)
            "cache_hits": self.n_cache_hits,
            "cache_misses": self.n_cache_misses,
            "cache_evictions": self.n_cache_evictions,
            "cache_invalidations": self.n_cache_invalidations,
            "cache_hit_rate": (
                self.n_cache_hits / (self.n_cache_hits + self.n_cache_misses)
                if self.n_cache_hits + self.n_cache_misses else None),
            # online-learning publisher (PushPolicy); staleness is the
            # dirty-to-push age distribution of landed factors
            "push_total": self.n_pushes,
            "push_suppressed": self.n_push_suppressed,
            "push_flushes": self.n_push_flushes,
            "push_staleness_p50_s": self.push_staleness_hist.percentile(50),
            "push_staleness_p99_s": self.push_staleness_hist.percentile(99),
        }
