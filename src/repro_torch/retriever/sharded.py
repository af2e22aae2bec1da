"""``sharded`` backend: the streaming service tier behind the unified API.

Counterpart of ``repro.retriever.sharded``, on one torch device (the card
unless the caller asks for the CPU): the base segment's posting tables,
bitsets and factor slabs, the delta and the query batch live there, and
every query launches ``gam_retrieve`` once per bn-group plus once for a
non-empty delta.  ``mesh=`` (``launch.mesh.make_index_mesh``) places the
base over the ranks of an ``items`` mesh instead (``ShardedGamIndex``):
each rank holds and scans its own shards and the ranks merge, so every
rank, driven alike (SPMD), answers as one device would; the delta and the
host catalog stay whole on every rank.  ``sharded-multihost``
(``retriever/multihost.py``) subclasses this backend to place it over host
processes.

Owns the three storage tiers and the request plumbing that used to live in
``service.GamService`` (now a deprecation shim over this class):

  * ``ShardedGamIndex`` — the compacted main segment, item-axis sharded
    according to a (possibly skew-aware) ``Partition``;
  * ``DeltaSegment``    — streamed upserts/deletes since the last compact;
  * a host-side catalog (id -> factor) that is the source of truth
    ``compact()`` rebuilds from;

plus ``ServiceMetrics``, a ``Microbatcher`` front-end (``.batcher``) and the
maintenance subsystem: a background ``CompactionPlanner`` (started by
``compact(async_=True)``, advanced one bounded slice per query or via
``compaction_step``) and a ``Repartitioner`` (``repartition()`` /
``maybe_rebalance()``) that rebalances skewed catalogs by re-cutting the
shard boundaries and per-shard kernel block widths.

Query = map the user batch with phi once, stream base + delta through the
fused ``gam_retrieve`` kernel, then a deterministic merge ordered by
(score desc, catalog id asc) — the same total order a fresh rebuild's
``lax.top_k`` induces, which is what makes upsert-then-query ==
rebuild-then-query (and snapshot -> restore -> query) testable to the bit.

Background compaction keeps that exactness at every intermediate step:
while the planner builds the replacement segment in slices, queries keep
answering from (old segment ∪ delta); mutations feed the live delta AND the
planner's journal; the swap is one reference assignment whose replayed
journal lands the service in exactly the state a fresh build over the
current catalog would produce.  ``generation`` counts completed swaps.

``snapshot`` persists the whole deployment object through
``repro_torch.checkpoint``, in the reference's format (bitsets as uint32,
so files cross between the packages both ways): per-shard posting tables,
the flat factor matrix, the partition, alive tombstones, the fused kernel's
per-group bit-packed patterns and block-union metadata, the live delta
catalog and the serving generation — a restored service answers queries
bit-identically, including between compactions.  A snapshot taken
MID-compaction persists only the stable serving state (the planner is
shadow state), so ``restore`` always lands in a consistent generation with
no half-swapped segment observable.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.compress.postings import CompressedPostings, decode_postings, \
    encode_postings
from repro_torch.core.inverted_index import csr_to_table, table_to_csr
from repro_torch.core.mapping import sparse_map
from repro_torch.kernels.gam_retrieve import RetrievalMeta
from repro_torch.kernels.gam_score import NEG
from repro_torch.obs.events import EventJournal
from repro_torch.retriever.api import Retriever, RetrieverSpec, spec_tracer
from repro_torch.retriever.convert import _bits
from repro_torch.retriever.snapshot import read_snapshot, write_snapshot
from repro_torch.retriever.types import RetrievalResult, UnsupportedOp
from repro_torch.service.compaction import CompactionPlanner
from repro_torch.service.delta import DeltaSegment
from repro_torch.service.faults import FaultInjected
from repro_torch.service.metrics import ServiceMetrics
from repro_torch.service.microbatch import Microbatcher
from repro_torch.service.qos import QosPolicy
from repro_torch.service.repartition import MapCache, Partition, Repartitioner
from repro_torch.service.result_cache import ResultCache
from repro_torch.service.sharded_index import ShardedGamIndex, index_mesh

__all__ = ["ShardedRetriever"]

_PAD_ID = np.int64(2**62)      # sorts after every real id on score ties


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class ShardedRetriever(Retriever):
    def __init__(self, spec: RetrieverSpec, device: torch.device, *,
                 mesh=None, clock=time.monotonic, tracer=None, qos=None,
                 faults=None):
        super().__init__(spec, device)
        self.mesh = index_mesh(mesh)
        self.clock = clock
        # QoS policy: injected, spec-option-driven, or the no-op default;
        # the fault injector is None outside chaos runs
        self.qos: QosPolicy = (qos if qos is not None
                               else QosPolicy.from_spec(spec))
        self.faults = faults
        self._cost_est: float | None = None    # EWMA full-query seconds
        self.catalog: dict[int, np.ndarray] = {}
        self.metrics = ServiceMetrics(clock)
        self.tracer = spec_tracer(spec, tracer, clock)
        # flight recorder of lifecycle events (compaction phases,
        # repartitions, failovers); named `events` — `journal` is taken by
        # the CompactionPlanner's mutation-replay log
        self.events = EventJournal(
            capacity=int(spec.opt("event_capacity", 1024)), clock=clock)
        self.generation = 0            # completed segment swaps (sync+async)
        self._planner: CompactionPlanner | None = None
        self._rebalanced = False       # a repartition plan governs the layout
        self.repartitioner = Repartitioner(
            target_blocks=int(spec.opt("rebalance_target_blocks", 8)))
        # incremental phi-map cache: repartitions re-map only changed items
        self._map_cache = MapCache(spec.cfg, device=device)
        self.base = self._build_base(
            np.zeros((0, spec.cfg.k), np.float32), np.zeros(0, np.int64))
        self.delta = DeltaSegment(
            spec.cfg, spec.min_overlap,
            spec.bucket if spec.delta_bucket is None else spec.delta_bucket,
            quantize=spec.quantize, rerank_factor=spec.rerank_factor,
            device=device)
        # hot-query result cache (spec.cache_capacity > 0): exact memo of
        # per-row top-kappa, invalidated by generation tag on EVERY catalog
        # mutation — see repro_torch.service.result_cache.  Per-instance, so
        # the multi-host backend gets one cache per host process for free.
        self.cache: ResultCache | None = (
            ResultCache(int(spec.cache_capacity), spec.cache_ttl_s,
                        clock=clock, metrics=self.metrics)
            if int(spec.cache_capacity) > 0 else None)
        self.batcher = Microbatcher(
            self._batch_query_fn, spec.cfg.k, batch_size=spec.batch_size,
            max_delay_s=spec.max_delay_s, clock=clock, metrics=self.metrics,
            tracer=self.tracer, policy=self.qos, events=self.events,
            cache_probe=(self.cache_probe if self.cache is not None
                         else None))
        self._last_query_stats: dict = {}

    def _build_base(self, factors: np.ndarray, ids: np.ndarray,
                    partition: Partition | None = None,
                    premapped=None) -> ShardedGamIndex:
        return ShardedGamIndex.build(
            factors, self.spec.cfg, item_ids=ids,
            n_shards=self.spec.n_shards, min_overlap=self.spec.min_overlap,
            bucket=self.spec.bucket, mesh=self.mesh, partition=partition,
            premapped=premapped, quantize=self.spec.quantize,
            rerank_factor=self.spec.rerank_factor, device=self.device)

    def _adopt_base(self, base) -> None:
        """Install a freshly built main segment (the swap point shared by
        background compaction and restore).  Subclasses that serve the base
        tier through a different placement (``sharded-multihost``) wrap the
        incoming index here."""
        self.base = base

    def _catalog_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """The merged (base ∪ delta) truth as id-sorted arrays."""
        ids = np.fromiter(self.catalog.keys(), np.int64, len(self.catalog))
        ids = np.sort(ids)
        factors = (np.stack([self.catalog[int(i)] for i in ids])
                   if ids.size else np.zeros((0, self.spec.cfg.k), np.float32))
        return ids, factors

    # ------------------------------------------------------------ lifecycle

    def build(self, items, ids=None) -> "ShardedRetriever":
        items = np.asarray(items, np.float32).reshape(-1, self.spec.cfg.k)
        ids = (np.arange(items.shape[0], dtype=np.int64) if ids is None
               else np.asarray(ids, np.int64).ravel())
        if len(np.unique(ids)) != ids.size:
            raise ValueError("item ids must be unique")
        self._planner = None           # a full build supersedes any in-flight
        self._rebalanced = False
        self.catalog = {int(i): f for i, f in zip(ids, items)}
        self._map_cache.clear()
        self._bump_cache()
        self.base = self._build_base(items, ids)
        self.delta.clear()
        return self

    def upsert(self, ids, factors) -> None:
        """Insert or overwrite items; visible to the very next query.
        Under fault injection a dealt delta-apply error raises the typed
        :class:`FaultInjected` BEFORE any state mutates (atomic failure —
        a retry applies cleanly, nothing half-lands)."""
        self._maybe_inject_delta_fault("upsert")
        ids = np.asarray(ids, np.int64).ravel()
        factors = np.asarray(factors, np.float32).reshape(
            ids.size, self.spec.cfg.k)
        for i, f in zip(ids, factors):
            self.catalog[int(i)] = f
        self._map_cache.invalidate(ids)     # changed rows re-map lazily
        self._bump_cache()
        self.base.kill(ids)                 # superseded main rows, if any
        self.delta.upsert(ids, factors)
        if self._planner is not None:       # replayed after the swap
            self._planner.record_upsert(ids, factors)
        self.metrics.record_upsert(ids.size)

    def delete(self, ids) -> None:
        self._maybe_inject_delta_fault("delete")
        ids = np.asarray(ids, np.int64).ravel()
        for i in ids:
            self.catalog.pop(int(i), None)
        self._map_cache.invalidate(ids)
        self._bump_cache()
        self.base.kill(ids)
        self.delta.delete(ids)
        if self._planner is not None:
            self._planner.record_delete(ids)
        self.metrics.record_delete(ids.size)

    def _bump_cache(self) -> None:
        """Invalidate every cached answer: called on EVERY path that can
        change what a query returns — build, upsert, delete, the compaction
        swap (sync and async), repartition and restore.  Factor pushes land
        through :meth:`upsert`, so they are covered too.  The bump is a
        version increment, not a scan: stale entries die lazily at lookup
        (generation mismatch ⇒ miss)."""
        if self.cache is not None:
            self.cache.bump()

    def _maybe_inject_delta_fault(self, op: str) -> None:
        if self.faults is not None and self.faults.roll_delta_error():
            self.events.emit("fault_injected", fault="delta_apply", op=op)
            raise FaultInjected("delta_apply")

    # ------------------------------------------------------- maintenance

    def compact(self, async_: bool = False, *,
                partition: Partition | None = None) -> None:
        """Fold the delta into the main shards.

        Synchronous mode rebuilds in one stop-the-world step (and supersedes
        any in-flight background build); ``async_=True`` starts the
        incremental :class:`CompactionPlanner` instead — subsequent queries
        each advance one bounded slice (or drive it explicitly with
        :meth:`compaction_step`) until the atomic swap.  Queries before,
        during and after return identical results (the delta-segment
        contract, pinned by the lifecycle stress suite).  ``partition``
        overrides the target layout (the repartitioner passes its plan
        through here); with no override, a catalog that was rebalanced keeps
        its skew-aware layout — ordinary compactions re-plan from current
        weights instead of silently reverting to the uniform cut.
        """
        if async_:
            if partition is not None and self._planner is not None:
                self.abort_compaction()   # an explicit layout supersedes the
                                          # in-flight build, never silently lost
            self.start_compaction(partition=partition)
            return
        if self._planner is not None:
            self.abort_compaction()
        ids, factors = self._catalog_arrays()
        premapped = None
        if partition is None:
            partition, premapped = self._maintain_partition(ids, factors)
        self.base = self._build_base(factors, ids, partition=partition,
                                     premapped=premapped)
        self.delta.clear()
        self.generation += 1
        self._bump_cache()
        self.metrics.record_compact()
        self.events.emit("generation_swap", generation=self.generation,
                         sync=True)

    def _maintain_partition(self, ids, factors):
        """Target layout for a compaction with no explicit override: uniform
        normally, but a re-planned balanced cut once the catalog has been
        repartitioned (the tuned layout must survive ordinary compactions).
        Returns ``(partition | None, premapped | None)``."""
        if not self._rebalanced or ids.size == 0:
            return None, None
        weights, tau, mask = self._item_weights(ids, factors)
        return (self.repartitioner.plan(weights, self.spec.n_shards),
                (tau, mask))

    def start_compaction(self, partition: Partition | None = None,
                         slice_rows: int | None = None,
                         premapped=None) -> CompactionPlanner:
        """Freeze the catalog and start the background build (idempotent —
        at most one build in flight; a second call returns the current
        planner).  ``premapped``: optional (tau, mask) of the frozen
        catalog, when the caller already paid the phi-mapping (the
        repartitioner's weights need it anyway) — the planner then skips
        its map phase."""
        if self._planner is not None:
            return self._planner
        ids, factors = self._catalog_arrays()
        if partition is None:
            partition, premapped = self._maintain_partition(ids, factors)
        self._planner = CompactionPlanner(
            self.spec.cfg, ids, factors, partition=partition,
            n_shards=self.spec.n_shards, bucket=self.spec.bucket,
            min_overlap=self.spec.min_overlap, mesh=self.mesh,
            quantize=self.spec.quantize,
            rerank_factor=self.spec.rerank_factor, device=self.device,
            slice_rows=(int(self.spec.opt("compact_slice_rows", 512))
                        if slice_rows is None else slice_rows),
            generation=self.generation, premapped=premapped,
            on_phase=self._on_compaction_phase)
        self.events.emit("compaction_start", frozen_items=int(ids.size),
                         target_generation=self._planner.target_generation)
        return self._planner

    def _on_compaction_phase(self, old: str, new: str, stats: dict) -> None:
        self.events.emit("compaction_phase", old=old, new=new,
                         progress=round(float(stats["progress"]), 4),
                         target_generation=stats["target_generation"])

    def compaction_step(self, max_slices: int = 1) -> bool:
        """Advance the in-flight background compaction by up to
        ``max_slices`` bounded units; returns True iff the replacement
        segment swapped in (the generation advanced)."""
        if self._planner is None:
            return False
        for _ in range(max_slices):
            self._planner.step()
            self.metrics.record_compact_slice()
            if self._planner.ready:
                self._swap_compacted()
                return True
        return False

    def abort_compaction(self) -> bool:
        """Drop the in-flight build (fault injection / superseded by a sync
        compact).  Pure shadow state: no query result ever changes."""
        if self._planner is None:
            return False
        self.events.emit("compaction_abort", phase=self._planner.phase,
                         progress=round(float(self._planner.progress), 4))
        self._planner = None
        self.metrics.record_compact_abort()
        return True

    def _swap_compacted(self) -> None:
        """The atomic flip: one reference assignment, then replay the
        journal of mutations that raced the build."""
        planner, self._planner = self._planner, None
        self._adopt_base(planner.result())
        journal = planner.journal
        if journal:
            # every journaled id supersedes (or deletes) its frozen row
            self.base.kill(np.fromiter(journal.keys(), np.int64,
                                       len(journal)))
        ups = [(i, f) for i, f in journal.items() if f is not None]
        if ups:
            self.delta.replace(np.array([i for i, _ in ups], np.int64),
                               np.stack([f for _, f in ups]))
        else:
            self.delta.clear()
        self.generation = planner.target_generation
        self._bump_cache()
        self.metrics.record_compact(async_=True)
        self.events.emit("generation_swap", generation=self.generation,
                         replayed=len(journal))

    def repartition(self, *, async_: bool = True,
                    n_shards: int | None = None) -> Partition:
        """Plan a skew-aware partition for the current catalog and compact
        into it (background by default).

        Per-item weights = pattern size (the posting load an item
        contributes), blended with the per-block candidate traffic
        ``ServiceMetrics`` accumulated — hot regions weigh more, so the
        balanced cut gives them shorter shards with narrower kernel blocks
        (better skip granularity).  Returns the plan.
        """
        self.abort_compaction()       # a new plan supersedes an in-flight build
        skew = self.metrics.shard_skew()
        if skew is None:
            skew = Repartitioner.skew(self.base.posting_load())
        ids, factors = self._catalog_arrays()
        weights, tau, mask = self._item_weights(ids, factors)
        part = self.repartitioner.plan(
            weights, self.spec.n_shards if n_shards is None else n_shards)
        self.metrics.record_repartition(skew_before=skew)
        self.events.emit("repartition", skew_before=skew, async_=async_,
                         lengths=list(part.lengths))
        self._rebalanced = True       # sticky: later plain compactions re-plan
        # the weights already paid the phi-mapping of this exact frozen
        # catalog — hand it down so it is never derived twice
        if async_:
            self.start_compaction(partition=part, premapped=(tau, mask))
        else:
            self.base = self._build_base(factors, ids, partition=part,
                                         premapped=(tau, mask))
            self.delta.clear()
            self.generation += 1
            self._bump_cache()
            self.metrics.record_compact()
            self.events.emit("generation_swap", generation=self.generation,
                             sync=True)
        return part

    def maybe_rebalance(self, threshold: float = 1.5, *,
                        async_: bool = True) -> bool:
        """Repartition iff the metrics' per-shard candidate skew (max/mean)
        exceeds ``threshold`` and no build is already in flight — the
        auto-rebalance trigger ``launch/serve.py --rebalance`` polls."""
        if self._planner is not None:
            return False
        skew = self.metrics.shard_skew()
        if skew is None or skew <= threshold:
            return False
        self.repartition(async_=async_)
        return True

    def _item_weights(self, ids: np.ndarray, factors: np.ndarray):
        """Per-item load estimate in id-sorted order: 1 + pattern nnz,
        times the observed per-block candidate traffic of the item's
        current block (when the metrics have seen any).  Returns
        ``(weights, tau, mask)`` so the caller can reuse the mapping.

        The phi-mapping comes from the incremental :class:`MapCache`: only
        rows whose factors changed since the last plan are re-mapped
        (bit-identical to mapping the whole catalog — ``sparse_map`` is
        row-wise), so repeated ``repartition()``/``maybe_rebalance()``
        cycles on a large mostly-static catalog stop paying O(N) maps."""
        k = self.spec.cfg.k
        if ids.size == 0:
            return (np.zeros(0, np.float64), np.zeros((0, k), np.int32),
                    np.zeros((0, k), bool))
        tau, mask = self._map_cache.lookup(ids, factors)
        w = mask.sum(axis=1).astype(np.float64) + 1.0
        bc = self.metrics.block_candidates
        if bc is not None and bc.sum() > 0 and \
                bc.size == self.base.total_blocks():
            rows = self.base.rows_of(ids)
            m = rows >= 0
            if m.any():
                blocks = self.base.block_index(rows[m])
                w[m] *= 1.0 + bc[blocks] / max(float(bc.mean()), 1e-9)
        return w, tau, mask

    def maintenance_stats(self) -> dict:
        part = self.base.partition
        comp: dict = {"active": self._planner is not None}
        if self._planner is not None:
            comp.update(self._planner.stats())
        return {
            "backend": self.spec.backend,
            "generation": self.generation,
            "compaction": comp,
            "repartition": {
                "rebalanced": self._rebalanced,
                "map_cache": self._map_cache.stats(),
                "n_repartitions": self.metrics.n_repartitions,
                "shard_skew": self.metrics.shard_skew(),
                "block_skew": self.metrics.block_skew(),
                "last_repartition_skew": self.metrics.last_repartition_skew,
                "partition": {"lengths": list(part.lengths),
                              "bns": list(part.bns),
                              "caps": list(part.caps)},
            },
        }

    # ------------------------------------------------------------ queries

    def query(self, users, kappa=None, *, exact=False, explain=False,
              deadline_s=None, stats_rows=None) -> RetrievalResult:
        """``exact=True`` scores every live item through the same kernel —
        the brute-force reference the benchmark compares against.
        ``explain=True`` attaches shard/delta provenance without changing
        any answer (the kernel already computes everything explain reports).

        ``stats_rows``: the leading rows whose per-block candidate loads
        :meth:`record_last_query_stats` will fold (the microbatcher's real
        rows); the loads are summed over them on the card.  ``None``: every
        row.

        ``deadline_s`` is the remaining budget for this call: when it is
        short relative to the EWMA cost estimate of a full query, the
        deterministic degrade ladder steps down (skip the exact re-rank ->
        raise the prune threshold one notch -> answer from the base segment
        only) and the result is stamped ``degraded=True`` with the rung
        that fired — a reduced-work answer is never silently mistaken for
        the full one.  With no deadline (the default) nothing changes.

        While a background compaction is in flight, each query first
        advances it by one bounded slice (the "interleaved with queries"
        schedule); the answer itself always comes from the stable
        (base ∪ delta) view, so results are unaffected at every step."""
        if self._planner is not None:
            self.compaction_step()
        kappa = self.spec.kappa if kappa is None else int(kappa)
        users = np.asarray(users, np.float32)
        q = users.shape[0]
        t_start = self.clock()
        # hot-query result cache: looked up BEFORE the degrade ladder — a
        # hit is the zero-cost rung, returning the FULL exact-generation
        # answer no matter how tight deadline_s is.  Stale entries cannot
        # hit (every mutation bumped the cache version), so this is
        # bit-identical to computing below.
        cache_keys = None
        if self.cache is not None and q > 0:
            cache_keys = [ResultCache.key(users[i], kappa, exact)
                          for i in range(q)]
            rows = self.cache.get_batch(cache_keys)
            if rows is not None:
                return self._answer_from_cache(rows, q, kappa, explain)
        # degrade-ladder selection: pure function of budget / cost estimate
        rung = (self.qos.choose_rung(deadline_s, self._cost_est)
                if deadline_s is not None else 0)
        applied: list[str] = []
        eff_exact = exact
        if rung >= 1 and exact:
            eff_exact = False
            applied.append("skip_exact")
        eff_overlap = None
        if rung >= 2:
            eff_overlap = self.spec.min_overlap + 1
            applied.append("raise_overlap")
        skip_delta = rung >= 3
        if skip_delta:
            applied.append("base_only")
        degraded = bool(applied)
        span_kw = ({"degraded": True, "degrade_rung": applied[-1]}
                   if degraded else {})
        # root trace when called directly; child span when the microbatcher
        # already opened the request_batch root around us
        with self.tracer.trace_or_span("query", q=q, kappa=kappa, **span_kw):
            with self.tracer.span("map"):
                users_j = torch.as_tensor(users, device=self.device)
                tau, vals = sparse_map(users_j, self.spec.cfg)
                q_mask = vals != 0.0

            b_scores, b_ids, base_stats = self._base_topk(
                users_j, tau, q_mask, kappa, eff_exact, explain=explain,
                min_overlap=eff_overlap, stats_rows=stats_rows)
            if skip_delta:
                d_scores = np.zeros((q, 0), np.float32)
                d_ids = np.zeros((q, 0), np.int64)
                d_cand = np.zeros(q, np.int64)
            else:
                with self.tracer.span("delta", n_delta=len(self.delta)):
                    d_scores, d_ids, d_cand = self.delta.query(
                        users_j, tau, q_mask, kappa, exact=eff_exact,
                        min_overlap=eff_overlap, tracer=self.tracer)

            with self.tracer.span("merge", kappa=kappa):
                cat_scores = np.concatenate([b_scores, d_scores], axis=1)
                cat_ids = np.concatenate([b_ids, d_ids], axis=1)
                cat_ids = np.where(cat_scores <= NEG / 2, _PAD_ID, cat_ids)
                # total order: score desc, catalog id asc — rebuild-equivalent
                order = np.lexsort((cat_ids, -cat_scores), axis=-1)[:, :kappa]
                top_ids = np.take_along_axis(cat_ids, order, axis=-1)
                top_scores = np.take_along_axis(cat_scores, order, axis=-1)

            with self.tracer.span("assemble"):
                ids_out = np.full((q, kappa), -1, np.int64)
                sc_out = np.full((q, kappa), -np.inf, np.float32)
                kk = top_ids.shape[1]
                real = top_scores > NEG / 2
                ids_out[:, :kk] = np.where(real, top_ids, -1)
                sc_out[:, :kk] = np.where(real, top_scores, -np.inf)

                n_live = self.base.n_live + len(self.delta)
                n_cand = (base_stats["shard_candidates"].sum(axis=-1)
                          + d_cand)
                discard = 1.0 - n_cand / max(n_live, 1)
                self._last_query_stats = {
                    k: v for k, v in base_stats.items() if k != "tile_skips"}
                self._last_query_stats["discard"] = discard
                exp = None
                if explain:
                    # provenance of each winning slot: merge column < base
                    # width means the hit came from the compacted base tier
                    src = np.full((q, kappa), "", object)
                    src[:, :kk] = np.where(
                        real, np.where(order < b_ids.shape[1], "base",
                                       "delta"), "")
                    exp = {
                        "backend": self.spec.backend,
                        "n_candidates": np.asarray(n_cand,
                                                   np.int64).tolist(),
                        "shard_candidates": np.asarray(
                            base_stats["shard_candidates"], np.int64).tolist(),
                        "delta_candidates": np.asarray(d_cand,
                                                       np.int64).tolist(),
                        "source": src.tolist(),
                        "degraded": degraded,
                        "degrade_rung": applied[-1] if degraded else None,
                    }
                    exp.update(self._explain_base(ids_out, src == "base",
                                                  base_stats))
        if degraded:
            self.metrics.record_degraded(applied[-1])
            # decay the estimate while degrading, so one cost spike (e.g. a
            # delta-capacity recompile) cannot lock the ladder down forever:
            # the estimate drifts back under the threshold and the next
            # query re-probes full service, refreshing the EWMA honestly
            if self._cost_est is not None:
                self._cost_est *= 0.9
        elif rung == 0:
            # EWMA full-path cost: what choose_rung compares budgets against
            el = self.clock() - t_start
            self._cost_est = (el if self._cost_est is None
                              else 0.7 * self._cost_est + 0.3 * el)
        if cache_keys is not None and not degraded:
            # memoize the full-service answer per row, tagged with the
            # current cache version (degraded answers are never cached —
            # they are not what the uncached full path would return)
            for i, key in enumerate(cache_keys):
                self.cache.put(key, ids_out[i], sc_out[i],
                               int(n_cand[i]), float(discard[i]))
        return RetrievalResult(
            ids=ids_out, scores=sc_out,
            n_scored=np.asarray(n_cand, np.int64),
            discarded_frac=discard,
            explain=exp,
            degraded=degraded,
            degrade_rung=applied[-1] if degraded else None,
        )

    def _answer_from_cache(self, rows, q: int, kappa: int,
                           explain: bool) -> RetrievalResult:
        """Assemble a :class:`RetrievalResult` from cached per-row memos —
        bit-identical to the compute path because each memo stores exactly
        what that path returned, under the current cache version.  Runs
        under a ``cache`` trace span; with ``explain=True`` the provenance
        of every winning slot is ``"cache"``."""
        with self.tracer.trace_or_span("query", q=q, kappa=kappa):
            with self.tracer.span("cache", hits=q,
                                  version=self.cache.version):
                ids_out = np.stack([r.ids for r in rows])
                sc_out = np.stack([r.scores for r in rows])
                n_cand = np.array([r.n_scored for r in rows], np.int64)
                discard = np.array([r.discarded_frac for r in rows],
                                   np.float64)
        # no kernel ran: only the per-request discard stat is meaningful
        self._last_query_stats = {"discard": discard}
        exp = None
        if explain:
            src = np.where(ids_out >= 0, "cache", "").astype(object)
            exp = {"backend": self.spec.backend,
                   "n_candidates": n_cand.tolist(),
                   "source": src.tolist(),
                   "cached": True,
                   "cache_version": self.cache.version,
                   "degraded": False, "degrade_rung": None}
        return RetrievalResult(
            ids=ids_out, scores=sc_out, n_scored=n_cand,
            discarded_frac=discard, explain=exp)

    def cache_probe(self, user):
        """Pre-queue probe for the microbatcher's zero-cost admission rung:
        a live cached answer for this single row (default kappa, inexact
        path — the microbatcher's only shape) or None.  A miss is NOT
        counted (the row will be counted when its batch reaches
        :meth:`query`); returns copies so callers cannot corrupt the
        memo."""
        if self.cache is None:
            return None
        key = ResultCache.key(np.asarray(user, np.float32),
                              self.spec.kappa, False)
        row = self.cache.get(key, count_miss=False)
        if row is None:
            return None
        return row.ids.copy(), row.scores.copy()

    def _base_topk(self, users_j, q_tau, q_mask, kappa: int, exact: bool,
                   explain: bool = False, min_overlap: int | None = None,
                   stats_rows: int | None = None
                   ) -> tuple[np.ndarray, np.ndarray, dict]:
        """Top-kappa of the compacted base tier, in catalog-id space.

        Returns ``(scores, ids, stats)`` with stats carrying the (Q, S)
        per-shard candidate counts, the (n_blocks,) per-block totals over
        the first ``stats_rows`` queries and how many those were (plus the
        per-query prepass tile skips when ``explain`` asks for them).  The
        ``sharded-multihost`` backend overrides this with the routed
        per-host computation + collective merge; everything around it (phi-mapping, delta merge, padding,
        metrics) is shared.  The answer's copies to the host run under a
        ``fetch`` span inside ``base``, the row-to-id lookup under
        ``assemble``."""
        with self.tracer.span("base", exact=exact):
            res = self.base.query(users_j, q_tau, q_mask, kappa, exact=exact,
                                  tracer=self.tracer,
                                  collect_tile_skips=explain,
                                  min_overlap=min_overlap,
                                  stats_rows=stats_rows)
        with self.tracer.span("assemble"):
            scores = np.asarray(res.scores, np.float32)
            ids = self.base.rows_to_ids(np.asarray(res.rows), scores)
        stats = {"shard_candidates": np.asarray(res.shard_candidates),
                 "block_totals": res.block_totals,
                 "block_rows": (scores.shape[0] if stats_rows is None
                                else min(int(stats_rows), scores.shape[0])),
                 "tiles_skipped_frac": res.tiles_skipped_frac}
        if explain:
            stats["tile_skips"] = res.tile_skips
        return scores, ids, stats

    def _explain_base(self, ids_out: np.ndarray, from_base: np.ndarray,
                      base_stats: dict) -> dict:
        """Base-tier columns of the explain dict: the winning shard per
        result slot (-1 for delta hits and pads) and the block-union
        prepass skip counts.  ``sharded-multihost`` overrides this to add
        the serving placement slice and replica per slot."""
        part = self.base.partition
        offs = np.cumsum(part.lengths)
        shard = np.full(ids_out.shape, -1, np.int64)
        qi, ki = np.nonzero(from_base)
        rows = self.base.rows_of(ids_out[qi, ki])
        hit = rows >= 0
        shard[qi[hit], ki[hit]] = np.searchsorted(offs, rows[hit],
                                                  side="right")
        out: dict = {"shard": shard.tolist()}
        sk = base_stats.get("tile_skips")
        if sk is not None:
            out["blocks_skipped"] = sk.sum(axis=1).tolist()
            out["n_blocks"] = int(sk.shape[1])
        return out

    def record_last_query_stats(self, n_real: int | None = None) -> None:
        """Fold the most recent ``query()``'s discard / per-shard /
        per-block candidate stats into the metrics — the skew signal
        :meth:`maybe_rebalance` reads.  The microbatcher calls this per
        batch with the count of real (non-padding) rows; direct-query
        callers (e.g. the SPMD multi-host serve loop) call it with no
        argument.  The per-block loads were summed on the card over the
        rows the query was given as ``stats_rows``, which must be these."""
        st = self._last_query_stats
        if not st:
            return
        sl = slice(None) if n_real is None else slice(n_real)
        discard = st["discard"][sl]
        sc = st.get("shard_candidates")      # absent for cache-hit answers
        bt = st.get("block_totals")
        if bt is not None and st["block_rows"] != discard.shape[0]:
            raise ValueError(
                f"the last query summed its block loads over "
                f"{st['block_rows']} rows, not {discard.shape[0]}: pass "
                f"stats_rows={discard.shape[0]} to query()")
        self.metrics.record_query_stats(
            discard, sc[sl] if sc is not None else None, bt)

    def _batch_query_fn(self, users: np.ndarray, n_real: int,
                        deadline_s: float | None = None):
        """Fixed-shape step for the microbatcher; folds per-query discard,
        shard-balance and block-load stats into the metrics — real rows
        only, never the zero-vector padding.  ``deadline_s`` (the batch's
        tightest remaining budget) drives the degrade ladder; the info
        element carries the degraded flag back onto every QueryResult."""
        res = self.query(users, deadline_s=deadline_s, stats_rows=n_real)
        self.record_last_query_stats(n_real)
        return res.ids, res.scores, {"degraded": res.degraded,
                                     "degrade_rung": res.degrade_rung}

    def candidate_masks(self, users):
        raise UnsupportedOp(self.spec.backend, "candidate_masks",
                            "the sharded tier never materialises (Q, N) "
                            "masks — that is the point of the fused kernel")

    # ------------------------------------------------------------ state

    @property
    def n_items(self) -> int:
        return len(self.catalog)

    def stats(self) -> dict:
        out = super().stats()
        out.update(
            n_shards=self.base.n_shards,
            n_live_base=self.base.n_live,
            delta_len=len(self.delta),
            generation=self.generation,
            posting_load=self.base.posting_load().tolist(),
            metrics=self.metrics.snapshot(),
        )
        if "tiles_skipped_frac" in self._last_query_stats:
            out["tiles_skipped_frac"] = (
                self._last_query_stats["tiles_skipped_frac"])
        if self.cache is not None:
            out["result_cache"] = self.cache.stats()
        return out

    def snapshot(self, path: str) -> None:
        """Persist the deployment to ``path``.  On a mesh every rank calls
        it: the ranks' blocks are gathered, the mesh's first rank writes
        the file and the others wait for it."""
        arrays, extra = self._snapshot_payload()
        if self.mesh is None:
            write_snapshot(path, self.spec, arrays, extra)
            return
        import torch.distributed as dist
        group = self.mesh.get_group("items")
        if group.rank() == 0:
            write_snapshot(path, self.spec, arrays, extra)
        dist.barrier(group=group)

    def _snapshot_payload(self) -> tuple[dict, dict]:
        """The (arrays, extra) pair ``snapshot`` persists — split out so the
        multi-host backend can append its placement before writing."""
        cat_ids, cat_fac = self._catalog_arrays()
        base, part = self.base, self.base.partition
        whole = base.whole_arrays()
        arrays = {
            "catalog_ids": cat_ids, "catalog_factors": cat_fac,
            "base_item_ids": base.item_ids,
            "base_counts": whole["counts"],
            "base_spills": whole["spills"],
            "base_factors": base.flat_factors(),
            "base_alive": base._alive_host,
            "delta_ids": self.delta.ids, "delta_factors": self.delta.factors,
        }
        extra_base: dict = {"bucket": base.bucket,
                            "partition": {"lengths": list(part.lengths),
                                          "bns": list(part.bns),
                                          "caps": list(part.caps)}}
        if self.spec.compress_postings:
            # the (S, p, bucket) dense-bucket tables flattened to one CSR
            # stream (the per-slot counts are already persisted as
            # base_counts); restore re-densifies shard by shard against
            # each shard's own pad sentinel, bit-identically
            tables = whole["tables"]
            counts = whole["counts"].astype(np.int64)
            post, off = table_to_csr(
                tables.reshape(-1, tables.shape[-1]), counts.ravel())
            cp = encode_postings(post, off)
            arrays["base_tables_data"] = cp.data
            extra_base["codec"] = {"n_values": int(cp.n_values),
                                   "bucket": int(tables.shape[-1])}
        else:
            arrays["base_tables"] = whole["tables"]
        per_group = []
        for g, meta in enumerate(base.metas):
            arrays[f"meta{g}_item_bits_t"] = whole[
                f"meta{g}_item_bits_t"].view(np.uint32)
            arrays[f"meta{g}_block_union"] = whole[
                f"meta{g}_block_union"].view(np.uint32)
            arrays[f"meta{g}_block_spill"] = whole[f"meta{g}_block_spill"]
            arrays[f"meta{g}_spill8"] = whole[f"meta{g}_spill8"]
            if meta.quantize == "int8":
                arrays[f"meta{g}_factors_q"] = whole[f"meta{g}_factors_q"]
                arrays[f"meta{g}_scales"] = whole[f"meta{g}_scales"]
            n = base.whole_meta_rows(g)
            per_group.append({"bn": meta.bn, "words": meta.words,
                              "n_rows": n, "n_pad": n,
                              "quantize": meta.quantize})
        extra = {"base": extra_base,
                 "meta": {"n_groups": len(base.metas),
                          "per_group": per_group},
                 "generation": self.generation}
        return arrays, extra

    def restore(self, path: str) -> "ShardedRetriever":
        """Reconstruct the exact serving state — including tombstones, the
        kill-refreshed block metadata, a non-empty delta, a skew-aware
        partition and the serving generation — without re-deriving
        anything; queries are bit-identical to pre-snapshot.  Restores onto
        the retriever's device (whole: a mesh placement is not persisted)
        with no compaction in flight (the planner is shadow state a snapshot
        never contains)."""
        arrays, state = read_snapshot(path, self.spec)
        b = state["base"]
        part = Partition(tuple(b["partition"]["lengths"]),
                         tuple(b["partition"]["bns"]),
                         tuple(b["partition"]["caps"]))
        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   device=self.device)

        metas = []
        for g, m in enumerate(state["meta"]["per_group"]):
            meta = RetrievalMeta(
                item_bits_t=dev(_bits(arrays[f"meta{g}_item_bits_t"])),
                block_union=dev(_bits(arrays[f"meta{g}_block_union"])),
                block_spill=dev(np.asarray(arrays[f"meta{g}_block_spill"],
                                           bool)),
                spill8=dev(np.asarray(arrays[f"meta{g}_spill8"], np.int8)),
                p=self.spec.cfg.p, words=int(m["words"]), bn=int(m["bn"]),
                n_rows=int(m["n_rows"]), n_pad=int(m["n_pad"]))
            if (m.get("quantize", "none") == "int8"
                    and f"meta{g}_factors_q" in arrays):
                meta = dataclasses.replace(
                    meta, quantize="int8",
                    factors_q=dev(np.asarray(arrays[f"meta{g}_factors_q"],
                                             np.int8)),
                    scales=dev(np.asarray(arrays[f"meta{g}_scales"],
                                          np.float32)))
            metas.append(meta)
        counts = np.asarray(arrays["base_counts"])
        if "base_tables_data" in arrays:
            codec = b["codec"]
            cp = CompressedPostings(
                np.asarray(arrays["base_tables_data"], np.uint8),
                counts.ravel().astype(np.int32), int(codec["n_values"]))
            post, off = decode_postings(cp)
            bucket = int(codec["bucket"])
            p = self.spec.cfg.p
            shard_tables = []
            for s in range(part.n_shards):
                lo, hi = off[s * p], off[(s + 1) * p]
                soff = off[s * p:(s + 1) * p + 1] - lo
                tab, _ = csr_to_table(post[lo:hi], soff, bucket,
                                      sentinel=part.caps[s])
                shard_tables.append(tab)
            tables = np.stack(shard_tables)
        else:
            tables = np.asarray(arrays["base_tables"])
        self._adopt_base(ShardedGamIndex(
            self.spec.cfg, np.asarray(arrays["base_item_ids"], np.int64),
            np.asarray(tables, np.int32),
            np.asarray(counts, np.int32),
            np.asarray(arrays["base_spills"], np.int32),
            np.asarray(arrays["base_factors"], np.float32),
            np.asarray(arrays["base_alive"], bool),
            part, self.spec.min_overlap, int(b["bucket"]), None, metas,
            quantize=self.spec.quantize,
            rerank_factor=self.spec.rerank_factor, device=self.device))
        self.catalog = {int(i): f for i, f in zip(
            np.asarray(arrays["catalog_ids"], np.int64),
            np.asarray(arrays["catalog_factors"], np.float32))}
        self._map_cache.clear()
        # DeltaSegment state is a deterministic function of its sorted
        # (ids, factors) — re-deriving it reproduces the packed patterns
        # and posting table bit-for-bit
        self.delta.replace(np.asarray(arrays["delta_ids"], np.int64),
                           np.asarray(arrays["delta_factors"], np.float32))
        self.generation = int(state.get("generation", 0))
        self._bump_cache()
        self._planner = None
        # a restored skew-aware layout keeps re-planning on later compactions
        self._rebalanced = part != Partition.uniform(part.n, part.n_shards)
        return self
