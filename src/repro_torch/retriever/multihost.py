"""``sharded-multihost`` backend: the service tier spanning host processes.

Counterpart of ``repro.retriever.multihost``.  Extends the single-process
``sharded`` backend (everything about the lifecycle — catalog, delta tier,
background compaction, repartitioner, microbatcher — is inherited
unchanged) with a *placement* layer: the partition's shards are grouped
into contiguous **placement slices**, each slice is replicated onto
``spec.replication`` hosts, and queries run the fused ``gam_retrieve``
kernel once per bn-group of each local slice, exporting the O(Q*kappa)
accumulator through ``kernels.gam_retrieve.export_topk`` and merging across
hosts with the collective in ``service.collective`` — an all-gather of the
exported accumulators followed by the kernel's own (score desc, row asc)
total order.  The result is bit-identical to the single-host ``sharded``
backend over the same catalog, for any host count and any live-replica
routing: replicas are exact copies, the router serves every slice exactly
once, the port's kernel scores every (query, item) pair with one
sequential f32 fma loop whatever slab it runs on, and the merge realises
the same total order as one in-process kernel pass.

Two deployment modes share one code path:

  * **Distributed** (a ``torch.distributed`` process group of
    ``spec.n_hosts`` processes): this process builds and holds only the
    slices it replicates, on its own device (``cuda:{rank % device_count}``
    unless it asked for the CPU); the merge all-gathers accumulators over
    gloo.  Every process must drive the SAME lifecycle calls in the same
    order (SPMD serving — the launcher ``launch/serve.py --hosts N`` and
    the multi-process runner do exactly that).
  * **Single-process placement** (no process group, and what the tier-1
    tests run): all slices live in this process; the "gather" is the
    identity.  Routing, replication and failover behave identically, which
    is what makes the failover contract testable without real processes.

A carved slice is a copy: each of its device tensors is a fresh contiguous
tensor (the kernel reads contiguous operands), byte-identical to a build of
the slice from scratch, and a host that does not hold every slice drops the
global index, so its device memory holds only its own slices.

**Failover:** ``mark_down(host)`` / ``mark_up(host)`` update the health set;
the deterministic router re-routes each affected slice to its first
surviving replica (counted in ``ServiceMetrics.n_failovers``), and answers
stay exact because replicas are byte-identical.  A slice whose every
replica is down raises the typed
:class:`~repro_torch.service.collective.NoLiveReplica` — never a silently
truncated answer.

**Snapshots** are the reference's format and carry the placement; a host
that replicates every slice (always true single-process, and with
``replication == n_hosts``) can snapshot, and a single-host ``sharded``
snapshot restores into this backend unchanged (the scale-out upgrade path).
The placement is always re-derived from the opening spec.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.gam_retrieve import export_topk
from repro_torch.kernels.gam_score import NEG
from repro_torch.obs.histogram import LogHistogram
from repro_torch.obs.tracing import NOOP_TRACER, Tracer
from repro_torch.retriever.api import RetrieverSpec
from repro_torch.retriever.sharded import ShardedRetriever
from repro_torch.retriever.types import UnsupportedOp
from repro_torch.service import collective
from repro_torch.service.collective import HostPlacement, NoLiveReplica
from repro_torch.service.qos import HealthTracker
from repro_torch.service.repartition import Partition
from repro_torch.service.sharded_index import (ShardedGamIndex, index_mesh,
                                               slice_meta)

__all__ = ["MultiHostIndex", "MultiHostShardedRetriever"]


def _global_group_of(partition: Partition, row: int) -> int:
    for g in range(len(partition.groups)):
        lo, hi = partition.group_rows(g)
        if lo <= row < hi:
            return g
    raise ValueError(f"row {row} outside partition")


def _copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy that shares no storage with ``t``."""
    return t.clone(memory_format=torch.contiguous_format)


def _slice_index(g: ShardedGamIndex, placement: HostPlacement,
                 sl: int) -> ShardedGamIndex:
    """Carve placement slice ``sl`` out of a globally built index.

    Array slicing, then a copy — slice boundaries sit on shard boundaries,
    shard caps are whole kernel blocks, and each of the slice's bn-groups
    lies inside exactly one global bn-group — so the sub-index's device
    state is byte-identical to what a from-scratch build of the slice would
    produce, every replica of a slice is an exact copy by construction, and
    no carved tensor keeps the global one alive.
    """
    part = g.partition
    s_lo, s_hi = placement.slices[sl]
    sub_part = Partition(part.lengths[s_lo:s_hi], part.bns[s_lo:s_hi],
                         part.caps[s_lo:s_hi])
    row_lo = part.offsets[s_lo]
    cat_lo = part.starts[s_lo]
    factor_parts, metas = [], []
    for gg in range(len(sub_part.groups)):
        glo, ghi = sub_part.group_rows(gg)       # slice-local flat rows
        a, b = row_lo + glo, row_lo + ghi        # global flat rows
        pg = _global_group_of(part, a)
        p_lo, _ = part.group_rows(pg)
        o, n = a - p_lo, b - a
        factor_parts.append(g.factors_g[pg][o:o + n])
        metas.append(slice_meta(g.metas[pg], o, n))
    flat = (_copy(factor_parts[0]) if len(factor_parts) == 1
            else torch.cat(factor_parts))
    return ShardedGamIndex(
        g.cfg, g.item_ids[cat_lo:cat_lo + sub_part.n],
        _copy(g.tables[s_lo:s_hi]), _copy(g.counts[s_lo:s_hi]),
        _copy(g.spills[s_lo:s_hi]), flat,
        g._alive_host[row_lo:row_lo + sub_part.n_rows],
        sub_part, g.min_overlap, g.bucket, None, metas,
        quantize=g.quantize, rerank_factor=g.rerank_factor, device=g.device)


class MultiHostIndex:
    """The multi-host main segment: per-slice sub-indexes + global mirrors.

    Holds one :class:`ShardedGamIndex` per placement slice this host
    replicates — carved lazily from the retained global index when every
    slice is held (single-process mode; also keeps snapshots supported),
    eagerly when remote slices were dropped — plus cheap host-side global
    metadata (item ids, alive mask, row maps, per-shard posting loads) so
    the maintenance subsystem keeps working against the full catalog
    either way.
    """

    def __init__(self, global_index: ShardedGamIndex | None,
                 slices: dict[int, ShardedGamIndex],
                 placement: HostPlacement, partition: Partition,
                 item_ids: np.ndarray, alive: np.ndarray,
                 padded_ids: np.ndarray, posting: np.ndarray, bucket: int,
                 min_overlap: int, cfg):
        self.global_index = global_index
        self.slices = slices
        self.placement = placement
        self.partition = partition
        self.item_ids = item_ids
        self._alive_global = alive
        self._padded_ids = padded_ids
        self._rank_ends = np.cumsum(partition.lengths)
        self._posting = posting
        self.bucket = bucket
        self.min_overlap = min_overlap
        self.cfg = cfg

    @staticmethod
    def from_global(g: ShardedGamIndex, placement: HostPlacement,
                    local_host: int | None = None) -> "MultiHostIndex":
        """Place a globally built index: hold the slices ``local_host``
        replicates (all of them when ``local_host`` is None), plus global
        host-side mirrors either way.

        When every slice is held the global device index is retained (that
        is what makes snapshots possible) and sub-indexes carve LAZILY on
        first use — carving is a pure function of the (kill-maintained)
        global state, so a late carve is bit-identical to an eager one and
        routed-away or single-slice deployments never pay a second copy of
        the device arrays.  When slices are missing the global index is
        dropped and the held slices are carved now — they become the only
        copy."""
        held = [sl for sl in range(placement.n_slices)
                if local_host is None
                or local_host in placement.replicas[sl]]
        keep_global = len(held) == placement.n_slices
        slices = ({} if keep_global
                  else {sl: _slice_index(g, placement, sl) for sl in held})
        return MultiHostIndex(
            g if keep_global else None, slices, placement, g.partition,
            g.item_ids, np.array(g._alive_host, bool),
            np.array(g._padded_ids), np.asarray(g.posting_load()), g.bucket,
            g.min_overlap, g.cfg)

    def get_slice(self, sl: int) -> ShardedGamIndex:
        """The sub-index serving placement slice ``sl`` (carved on demand
        while the global index is retained; a slice spanning the whole
        partition aliases the global index outright)."""
        sub = self.slices.get(sl)
        if sub is None:
            if self.global_index is None:
                raise ValueError(f"slice {sl} is not local to this host "
                                 f"(held: {sorted(self.slices)})")
            s_lo, s_hi = self.placement.slices[sl]
            if (s_lo, s_hi) == (0, self.partition.n_shards):
                sub = self.global_index
            else:
                sub = _slice_index(self.global_index, self.placement, sl)
            self.slices[sl] = sub
        return sub

    # ------------------------------------------------------------- state

    @property
    def n_shards(self) -> int:
        return self.partition.n_shards

    @property
    def n_live(self) -> int:
        return int(self._alive_global.sum())

    @property
    def has_all_slices(self) -> bool:
        return self.global_index is not None

    # snapshot proxies (parent payload reads these off ``self.base``)
    def whole_arrays(self) -> dict:
        return self.global_index.whole_arrays()

    def whole_meta_rows(self, g: int) -> int:
        return self.global_index.whole_meta_rows(g)

    @property
    def metas(self):
        return self.global_index.metas if self.global_index is not None else []

    @property
    def _alive_host(self) -> np.ndarray:
        return self._alive_global

    def flat_factors(self) -> np.ndarray:
        return self.global_index.flat_factors()

    def posting_load(self) -> np.ndarray:
        return self._posting

    def device_bytes(self) -> dict:
        """Bytes this host holds on its device, by part: the retained
        global index and every carved slice that is not an alias of it."""
        held = [self.global_index] if self.global_index is not None else []
        held += [s for s in self.slices.values()
                 if s is not self.global_index]
        out: dict = {}
        for index in held:
            for part, n in index.device_bytes().items():
                out[part] = out.get(part, 0) + n
        return out

    # the catalog-id -> global flat row lookup, over the global mirrors
    # (item_ids, partition and _rank_ends), so it works on any host
    rows_of = ShardedGamIndex.rows_of

    def total_blocks(self) -> int:
        p = self.partition
        return sum(p.caps[s] // p.bns[s] for s in range(p.n_shards))

    def block_index(self, rows) -> np.ndarray:
        """Global flat rows -> global kernel block ids (partition-derived,
        so it works even without the global device index)."""
        rows = np.asarray(rows, np.int64)
        out = np.zeros(rows.shape, np.int64)
        blk_off = 0
        p = self.partition
        for g in range(len(p.groups)):
            lo, hi = p.group_rows(g)
            bn = p.bns[p.groups[g][0]]
            m = (rows >= lo) & (rows < hi)
            out[m] = blk_off + (rows[m] - lo) // bn
            blk_off += (hi - lo) // bn
        return out

    def slice_row_offset(self, sl: int) -> int:
        return self.partition.offsets[self.placement.slices[sl][0]]

    def slice_block_offset(self, sl: int) -> int:
        p = self.partition
        return sum(p.caps[s] // p.bns[s]
                   for s in range(self.placement.slices[sl][0]))

    def kill(self, ids) -> None:
        """Tombstone catalog ids on every local replica (and the retained
        global index), keeping the host-side global alive mirror in step."""
        rows = self.rows_of(ids)
        rows = rows[rows >= 0]
        if rows.size:
            self._alive_global[rows] = False
        if self.global_index is not None:
            self.global_index.kill(ids)
        for sub in self.slices.values():
            if sub is not self.global_index:    # whole-partition alias
                sub.kill(ids)

    def rows_to_ids(self, rows: np.ndarray, scores: np.ndarray) -> np.ndarray:
        """Global rows -> catalog ids; empty (NEG-scored / sentinel) slots
        -> -1.  Works on any host: the id map is a global mirror."""
        rows = np.asarray(rows, np.int64)
        safe = np.where((rows >= 0) & (rows < self._padded_ids.size), rows, 0)
        out = self._padded_ids[safe]
        out[np.asarray(scores) <= NEG / 2] = -1
        return out

    # ------------------------------------------------------------- query

    def slices_topk(self, slice_ids, users_j, q_tau, q_mask, kappa: int,
                    exact: bool, tracer=None,
                    collect_tile_skips: bool = False,
                    min_overlap: int | None = None,
                    stats_rows: int | None = None
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray, dict]:
        """One host's contribution: fused-kernel top-kappa over each listed
        local slice, exported to global rows and merged into a single
        (Q, kappa) accumulator (score desc, row asc).  Also returns the
        (Q, S) per-shard candidate counts (zeros outside the listed slices)
        and per-slice block stats for the metrics: each slice's (n_blocks,)
        candidate totals over the first ``stats_rows`` queries (plus
        per-slice prepass tile skips under ``collect_tile_skips``)."""
        tracer = NOOP_TRACER if tracer is None else tracer
        q = int(users_j.shape[0])
        cand = np.zeros((q, self.partition.n_shards), np.int64)
        stats: dict = {"blocks": {}, "tiles": [], "skips": {}}
        if not slice_ids:
            s, r = collective.empty_accumulators(q, kappa)
            return s, r, cand, stats
        parts_s, parts_r = [], []
        for sl in slice_ids:
            with tracer.span("slice_topk", slice=sl):
                res = self.get_slice(sl).query(
                    users_j, q_tau, q_mask, kappa, exact=exact,
                    tracer=tracer, collect_tile_skips=collect_tile_skips,
                    min_overlap=min_overlap, stats_rows=stats_rows)
            s, r = export_topk(res.scores, res.rows,
                               offset=self.slice_row_offset(sl))
            parts_s.append(s)
            parts_r.append(r)
            s_lo, s_hi = self.placement.slices[sl]
            cand[:, s_lo:s_hi] = res.shard_candidates
            stats["blocks"][sl] = res.block_totals
            if collect_tile_skips:
                stats["skips"][sl] = res.tile_skips
            nb = self.slice_blocks(sl)
            stats["tiles"].append((res.tiles_skipped_frac, nb))
        scores, rows = collective.merge_topk(
            np.concatenate(parts_s, axis=1), np.concatenate(parts_r, axis=1),
            kappa)
        return scores, rows, cand, stats

    def slice_blocks(self, sl: int) -> int:
        p = self.partition
        s_lo, s_hi = self.placement.slices[sl]
        return sum(p.caps[s] // p.bns[s] for s in range(s_lo, s_hi))


class MultiHostShardedRetriever(ShardedRetriever):
    """Multi-host placement over the shared ``ShardedRetriever`` machinery.

    The hot-query result cache (``spec.cache_capacity``) is inherited
    PER HOST PROCESS: each process's retriever owns its own
    :class:`~repro_torch.service.result_cache.ResultCache` in front of the
    collective, so a host-local hit skips the phi-map, the kernel launches
    AND the cross-host merge.  Under SPMD every host sees the same query
    and mutation stream, so the per-host caches make identical hit/miss
    decisions in lockstep — provided ``cache_ttl_s`` is None (the
    default): a wall-clock TTL could expire on one host and not another,
    desyncing the collective (see docs/load_testing.md).
    ``mark_down``/``mark_up`` never bump the cache — failover is exact by
    construction, so cached answers stay bit-identical across reroutes.
    """

    def __init__(self, spec: RetrieverSpec, device: torch.device, **kw):
        if spec.n_hosts < 1:
            raise ValueError(f"n_hosts must be >= 1, got {spec.n_hosts}")
        if not 1 <= spec.replication <= spec.n_hosts:
            raise ValueError(
                f"replication must be in [1, n_hosts={spec.n_hosts}], "
                f"got {spec.replication}")
        world, rank = collective.process_group()
        self._distributed = world > 1
        if self._distributed and spec.n_hosts != world:
            raise ValueError(
                f"spec.n_hosts={spec.n_hosts} but the torch.distributed "
                f"process group has {world} processes — they must match")
        self._local_host = rank if self._distributed else None
        self._down: frozenset[int] = frozenset()
        # a mesh is checked and then left out: the host placement below
        # supersedes the mesh's (the reference carves its host slices from
        # the mesh-placed arrays, which changes no answer), so the base is
        # built unplaced
        index_mesh(kw.pop("mesh", None))
        super().__init__(spec, device, **kw)
        # circuit breaker: observed per-host failure streaks (fault fates
        # feed it) auto-mark_down; exponential-backoff probes auto-mark_up.
        # Deterministic given the clock + the seeded fates, so SPMD hosts
        # open/close breakers in lockstep.
        self.health = HealthTracker(
            spec.n_hosts, failures=self.qos.breaker_failures,
            probe_s=self.qos.breaker_probe_s,
            probe_max_s=self.qos.breaker_probe_max_s, clock=self.clock,
            on_open=lambda h: self.mark_down(h),
            on_close=lambda h: self.mark_up(h),
            metrics=self.metrics, events=self.events)
        self._host_lat: dict[int, LogHistogram] = {}   # hedge-delay signal
        if self._distributed:
            # host-id-annotate this process's spans and events so the
            # per-host JSONL exports reassemble into one cross-host trace
            # (same seed + same SPMD call order -> same trace ids)
            if isinstance(self.tracer, Tracer):
                self.tracer.host = self._local_host
            self.events.host = self._local_host

    # ------------------------------------------------------------ placement

    def _wrap(self, base: ShardedGamIndex) -> MultiHostIndex:
        """Carve the host's slices out of the globally built base."""
        placement = HostPlacement.from_partition(
            base.partition, self.spec.n_hosts, self.spec.replication)
        return MultiHostIndex.from_global(base, placement,
                                          local_host=self._local_host)

    def _build_base(self, factors, ids, partition=None, premapped=None):
        return self._wrap(super()._build_base(factors, ids,
                                              partition=partition,
                                              premapped=premapped))

    def _adopt_base(self, base) -> None:
        self.base = (base if isinstance(base, MultiHostIndex)
                     else self._wrap(base))

    # ------------------------------------------------------------ health

    def mark_down(self, host: int) -> dict:
        """Health hook: mark ``host`` down and re-route its slices to their
        surviving replicas (idempotent; counted in the failover metric).
        Queries stay exact afterwards; a slice left with NO live replica
        raises :class:`NoLiveReplica` at query time."""
        placement = self.base.placement
        if not 0 <= host < placement.n_hosts:
            raise ValueError(f"host {host} out of range "
                             f"[0, {placement.n_hosts})")
        if host not in self._down:
            before = placement.route(self._down)
            self._down = frozenset(self._down | {host})
            after = placement.route(self._down)
            n_fail = sum(1 for b, a in zip(before, after)
                         if b == host and a is not None)
            if n_fail:
                self.metrics.record_failover(n_fail)
            self.events.emit("mark_down", down_host=host, n_rerouted=n_fail,
                             down=sorted(self._down))
        return self.host_status()

    def mark_up(self, host: int) -> dict:
        if host in self._down:
            self.events.emit("mark_up", up_host=host,
                             down=sorted(self._down - {host}))
        self._down = frozenset(self._down - {host})
        return self.host_status()

    def host_status(self) -> dict:
        placement = self.base.placement
        return {
            "n_hosts": placement.n_hosts,
            "replication": placement.replication,
            "n_slices": placement.n_slices,
            "local_host": self._local_host,
            "down": sorted(self._down),
            "routing": list(placement.route(self._down)),
            "n_failovers": self.metrics.n_failovers,
        }

    # ------------------------------------------------------------ queries

    def _fates_faulted(self, fates) -> frozenset[int]:
        """Hosts the fault fates made unusable this round (stall/drop)."""
        if fates is None:
            return frozenset()
        return frozenset(h for h, (kind, _) in enumerate(fates)
                         if kind in ("stall", "drop"))

    def _probe_tick(self, fates) -> None:
        """Probe breaker-opened hosts whose backoff elapsed: a probe against
        a non-faulted host succeeds and closes the breaker (auto mark_up);
        a faulted one fails and doubles the backoff."""
        faulted = self._fates_faulted(fates)
        for h in self.health.due_probes():
            self.health.probe_result(h, h not in faulted)

    def _route_around_faults(self, placement, fates) -> list[int]:
        """Fault-aware routing for one query round: each slice goes to its
        first replica that is neither marked down nor fate-faulted this
        round (reroutes counted as failovers; faulted primaries feed the
        breaker's failure streaks, served hosts reset them).  A slice whose
        every live replica is faulted raises the typed NoLiveReplica — the
        round is unservable, never silently truncated."""
        down = self._down
        live_faulted = self._fates_faulted(fates) - down
        routing: list[int] = []
        n_reroutes = 0
        attempted: set[int] = set()
        for sl, reps in enumerate(placement.replicas):
            primary = next((h for h in reps if h not in down), None)
            if primary is None:
                raise NoLiveReplica(sl, reps)
            attempted.add(primary)
            eff = next((h for h in reps
                        if h not in down and h not in live_faulted), None)
            if eff is None:
                raise NoLiveReplica(sl, reps)
            if eff != primary:
                n_reroutes += 1
            routing.append(eff)
        if n_reroutes:
            self.metrics.record_failover(n_reroutes)
        # breaker bookkeeping: only hosts we would have talked to count
        for h in sorted(attempted & live_faulted):
            self.health.record_failure(h)
        for h in set(routing):
            self.health.record_success(h)
        return routing

    def _hedge_delay(self, host: int) -> float | None:
        """p99-based hedge threshold for ``host`` (None = not enough
        samples yet, or hedging disabled)."""
        factor = self.qos.hedge_factor
        if factor is None:
            return None
        hist = self._host_lat.get(host)
        if hist is None or hist.n < self.qos.hedge_min_samples:
            return None
        p99 = hist.percentile(99)
        return None if p99 is None else p99 * factor

    def _hedge_slices(self, slice_ids, slow_host, slow_elapsed, fates,
                      users_j, q_tau, q_mask, kappa, exact,
                      min_overlap) -> None:
        """Hedged read: the primary call for ``slice_ids`` exceeded its
        hedge delay, so re-issue each slice to its next live unfaulted
        replica and keep whichever answer lands first.  Because replicas
        are exact copies, BOTH answers are the same bits — the hedge buys
        tail latency, never correctness — so the primary's (already
        computed) result is kept and only latency/win-rate is recorded."""
        base: MultiHostIndex = self.base
        down = self._down
        live_faulted = self._fates_faulted(fates) - down
        for sl in slice_ids:
            alt = next((x for x in base.placement.replicas[sl]
                        if x != slow_host and x not in down
                        and x not in live_faulted), None)
            if alt is None:
                continue
            t0 = self.clock()
            with self.tracer.span("hedge", slice=sl, primary=slow_host,
                                  hedge_host=alt):
                base.slices_topk((sl,), users_j, q_tau, q_mask, kappa,
                                 exact, min_overlap=min_overlap)
            el = self.clock() - t0
            if fates is not None and fates[alt][0] == "slow":
                el += fates[alt][1]
            self._host_lat.setdefault(
                alt, LogHistogram.latency()).record(el)
            self.metrics.record_hedge(won=el < slow_elapsed)
            self.events.emit("hedged_read", slice=sl, primary=slow_host,
                             hedge_host=alt, won=el < slow_elapsed)

    def _base_topk(self, users_j, q_tau, q_mask, kappa, exact,
                   explain=False, min_overlap=None, stats_rows=None):
        """Routed per-host kernel passes + collective accumulator merge.

        Bit-identical to the parent's single-index path: each slice is
        served by exactly one live replica, per-slice accumulators are
        exported to global rows, and the merge realises the same
        (score desc, row asc) total order the kernel itself uses.  Under
        fault injection the router serves around fate-faulted hosts (and
        the breaker turns failure streaks into automatic mark_down); with
        hedging enabled, a host call slower than its own p99-based hedge
        delay re-issues the affected slices to the next live replica —
        first response wins, and either answer is the same bits because
        replicas are exact copies."""
        base: MultiHostIndex = self.base
        placement = base.placement
        # one fate per host per round, drawn identically on every SPMD
        # process (seeded) — routing stays collective-consistent
        fates = (self.faults.host_fates(placement.n_hosts)
                 if self.faults is not None else None)
        self._probe_tick(fates)
        routing = self._route_around_faults(placement, fates)
        q = int(users_j.shape[0])
        per_host = np.zeros(placement.n_hosts, np.int64)
        for h in routing:
            per_host[h] += q
        skips = None
        if self._distributed:
            me = self._local_host
            mine = tuple(sl for sl in range(placement.n_slices)
                         if routing[sl] == me)
            with self.tracer.span("host_topk", host=me, n_slices=len(mine)):
                s, r, cand, st = base.slices_topk(
                    mine, users_j, q_tau, q_mask, kappa, exact,
                    tracer=self.tracer, min_overlap=min_overlap)
            local_tiles = np.array(
                [sum(f * nb for f, nb in st["tiles"]),
                 sum(nb for _, nb in st["tiles"])], np.float32)
            with self.tracer.span("collective_gather", host=me,
                                  n_hosts=placement.n_hosts):
                cat_s, cat_r, g_cand, g_tiles = \
                    collective.allgather_accumulators(s, r, cand, local_tiles)
            with self.tracer.span("collective_merge", host=me):
                scores, rows = collective.merge_topk(cat_s, cat_r, kappa)
            blocks = None              # remote block loads are not gathered
            tile_num, tile_den = float(g_tiles[0]), float(g_tiles[1])
            cand = g_cand.astype(np.int64)
        else:
            parts_s, parts_r, tiles = [], [], []
            cand = np.zeros((q, base.partition.n_shards), np.int64)
            blocks = np.zeros(base.total_blocks(), np.int64)
            if explain:
                skips = np.zeros((q, base.total_blocks()), bool)
            for h in sorted(set(routing)):
                mine = tuple(sl for sl in range(placement.n_slices)
                             if routing[sl] == h)
                t0 = self.clock()
                with self.tracer.span("host_topk", host=h,
                                      n_slices=len(mine)):
                    s, r, cand_h, st = base.slices_topk(
                        mine, users_j, q_tau, q_mask, kappa, exact,
                        tracer=self.tracer, collect_tile_skips=explain,
                        min_overlap=min_overlap, stats_rows=stats_rows)
                elapsed = self.clock() - t0
                if fates is not None and fates[h][0] == "slow":
                    elapsed += fates[h][1]       # simulated slow replica
                hedge_after = self._hedge_delay(h)
                self._host_lat.setdefault(
                    h, LogHistogram.latency()).record(elapsed)
                if hedge_after is not None and elapsed > hedge_after:
                    self._hedge_slices(mine, h, elapsed, fates, users_j,
                                       q_tau, q_mask, kappa, exact,
                                       min_overlap)
                parts_s.append(s)
                parts_r.append(r)
                cand += cand_h
                tiles.extend(st["tiles"])
                for sl, bc in st["blocks"].items():
                    off = base.slice_block_offset(sl)
                    blocks[off:off + bc.shape[0]] = bc
                for sl, sk in st["skips"].items():
                    if sk is not None:
                        off = base.slice_block_offset(sl)
                        skips[:, off:off + sk.shape[1]] = sk
            with self.tracer.span("collective_merge",
                                  n_hosts=len(set(routing))):
                scores, rows = collective.merge_topk(
                    np.concatenate(parts_s, axis=1),
                    np.concatenate(parts_r, axis=1), kappa)
            tile_num = sum(f * nb for f, nb in tiles)
            tile_den = sum(nb for _, nb in tiles)
        self.metrics.record_host_queries(per_host)
        with self.tracer.span("assemble"):
            ids = base.rows_to_ids(rows, scores)
        frac = tile_num / tile_den if tile_den else 0.0
        stats = {"shard_candidates": cand, "block_totals": blocks,
                 "block_rows": q if stats_rows is None else min(stats_rows, q),
                 "tiles_skipped_frac": float(frac)}
        if explain:
            # distributed mode keeps block-skip detail local (accumulators,
            # not skip matrices, cross the collective) -> None there
            stats["tile_skips"] = skips
        return scores, ids, stats

    def _explain_base(self, ids_out, from_base, base_stats) -> dict:
        """Adds the serving placement slice and the replica host that
        actually answered (under the current routing) for every base hit."""
        out = super()._explain_base(ids_out, from_base, base_stats)
        placement = self.base.placement
        routing = placement.route(self._down)
        shard = np.asarray(out["shard"], np.int64)
        slc = np.full(shard.shape, -1, np.int64)
        replica = np.full(shard.shape, -1, np.int64)
        for sl, (s_lo, s_hi) in enumerate(placement.slices):
            m = (shard >= s_lo) & (shard < s_hi)
            slc[m] = sl
            if routing[sl] is not None:
                replica[m] = routing[sl]
        out["slice"] = slc.tolist()
        out["replica"] = replica.tolist()
        return out

    # ------------------------------------------------------------ state

    def maintenance_stats(self) -> dict:
        out = super().maintenance_stats()
        out["hosts"] = self.host_status()
        out["hosts"]["host_load"] = (
            self.metrics.host_queries.tolist()
            if self.metrics.host_queries is not None else None)
        return out

    def _snapshot_payload(self):
        if not self.base.has_all_slices:
            raise UnsupportedOp(
                self.spec.backend, "snapshot",
                "this host does not replicate every placement slice "
                "(snapshot from a host with replication == n_hosts, or "
                "from a single-process deployment)")
        arrays, extra = super()._snapshot_payload()
        extra["placement"] = self.base.placement.describe()
        return arrays, extra
