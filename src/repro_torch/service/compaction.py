"""Incremental background compaction for the sharded service tier.

Counterpart of ``repro.service.compaction``: the map phase runs
``sparse_map`` (the ``tess_project`` kernel on the card) on the planner's
device, the metadata phase builds each group's block metadata there, and
finalize assembles the index on that device.

``compact()`` used to be the service's only remaining stop-the-world
operation: a synchronous rebuild of the whole main segment, during which no
query could run — a p99 cliff that grows with the catalog.
:class:`CompactionPlanner` converts it into a resumable state machine whose
work is done in bounded slices interleaved with queries, with one atomic
swap at the end.

State machine
=============

::

    start(frozen catalog, target partition)          generation g
        │
        ▼
    MAP ──────── slice_rows rows per step: sparse_map the frozen factors
        │        (row-independent, so chunked == full-batch bit-for-bit)
        ▼
    SEGMENTS ─── one shard posting segment per step (build_shard_segment)
        │
        ▼
    META ─────── one bn-group's kernel block metadata per step
        │        (build_group_meta)
        ▼
    FINALIZE ─── assemble + device upload (ShardedGamIndex.assemble)
        │
        ▼
    READY ────── the owner swaps base segments and replays the journal;
                 the swapped-in index serves generation g+1

Consistency contract (pinned by the lifecycle stress suite):

* The planner only ever touches SHADOW state — the frozen catalog copy and
  the replacement segment under construction.  The serving path keeps
  answering every query exactly from ``(old segment ∪ delta)`` at every
  intermediate step, so interrupting a compaction mid-slice (``abort``, or
  simply dropping the planner) loses no data and changes no answer.
* Mutations that arrive while the build is in flight go to the live delta
  as usual AND into the planner's *journal* (last-write-wins per id).  At
  swap time the owner replays the journal against the fresh segment —
  tombstoning superseded rows and re-seeding the delta — which lands the
  service in exactly the state a fresh build over the current catalog would
  produce.
* The swap is atomic from the query path's perspective: one reference
  assignment between two queries.  A snapshot taken mid-compaction persists
  only the stable serving state (old segment + delta + generation g);
  restore therefore never observes a half-built segment.

Generations count successful swaps (sync or async).  They exist for
observability and snapshot consistency checks — ``maintenance_stats()``
reports the serving generation and the in-flight target generation.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.mapping import GamConfig, sparse_map
from repro_torch.device import resolve_device
from repro_torch.service.repartition import Partition
from repro_torch.service.sharded_index import (ShardedGamIndex,
                                               build_group_meta,
                                               build_shard_segment,
                                               index_mesh)

__all__ = ["CompactionPlanner"]

# phase order of the state machine; "ready" is terminal
PHASES = ("map", "segments", "meta", "finalize", "ready")


class CompactionPlanner:
    """Builds a replacement main segment in bounded slices.

    ``ids``/``factors`` are the FROZEN catalog (the merged base ∪ delta view
    at start time); ``partition`` the target layout (defaults to the uniform
    cut over ``n_shards``).  Call :meth:`step` repeatedly — each call does
    one bounded unit of work — until :attr:`ready`, then take
    :meth:`result` and replay :attr:`journal`.
    """

    def __init__(self, cfg: GamConfig, ids: np.ndarray, factors: np.ndarray,
                 *, partition: Partition | None = None, n_shards: int = 1,
                 bucket: int = 256, min_overlap: int = 1, mesh=None,
                 slice_rows: int = 512, generation: int = 0,
                 premapped: tuple[np.ndarray, np.ndarray] | None = None,
                 on_phase=None, quantize: str = "none",
                 rerank_factor: int = 4,
                 device: str | torch.device | None = None):
        self.mesh = index_mesh(mesh)
        if slice_rows < 1:
            raise ValueError("slice_rows must be >= 1")
        # lifecycle hook: called as on_phase(old, new, stats) on every phase
        # transition — the owner routes it into its event journal
        self.on_phase = on_phase
        ids = np.asarray(ids, np.int64).ravel()
        factors = np.asarray(factors, np.float32).reshape(ids.size, cfg.k)
        order = np.argsort(ids)
        self.cfg = cfg
        self.ids = ids[order]
        self.factors = factors[order]
        self.n = int(ids.size)
        self.partition = (Partition.uniform(self.n, n_shards)
                          if partition is None else partition)
        if self.partition.n != self.n:
            raise ValueError(f"partition covers {self.partition.n} rows, "
                             f"frozen catalog has {self.n}")
        self.bucket = bucket
        self.min_overlap = min_overlap
        self.quantize = quantize
        self.rerank_factor = int(rerank_factor)
        self.device = resolve_device(device)
        self.slice_rows = int(slice_rows)
        self.target_generation = int(generation) + 1

        self.phase = "map"
        self.slices_done = 0
        self.journal: dict[int, np.ndarray | None] = {}
        self._tau = np.zeros((self.n, cfg.k), np.int32)
        self._mask = np.zeros((self.n, cfg.k), bool)
        self._mapped = 0
        if premapped is not None:
            # caller already mapped the (id-sorted) frozen catalog — e.g. the
            # repartitioner, whose weights needed the patterns anyway; skip
            # straight past the map phase instead of re-deriving it
            tau, mask = premapped
            self._tau[:] = np.asarray(tau)[order]
            self._mask[:] = np.asarray(mask, bool)[order]
            self._mapped = self.n
        self._n_map_slices = (-(-self.n // self.slice_rows)
                              if self._mapped < self.n else 0)
        self._segs: list = []          # (table, counts, spill) per shard
        self._metas: list = []         # RetrievalMeta per bn-group
        self._result: ShardedGamIndex | None = None

    # ------------------------------------------------------------- journal

    def record_upsert(self, ids, factors) -> None:
        """Note ids written while the build is in flight (last write wins);
        replayed by the owner after the swap."""
        ids = np.asarray(ids, np.int64).ravel()
        factors = np.asarray(factors, np.float32).reshape(
            ids.size, self.cfg.k)
        for i, f in zip(ids, factors):
            self.journal[int(i)] = np.array(f, np.float32)

    def record_delete(self, ids) -> None:
        for i in np.asarray(ids, np.int64).ravel():
            self.journal[int(i)] = None

    # ------------------------------------------------------------- driving

    @property
    def ready(self) -> bool:
        return self.phase == "ready"

    @property
    def total_slices(self) -> int:
        """Total step() calls this build needs (a progress denominator)."""
        return (self._n_map_slices + self.partition.n_shards
                + len(self.partition.groups) + 1)

    @property
    def progress(self) -> float:
        return min(1.0, self.slices_done / max(self.total_slices, 1))

    def step(self) -> str:
        """One bounded unit of work; returns the phase AFTER the step.

        map: ``slice_rows`` catalog rows through ``sparse_map`` — chunking
        is parity-safe because the map is row-independent.  segments: one
        shard's posting segment.  meta: one bn-group's block metadata.
        finalize: device upload + assembly.  Calling ``step`` when ready is
        a no-op.  Phase transitions fire the ``on_phase`` hook.
        """
        before = self.phase
        phase = self._step()
        if phase != before and self.on_phase is not None:
            self.on_phase(before, phase, self.stats())
        return phase

    def _step(self) -> str:
        if self.phase == "ready":
            return self.phase
        self.slices_done += 1
        if self.phase == "map":
            did_map = False
            if self._mapped < self.n:
                lo = self._mapped
                hi = min(lo + self.slice_rows, self.n)
                # the map is row-independent, so chunked == full-batch bit
                # for bit
                chunk = torch.as_tensor(self.factors[lo:hi],
                                        device=self.device)
                tau, vals = sparse_map(chunk, self.cfg)
                self._tau[lo:hi] = tau.cpu().numpy()
                self._mask[lo:hi] = (vals != 0.0).cpu().numpy()
                self._mapped = hi
                did_map = True
            if self._mapped >= self.n:
                self.phase = "segments"
                if did_map:           # empty/premapped builds fall through
                    return self.phase
            else:
                return self.phase
        if self.phase == "segments":
            if len(self._segs) < self.partition.n_shards:
                s = len(self._segs)
                self._segs.append(build_shard_segment(
                    self._tau, self._mask, self.partition, s, self.cfg.p,
                    self.bucket))
                if len(self._segs) < self.partition.n_shards:
                    return self.phase
            self.phase = "meta"
            return self.phase
        if self.phase == "meta":
            if len(self._metas) < len(self.partition.groups):
                g = len(self._metas)
                self._metas.append(build_group_meta(
                    self._tau, self._mask, self.cfg.p, self.partition, g,
                    [sp for _, _, sp in self._segs], device=self.device))
                if len(self._metas) < len(self.partition.groups):
                    return self.phase
            self.phase = "finalize"
            return self.phase
        # finalize
        self._result = ShardedGamIndex.assemble(
            self.cfg, self.ids, self.factors, self.partition,
            [t for t, _, _ in self._segs], [c for _, c, _ in self._segs],
            [sp for _, _, sp in self._segs], self._metas,
            min_overlap=self.min_overlap, bucket=self.bucket, mesh=self.mesh,
            quantize=self.quantize, rerank_factor=self.rerank_factor,
            device=self.device)
        self.phase = "ready"
        return self.phase

    def result(self) -> ShardedGamIndex:
        if not self.ready:
            raise RuntimeError(f"compaction not finished (phase={self.phase})")
        return self._result

    def stats(self) -> dict:
        return {
            "phase": self.phase,
            "progress": self.progress,
            "slices_done": self.slices_done,
            "total_slices": self.total_slices,
            "frozen_items": self.n,
            "journal_len": len(self.journal),
            "target_generation": self.target_generation,
            "n_shards": self.partition.n_shards,
            "bns": list(self.partition.bns),
        }
