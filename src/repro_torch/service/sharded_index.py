"""Item-axis sharded GAM index: the service's main (compacted) segment.

Counterpart of ``repro.service.sharded_index``.  The catalog is sorted by
item id and partitioned contiguously according to a
:class:`~repro_torch.service.repartition.Partition` — per-shard row counts,
padded caps and fused-kernel block widths ``bn``.  Each shard owns a
dense-bucket posting segment over LOCAL row ids (built with
``core.inverted_index.build_segment``) — kept for posting-load stats, the
dense oracle and as the source of the bucket-spill flags — while the query
path streams the flat factor matrix through the fused ``gam_retrieve``
kernel: per-tile candidate overlap from packed pattern bitsets,
zero-candidate blocks skipped via the block-union prepass, and a running
top-kappa, so no (Q, N) mask or score tensor is ever materialised.

Every array of the index lives on one torch device (the card unless the
caller asks for the CPU): posting tables, counts, spills, factor slabs,
alive masks and the kernel's block metadata.  Host copies are kept only
where the host needs them (the id-sorted catalog ids, the alive mirror).

Consecutive shards sharing one ``bn`` form a *group*: one contiguous slab of
the flat factor matrix with one ``RetrievalMeta`` and one kernel launch (the
uniform default is a single group).  Heterogeneous partitions launch once
per group and merge on the host under the same (score desc, global row asc)
order.  Live rows appear in the flat layout in id order (pad rows are dead
and never candidates), so global-row order among candidates is catalog-id
order; the port's kernels score every (query, item) pair with one
sequential f32 fma loop over k whatever the tiling, so any partition
answers bit-identically to the single-launch layout and to the dense oracle
:meth:`ShardedGamIndex.query_dense_reference`.

The ``mesh=`` placement of the reference (one index spread over several
devices) is not ported: one card holds the index, and a mesh raises
:class:`~repro_torch.retriever.types.UnsupportedOp` naming the multi-host
slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.inverted_index import (build_segment,
                                             candidate_mask_from_table)
from repro_torch.core.mapping import GamConfig, sparse_map
from repro_torch.device import resolve_device
from repro_torch.core.retrieval import masked_topk
from repro_torch.kernels.gam_retrieve import (RetrievalMeta, _or_blocks,
                                              expand_tile_skips, export_topk,
                                              pack_patterns, quantize_meta)
from repro_torch.kernels.gam_score import NEG
from repro_torch.kernels.ops import gam_retrieve
from repro_torch.obs.tracing import NOOP_TRACER
from repro_torch.retriever.types import UnsupportedOp
from repro_torch.service.repartition import Partition

__all__ = ["ShardTopK", "ShardedGamIndex", "build_group_meta",
           "build_shard_segment", "refuse_mesh"]

# table entries gathered per step of the dense oracle (bounds temporaries)
_MASK_CHUNK = 1 << 24


def refuse_mesh(mesh) -> None:
    """The port serves one index from one card: a mesh raises."""
    if mesh is not None:
        raise UnsupportedOp("sharded", "mesh",
                            "placing one index over a device mesh comes with "
                            "the multi-host slice (ROADMAP queue 1 item 6)")


@dataclasses.dataclass
class ShardTopK:
    """Result of a sharded query, still in global-row coordinates."""
    scores: np.ndarray      # (Q, kappa) f32, NEG in empty slots
    rows: np.ndarray        # (Q, kappa) int32 global rows, -1 in empty slots
    shard_candidates: np.ndarray  # (Q, S) per-shard candidate counts
    block_candidates: np.ndarray | None = None  # (Q, n_blocks) per-block
    tiles_skipped_frac: float = 0.0  # fraction of (Q_blk, N_blk) tiles pruned
    tile_skips: np.ndarray | None = None  # (Q, n_blocks) bool prepass skips
                                          # (explain-only; None by default)


# -------------------------------------------------------- staged build units


def build_shard_segment(tau: np.ndarray, mask: np.ndarray,
                        partition: Partition, s: int, p: int, bucket: int):
    """Posting segment of shard ``s`` over its local rows (host numpy).

    ``tau``/``mask`` are the (n, k) mapped patterns of the whole id-sorted
    catalog; the shard's slice is taken here so the compaction planner can
    call one shard per step.  Returns ``(table, counts, spill)`` with the
    shard's cap as the pad sentinel.
    """
    lo = partition.starts[s]
    hi = lo + partition.lengths[s]
    return build_segment(tau[lo:hi], p, bucket, mask[lo:hi],
                         sentinel=partition.caps[s])


def build_group_meta(tau: np.ndarray, mask: np.ndarray, p: int,
                     partition: Partition, g: int, shard_spills, *,
                     device: str | torch.device | None = None
                     ) -> RetrievalMeta:
    """Fused-kernel block metadata for group ``g``'s slab, on ``device``
    (``None``: the card).

    Each member shard's real-row patterns are placed at their PADDED flat
    positions within the slab (pad rows keep empty patterns and can never
    become candidates); ``shard_spills[s]`` are the shard-local spill rows
    from :func:`build_shard_segment`.  For the uniform single-group
    partition this equals ``kernels.gam_retrieve.build_retrieval_meta``
    over the whole flat layout bit for bit.
    """
    device = resolve_device(device)
    s_lo, s_hi = partition.groups[g]
    bn = partition.bns[s_lo]
    row_lo, row_hi = partition.group_rows(g)
    rows = row_hi - row_lo
    words = -(-p // 32)
    bits = torch.zeros((rows, words), dtype=torch.int32, device=device)
    spill = torch.zeros(rows, dtype=torch.bool, device=device)
    for s in range(s_lo, s_hi):
        off = partition.offsets[s] - row_lo
        lo, ln = partition.starts[s], partition.lengths[s]
        if ln:
            bits[off:off + ln] = pack_patterns(
                torch.as_tensor(np.ascontiguousarray(tau[lo:lo + ln]),
                                device=device),
                torch.as_tensor(np.ascontiguousarray(mask[lo:lo + ln]),
                                device=device), p)
        sp = np.asarray(shard_spills[s], np.int64)
        if sp.size:
            spill[torch.as_tensor(off + sp, device=device)] = True
    n_blocks = rows // bn
    return RetrievalMeta(
        item_bits_t=bits.T.contiguous(),
        block_union=_or_blocks(bits.view(n_blocks, bn, words)).contiguous(),
        block_spill=spill.view(n_blocks, bn).any(dim=1),
        spill8=spill.to(torch.int8)[None, :],
        p=int(p), words=words, bn=bn, n_rows=rows, n_pad=rows,
    )


class ShardedGamIndex:
    """Partitioned phi-index + factor store over the item axis."""

    def __init__(self, cfg: GamConfig, item_ids: np.ndarray,
                 tables, counts, spills, factors, alive: np.ndarray,
                 partition: Partition, min_overlap: int,
                 bucket: int, mesh=None, metas=None, *,
                 quantize: str = "none", rerank_factor: int = 4,
                 device: str | torch.device | None = None):
        refuse_mesh(mesh)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.quantize = quantize
        self.rerank_factor = int(rerank_factor)
        self.item_ids = np.asarray(item_ids, np.int64)  # (N,) sorted ids

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        self.tables = dev(tables)         # (S, p, bucket) int32
        self.counts = dev(counts)         # (S, p) int32
        self.spills = dev(spills)         # (S, W) int32, padded with caps[s]
        self.partition = partition
        self._alive_host = np.array(alive, bool)    # (n_rows,) host mirror
        self.min_overlap = min_overlap
        self.bucket = bucket
        self.metas: list[RetrievalMeta] = list(metas or [])
        # per-group device slabs: views of one flat factor matrix
        factors = dev(factors)
        alive_dev = dev(self._alive_host)
        self.factors_g, self.alive_g = [], []
        for g in range(len(partition.groups)):
            lo, hi = partition.group_rows(g)
            self.factors_g.append(factors[lo:hi])
            self.alive_g.append(alive_dev[lo:hi])
        # int8 slabs: quantize each group's factor slab against its meta's
        # block width (skipping metas restored with slabs already attached);
        # the f32 slabs stay resident as the exact re-rank store
        if quantize == "int8":
            self.metas = [m if m.quantize == "int8"
                          else quantize_meta(m, self.factors_g[g])
                          for g, m in enumerate(self.metas)]
        # flat row -> catalog id (-1 on pad rows)
        self._padded_ids = np.full(partition.n_rows, -1, np.int64)
        for s in range(partition.n_shards):
            off, st, ln = (partition.offsets[s], partition.starts[s],
                           partition.lengths[s])
            self._padded_ids[off:off + ln] = self.item_ids[st:st + ln]
        # catalog rank -> shard: the right edges of the shards' rank ranges
        self._rank_ends = np.cumsum(partition.lengths)

    # ------------------------------------------------------------- build

    @staticmethod
    def build(factors: np.ndarray, cfg: GamConfig, *,
              item_ids: np.ndarray | None = None, n_shards: int = 1,
              min_overlap: int = 1, bucket: int = 256, mesh=None,
              partition: Partition | None = None,
              premapped=None, quantize: str = "none",
              rerank_factor: int = 4,
              device: str | torch.device | None = None
              ) -> "ShardedGamIndex":
        """Eager build: the same staged units the background compaction
        planner drives incrementally, run back to back.  ``premapped``:
        optional (tau, mask) aligned with the CALLER's row order, when the
        phi-mapping was already paid (e.g. by the repartitioner's weights)."""
        refuse_mesh(mesh)
        device = resolve_device(device)
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        factors = np.asarray(factors, np.float32)
        n, _ = factors.shape
        if item_ids is None:
            item_ids = np.arange(n, dtype=np.int64)
        item_ids = np.asarray(item_ids, np.int64)
        if len(np.unique(item_ids)) != n:
            raise ValueError("item_ids must be unique")
        order = np.argsort(item_ids)
        item_ids, factors = item_ids[order], factors[order]

        if partition is None:
            partition = Partition.uniform(n, n_shards)
        elif partition.n != n:
            raise ValueError(f"partition covers {partition.n} rows, "
                             f"catalog has {n}")

        if premapped is None:
            tau, vals = sparse_map(torch.as_tensor(factors, device=device),
                                   cfg)
            tau, mask = tau.cpu().numpy(), (vals != 0.0).cpu().numpy()
        else:
            tau, mask = premapped
            tau = np.asarray(tau)[order]
            mask = np.asarray(mask, bool)[order]

        segs = [build_shard_segment(tau, mask, partition, s, cfg.p, bucket)
                for s in range(partition.n_shards)]
        spill_list = [sp for _, _, sp in segs]
        metas = [build_group_meta(tau, mask, cfg.p, partition, g, spill_list,
                                  device=device)
                 for g in range(len(partition.groups))]
        return ShardedGamIndex.assemble(
            cfg, item_ids, factors, partition,
            [t for t, _, _ in segs], [c for _, c, _ in segs], spill_list,
            metas, min_overlap=min_overlap, bucket=bucket,
            quantize=quantize, rerank_factor=rerank_factor, device=device)

    @staticmethod
    def assemble(cfg: GamConfig, item_ids: np.ndarray, factors: np.ndarray,
                 partition: Partition, tables, counts, spill_list, metas, *,
                 min_overlap: int, bucket: int, mesh=None,
                 quantize: str = "none", rerank_factor: int = 4,
                 device: str | torch.device | None = None
                 ) -> "ShardedGamIndex":
        """Final stage: stack the per-shard segments, lay the factor slabs
        into the padded flat matrix, upload, and construct the index."""
        n, k = factors.shape
        width = max((np.asarray(sp).size for sp in spill_list), default=0)
        spills = (np.stack([
            np.concatenate([np.asarray(sp, np.int32),
                            np.full(width - np.asarray(sp).size,
                                    partition.caps[s], np.int32)])
            for s, sp in enumerate(spill_list)
        ]) if width else np.full((partition.n_shards, 0),
                                 partition.caps[0] if partition.caps else 0,
                                 np.int32))

        flat = np.zeros((partition.n_rows, k), np.float32)
        alive = np.zeros(partition.n_rows, bool)
        for s in range(partition.n_shards):
            off, st, ln = (partition.offsets[s], partition.starts[s],
                           partition.lengths[s])
            flat[off:off + ln] = factors[st:st + ln]
            alive[off:off + ln] = True
        return ShardedGamIndex(cfg, item_ids, np.stack(tables),
                               np.stack(counts), spills, flat, alive,
                               partition, min_overlap, bucket, mesh, metas,
                               quantize=quantize, rerank_factor=rerank_factor,
                               device=device)

    # ------------------------------------------------------------- state

    @property
    def n_shards(self) -> int:
        return self.partition.n_shards

    @property
    def n_live(self) -> int:
        return int(self._alive_host.sum())

    @property
    def meta(self) -> RetrievalMeta:
        """The single-group block metadata (uniform partitions)."""
        if len(self.metas) != 1:
            raise ValueError("heterogeneous partition has one meta per "
                             "bn-group; read .metas")
        return self.metas[0]

    def rows_of(self, ids) -> np.ndarray:
        """Catalog ids -> global flat rows (int64), -1 for ids not in this
        segment (the reference's ``_row_of`` lookup, vectorised)."""
        ids = np.asarray(ids, np.int64).ravel()
        out = np.full(ids.shape, -1, np.int64)
        if not self.item_ids.size or not ids.size:
            return out
        rank = np.searchsorted(self.item_ids, ids)
        hit = rank < self.item_ids.size
        hit[hit] = self.item_ids[rank[hit]] == ids[hit]
        r = rank[hit]
        shard = np.searchsorted(self._rank_ends, r, side="right")
        starts = np.asarray(self.partition.starts, np.int64)
        offsets = np.asarray(self.partition.offsets, np.int64)
        out[hit] = r - starts[shard] + offsets[shard]
        return out

    def kill(self, ids) -> None:
        """Tombstone catalog ids (deleted or superseded by a delta upsert).

        O(batch + touched blocks).  Besides flipping ``alive``, the dead
        rows' pattern bits and spill flags are removed from the fused
        kernel's block metadata (pattern bitsets, block unions, block spill
        flags) group by group: the block-union popcount must upper-bound
        the overlap of LIVE members only, otherwise long tombstone streams
        erode the zero-candidate block-skip rate until ``compact()``.
        Candidate sets are unchanged — dead rows were already excluded
        in-kernel via ``alive`` — so query results are bit-identical before
        and after the refresh.

        The reference rebuilds each touched array functionally
        (``.at[].set``); the port writes the device tensors in place
        (indexed assignment on the alive mask, the transposed bitsets, the
        spill flags and the touched blocks' unions and spill flags), so a
        kill copies no whole array.
        """
        rows_a = self.rows_of(ids)
        rows_a = rows_a[rows_a >= 0]
        if not rows_a.size:
            return
        self._alive_host[rows_a] = False
        for g, meta in enumerate(self.metas):
            lo, hi = self.partition.group_rows(g)
            sel = rows_a[(rows_a >= lo) & (rows_a < hi)] - lo
            if sel.size == 0:
                continue
            sel_t = torch.as_tensor(sel, device=self.device)
            self.alive_g[g][sel_t] = False
            meta.item_bits_t[:, sel_t] = 0
            meta.spill8[0, sel_t] = 0
            bn, words = meta.bn, meta.words
            blocks = torch.as_tensor(np.unique(sel // bn),
                                     device=self.device)
            cols = (blocks[:, None] * bn
                    + torch.arange(bn, device=self.device)).reshape(-1)
            bits = meta.item_bits_t[:, cols].T.reshape(-1, bn, words)
            meta.block_union[blocks] = _or_blocks(bits)
            meta.block_spill[blocks] = (
                meta.spill8[0, cols].reshape(-1, bn) != 0).any(dim=1)

    def block_index(self, rows) -> np.ndarray:
        """Global flat rows -> global kernel block ids (blocks numbered
        group by group) — maps the metrics' per-block candidate loads back
        onto items for the repartitioner's weights."""
        rows = np.asarray(rows, np.int64)
        out = np.zeros(rows.shape, np.int64)
        blk_off = 0
        for g, meta in enumerate(self.metas):
            lo, hi = self.partition.group_rows(g)
            m = (rows >= lo) & (rows < hi)
            out[m] = blk_off + (rows[m] - lo) // meta.bn
            blk_off += meta.n_blocks
        return out

    def total_blocks(self) -> int:
        """Kernel blocks across every bn-group (the block-metrics width)."""
        return sum(m.n_blocks for m in self.metas)

    def posting_load(self) -> np.ndarray:
        """(S,) total posting entries per shard — the balance statistic."""
        return self.counts.sum(dim=-1).cpu().numpy()

    def flat_factors(self) -> np.ndarray:
        """(n_rows, k) host copy of the padded flat factor matrix."""
        return torch.cat(self.factors_g).cpu().numpy()

    def device_bytes(self) -> dict:
        """Bytes the index holds on its device, by part."""
        def nbytes(ts):
            return int(sum(t.numel() * t.element_size() for t in ts))

        metas = self.metas
        out = {"posting_tables": nbytes([self.tables, self.counts,
                                         self.spills]),
               "bitsets": nbytes([t for m in metas for t in (
                   m.item_bits_t, m.block_union, m.block_spill, m.spill8)]),
               "factors": nbytes(self.factors_g),
               "alive": nbytes(self.alive_g)}
        if self.quantize == "int8":
            out["int8_slabs"] = nbytes([t for m in metas
                                        for t in (m.factors_q, m.scales)])
        return out

    # ------------------------------------------------------------- query

    def _shard_candidates(self, blk: np.ndarray) -> np.ndarray:
        """(Q, n_blocks) per-block candidate counts -> (Q, S) per-shard."""
        nb = [self.partition.caps[s] // self.partition.bns[s]
              for s in range(self.n_shards)]
        starts = np.concatenate([[0], np.cumsum(nb)[:-1]]).astype(int)
        return np.add.reduceat(blk, starts, axis=1)

    def query(self, users: torch.Tensor, q_tau: torch.Tensor,
              q_mask: torch.Tensor, kappa: int, *, exact: bool = False,
              tracer=None, collect_tile_skips: bool = False,
              min_overlap: int | None = None) -> ShardTopK:
        """users (Q, k) f32 + mapped query patterns, on the index's device
        -> merged top-kappa.

        One fused ``gam_retrieve`` launch per bn-group (uniform partitions:
        exactly one over the whole flat factor matrix): candidate pruning,
        scoring and the in-group top-kappa all happen in the kernel
        (zero-candidate item blocks are skipped outright); heterogeneous
        partitions merge the per-group top-kappas on the host under the
        same (score desc, global row asc) order.  ``exact=True`` scores
        every live row through the same kernel (``min_overlap=0``).

        ``tracer`` wraps each per-group launch and the host merge in spans;
        ``collect_tile_skips`` also expands the kernel's per-query-block
        skip map to a per-query (Q, n_blocks) bool in
        ``ShardTopK.tile_skips`` (host numpy over existing outputs)."""
        tracer = NOOP_TRACER if tracer is None else tracer
        # min_overlap override: the QoS degrade ladder raises the prune
        # threshold one notch under deadline pressure (exact still wins)
        mo = 0 if exact else (self.min_overlap if min_overlap is None
                              else int(min_overlap))
        q = int(users.shape[0])
        results = []
        for g, meta in enumerate(self.metas):
            with tracer.span("gam_retrieve", group=g, bn=meta.bn,
                             n_rows=meta.n_rows):
                results.append(gam_retrieve(
                    users, self.factors_g[g], q_tau, q_mask, meta, kappa,
                    min_overlap=mo, alive=self.alive_g[g],
                    rerank_factor=self.rerank_factor))
        host = [(r.vals.cpu().numpy(), r.rows.cpu().numpy(),
                 r.blk_counts.cpu().numpy().astype(np.int64),
                 r.skipped.cpu().numpy()) for r in results]
        skips = (np.concatenate([expand_tile_skips(sk, q)
                                 for _, _, _, sk in host], axis=1)
                 if collect_tile_skips and host else None)
        if len(host) == 1:
            vals, rows, blk, sk = host[0]
            return ShardTopK(scores=vals.astype(np.float32),
                             rows=rows.astype(np.int32),
                             shard_candidates=self._shard_candidates(blk),
                             block_candidates=blk,
                             tiles_skipped_frac=float(sk.mean()),
                             tile_skips=skips)
        with tracer.span("group_merge", n_groups=len(host)):
            exported = [export_topk(v, r,
                                    offset=self.partition.group_rows(g)[0])
                        for g, (v, r, _, _) in enumerate(host)]
            cat_s = np.concatenate([s for s, _ in exported], axis=1)
            cat_r = np.concatenate([r for _, r in exported], axis=1)
            order = np.lexsort((cat_r, -cat_s), axis=-1)[:, :kappa]
            vals = np.take_along_axis(cat_s, order, axis=-1)
            rows = np.take_along_axis(cat_r, order, axis=-1)
            rows = np.where(vals <= NEG / 2, -1, rows).astype(np.int32)
        blk = np.concatenate([b for _, _, b, _ in host], axis=1)
        tiles = sum(sk.size for _, _, _, sk in host)
        skipped = sum(int(sk.sum()) for _, _, _, sk in host)
        return ShardTopK(scores=vals, rows=rows,
                         shard_candidates=self._shard_candidates(blk),
                         block_candidates=blk,
                         tiles_skipped_frac=skipped / max(tiles, 1),
                         tile_skips=skips)

    def query_dense_reference(self, users: torch.Tensor, q_tau: torch.Tensor,
                              q_mask: torch.Tensor, kappa: int, *,
                              exact: bool = False) -> ShardTopK:
        """The (Q, N)-mask path, kept as the parity oracle.

        Per-shard candidate masks from the posting tables, dense masked
        scoring (``masked_topk`` on the ``gam_score`` kernel), one top-kappa
        over the whole flat row space with ties broken by ascending global
        row — the same total order the fused accumulator realises.  Works
        on any partition; the masks are computed a few queries at a time."""
        q = int(users.shape[0])
        dev = self.device
        alive = torch.as_tensor(self._alive_host, device=dev)
        if exact:
            masks = alive[None, :].expand(q, self.partition.n_rows)
        else:
            k = q_tau.shape[1]
            step = max(1, _MASK_CHUNK // max(1, k * self.tables.shape[-1]))
            cols = []
            for s in range(self.n_shards):
                cap = self.partition.caps[s]
                col = torch.empty((q, cap), dtype=torch.bool, device=dev)
                for i in range(0, q, step):
                    col[i:i + step] = candidate_mask_from_table(
                        self.tables[s], self.spills[s], q_tau[i:i + step],
                        q_mask[i:i + step], sentinel=cap,
                        min_overlap=self.min_overlap)
                cols.append(col)
            masks = torch.cat(cols, dim=1) & alive[None, :]
        flat = torch.cat(self.factors_g)
        vals, rows = masked_topk(users, flat, masks.contiguous(), kappa)
        vals = vals.cpu().numpy().astype(np.float32)
        rows = np.where(vals <= NEG / 2, -1, rows.cpu().numpy())
        part = self.partition
        shard_cand = np.stack(
            [masks[:, part.offsets[s]:part.offsets[s] + part.caps[s]]
             .sum(dim=1).cpu().numpy() for s in range(self.n_shards)],
            axis=1)
        return ShardTopK(scores=vals, rows=rows.astype(np.int32),
                         shard_candidates=shard_cand)

    def rows_to_ids(self, rows: np.ndarray, scores: np.ndarray) -> np.ndarray:
        """Global rows -> catalog ids; empty (NEG-scored) slots -> -1."""
        rows = np.asarray(rows, np.int64)
        out = self._padded_ids[rows]
        out[np.asarray(scores) <= NEG / 2] = -1
        return out
