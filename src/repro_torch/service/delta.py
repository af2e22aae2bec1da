"""Streaming delta segment: in-place upserts/deletes between compactions.

Counterpart of ``repro.service.delta``.  New and re-written items land in a
small dense segment that participates in EVERY query, with the same
candidate + exact-scoring semantics as the main shards: the segment keeps
its own dense-bucket posting table (rebuilt from scratch on each mutation,
O(nnz) at delta sizes) for the spill flags, and queries stream through the
same fused ``gam_retrieve`` kernel as the main segment — no (Q, n_delta)
mask is ever materialised.  Because candidate determination is per item
(pattern overlap against the query, plus bucket-spill), a query against
base + delta returns exactly what a fresh rebuild over the merged catalog
would return, provided neither structure overflows its buckets.

Every mutation re-maps the whole delta through ``sparse_map`` (the
``tess_project`` kernel on the card) and re-uploads its tensors to the
segment's device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.inverted_index import DeviceIndex
from repro_torch.core.mapping import GamConfig, sparse_map
from repro_torch.device import resolve_device
from repro_torch.kernels.gam_retrieve import build_retrieval_meta
from repro_torch.kernels.ops import gam_retrieve
from repro_torch.retriever.types import dedupe_last_write

__all__ = ["DeltaSegment"]


class DeltaSegment:
    """Always-queried dense segment of streamed (id, factor) rows."""

    def __init__(self, cfg: GamConfig, min_overlap: int = 1,
                 bucket: int = 64, *, quantize: str = "none",
                 rerank_factor: int = 4,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.min_overlap = min_overlap
        self.bucket = bucket
        self.quantize = quantize
        self.rerank_factor = int(rerank_factor)
        self.device = resolve_device(device)
        self.ids = np.zeros(0, np.int64)          # sorted ascending
        self.factors = np.zeros((0, cfg.k), np.float32)
        self._index: DeviceIndex | None = None
        self._factors_dev = None
        self._meta = None                 # fused-kernel block metadata
        self._alive = None                # (cap,) bool: real vs pad rows

    def __len__(self) -> int:
        return int(self.ids.size)

    # ---------------------------------------------------------- mutation

    def upsert(self, ids, factors) -> None:
        ids = np.asarray(ids, np.int64).ravel()
        factors = np.asarray(factors, np.float32).reshape(ids.size, self.cfg.k)
        ids, factors = dedupe_last_write(ids, factors)
        keep = ~np.isin(self.ids, ids)
        merged_ids = np.concatenate([self.ids[keep], ids])
        merged_fac = np.concatenate([self.factors[keep], factors])
        order = np.argsort(merged_ids)
        self.ids, self.factors = merged_ids[order], merged_fac[order]
        self._rebuild()

    def delete(self, ids) -> None:
        keep = ~np.isin(self.ids, np.asarray(ids, np.int64).ravel())
        self.ids, self.factors = self.ids[keep], self.factors[keep]
        self._rebuild()

    def replace(self, ids, factors) -> None:
        """Set the whole segment content in one shot (compaction swap and
        snapshot restore).  Equivalent to ``clear()`` + ``upsert(...)`` —
        the segment state is a deterministic function of its sorted
        (ids, factors), so this reproduces the packed patterns and posting
        table bit for bit regardless of the mutation history."""
        ids = np.asarray(ids, np.int64).ravel()
        factors = np.asarray(factors, np.float32).reshape(ids.size,
                                                          self.cfg.k)
        order = np.argsort(ids)
        self.ids, self.factors = ids[order], factors[order]
        self._rebuild()

    def clear(self) -> None:
        self.ids = np.zeros(0, np.int64)
        self.factors = np.zeros((0, self.cfg.k), np.float32)
        self._rebuild()

    def _rebuild(self) -> None:
        if not len(self):
            self._index = None
            self._factors_dev = None
            self._meta = None
            self._alive = None
            return
        dev = self.device
        factors = torch.as_tensor(self.factors, device=dev)
        tau, vals = sparse_map(factors, self.cfg)
        tau, mask = tau.cpu().numpy(), (vals != 0.0).cpu().numpy()
        self._index = DeviceIndex.build(tau, self.cfg.p, self.bucket,
                                        mask=mask, device=dev)
        # factor rows pad to the next power of two, as in the reference:
        # the slab keeps one shape across consecutive upserts
        cap = 1 << (len(self) - 1).bit_length()
        padded = torch.zeros((cap, self.cfg.k), dtype=torch.float32,
                             device=dev)
        padded[:len(self)] = factors
        self._factors_dev = padded
        # quantization is local: only the delta's own rows are re-quantized
        # on mutation — base-segment slabs are never touched from here
        self._meta = build_retrieval_meta(
            tau, mask, self.cfg.p, n_rows=cap,
            spill_rows=self._index.spill.cpu().numpy(),
            bn=min(256, cap),
            factors=factors if self.quantize == "int8" else None,
            quantize=self.quantize, device=dev)
        self._alive = torch.arange(cap, device=dev) < len(self)

    # ---------------------------------------------------------- query

    def query(self, users, q_tau, q_mask, kappa: int, *,
              exact: bool = False, min_overlap: int | None = None):
        """-> (scores (Q, kk) f32 with NEG pads, catalog ids (Q, kk) int64,
        candidates (Q,) int64) over the delta rows only; kk = min(kappa,
        len(self)).  ``users``/``q_tau``/``q_mask`` lie on the segment's
        device.  ``min_overlap`` overrides the segment's prune threshold
        (the QoS degrade ladder raises it under deadline pressure)."""
        if not len(self):
            q = int(users.shape[0])
            return (np.zeros((q, 0), np.float32), np.zeros((q, 0), np.int64),
                    np.zeros(q, np.int64))
        kk = min(kappa, len(self))
        # pad rows are dead via ``alive`` and carry empty patterns, so they
        # are never candidates on the pruned or the exact path
        mo = self.min_overlap if min_overlap is None else int(min_overlap)
        res = gam_retrieve(users, self._factors_dev, q_tau, q_mask,
                           self._meta, kk,
                           min_overlap=0 if exact else mo,
                           alive=self._alive,
                           rerank_factor=self.rerank_factor)
        n_cand = res.blk_counts.cpu().numpy().astype(np.int64).sum(axis=1)
        # empty (NEG-scored) slots carry row -1; clip before the id gather
        # (the caller replaces their ids via the NEG-score filter anyway)
        local = np.clip(res.rows.cpu().numpy().astype(np.int64), 0,
                        len(self) - 1)
        return res.vals.cpu().numpy().astype(np.float32), self.ids[local], \
            n_cand
