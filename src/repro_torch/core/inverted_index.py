"""Dense-bucket inverted index over sparse embeddings (paper §1.1).

Counterpart of the device half of ``repro.core.inverted_index``:
``build_segment`` (the numpy scatter build of one posting segment),
``candidate_mask_from_table`` (the single definition of candidate semantics),
``DeviceIndex`` (the table on a torch device) and ``table_to_csr`` /
``csr_to_table`` (the codec-facing flattening of a table, numpy as in the
reference).  The CPU CSR and the compressed CPU index come with a later
slice of the port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["DeviceIndex", "build_segment", "candidate_mask_from_table",
           "csr_to_table", "table_to_csr"]

# table entries gathered per step of the batched mask (bounds temporaries)
_MASK_CHUNK = 1 << 24


def build_segment(item_indices: np.ndarray, p: int, bucket: int,
                  mask: np.ndarray | None = None, sentinel: int | None = None,
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorised scatter build of one dense-bucket posting segment ->
    ``(table (p, bucket) int32 padded with sentinel, counts (p,) int32
    clipped to bucket, spill: sorted int32 ids overflowing any bucket)``.
    Within each posting list entries appear in item order."""
    item_indices = np.asarray(item_indices)
    n, k = item_indices.shape
    if sentinel is None:
        sentinel = n
    if mask is None:
        mask = np.ones((n, k), bool)
    mask = np.asarray(mask, bool)
    flat_slots = item_indices[mask].astype(np.int64)
    flat_items = np.broadcast_to(
        np.arange(n, dtype=np.int32)[:, None], (n, k))[mask]
    order = np.argsort(flat_slots, kind="stable")
    slots_sorted = flat_slots[order]
    items_sorted = flat_items[order]
    counts_full = np.bincount(slots_sorted, minlength=p)
    starts = np.zeros(p, np.int64)
    np.cumsum(counts_full[:-1], out=starts[1:])
    pos = np.arange(slots_sorted.size, dtype=np.int64) - starts[slots_sorted]
    table = np.full((p, bucket), sentinel, dtype=np.int32)
    fit = pos < bucket
    table[slots_sorted[fit], pos[fit]] = items_sorted[fit]
    spill = np.unique(items_sorted[~fit]).astype(np.int32)
    counts = np.minimum(counts_full, bucket).astype(np.int32)
    return table, counts, spill


def table_to_csr(table: np.ndarray, counts: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Dense-bucket ``(p, bucket)`` table + per-slot counts -> CSR
    ``(postings, offsets)`` of the real (non-pad) entries, ascending within
    each slot (the builder's invariant)."""
    table = np.asarray(table)
    counts = np.asarray(counts, np.int64)
    keep = np.arange(table.shape[1])[None, :] < counts[:, None]
    postings = table[keep].astype(np.int64)
    offsets = np.zeros(counts.size + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return postings, offsets


def csr_to_table(postings: np.ndarray, offsets: np.ndarray, bucket: int,
                 sentinel: int) -> tuple[np.ndarray, np.ndarray]:
    """Inverse of :func:`table_to_csr`: the ``(p, bucket)`` sentinel-padded
    int32 table + int32 counts (lists must already be bucket-clipped)."""
    offsets = np.asarray(offsets, np.int64)
    counts = np.diff(offsets)
    if counts.size and int(counts.max()) > bucket:
        raise ValueError(f"slot length {int(counts.max())} > bucket {bucket}")
    table = np.full((counts.size, bucket), sentinel, np.int32)
    keep = np.arange(bucket)[None, :] < counts[:, None]
    table[keep] = np.asarray(postings, np.int64)
    return table, counts.astype(np.int32)


def candidate_mask_from_table(table: torch.Tensor, spill: torch.Tensor,
                              query_indices: torch.Tensor,
                              query_mask: torch.Tensor, *, sentinel: int,
                              min_overlap: int) -> torch.Tensor:
    """Candidate mask of query patterns against a dense-bucket table.

    ``query_indices``/``query_mask``: (k,) or (Q, k) -> (sentinel,) or
    (Q, sentinel) bool.  Spill entries are always candidates; pad entries
    (id == sentinel) drop out of the count, and so do spill entries outside
    ``0..sentinel-1`` (the sharded index pads its spill lists with the
    shard's cap), as the reference's ``mode="drop"`` scatter drops them."""
    single = query_indices.dim() == 1
    qi = query_indices.reshape(-1, query_indices.shape[-1]).long()
    qm = query_mask.reshape(qi.shape).to(torch.bool)
    q = qi.shape[0]
    rows = table[qi]                                   # (Q, k, bucket)
    valid = (rows < sentinel) & qm[..., None]
    # count only the real entries (pads would pile onto one counter)
    flat = (torch.arange(q, device=table.device)[:, None, None] * sentinel
            + rows)[valid]
    overlap = torch.bincount(flat, minlength=q * sentinel).view(q, sentinel)
    out = overlap >= min_overlap
    spill = spill.long()
    out[:, spill[(spill >= 0) & (spill < sentinel)]] = True
    return out[0] if single else out


@dataclasses.dataclass
class DeviceIndex:
    """Dense-bucket inverted index living on a torch device.

    table:  (p, bucket) int32 item ids, padded with n_items (a sentinel id).
    counts: (p,) int32 true posting-list lengths.
    spill:  (n_spill,) int32 ids of items overflowing any bucket, always
            treated as candidates (recall-preserving).
    """

    table: torch.Tensor
    counts: torch.Tensor
    spill: torch.Tensor
    n_items: int
    p: int

    @staticmethod
    def build(item_indices: np.ndarray, p: int, bucket: int = 256,
              mask: np.ndarray | None = None,
              device: str | torch.device = "cpu") -> "DeviceIndex":
        item_indices = np.asarray(item_indices)
        table, counts, spill = build_segment(item_indices, p, bucket, mask)
        return DeviceIndex(table=torch.as_tensor(table, device=device),
                           counts=torch.as_tensor(counts, device=device),
                           spill=torch.as_tensor(spill, device=device),
                           n_items=item_indices.shape[0], p=p)

    def candidate_mask(self, query_indices: torch.Tensor, min_overlap: int = 1,
                       query_mask: torch.Tensor | None = None) -> torch.Tensor:
        """(n_items,) bool candidate mask for one query pattern."""
        if query_mask is None:
            query_mask = torch.ones_like(query_indices, dtype=torch.bool)
        return candidate_mask_from_table(
            self.table, self.spill, query_indices, query_mask,
            sentinel=self.n_items, min_overlap=min_overlap)

    def batch_candidate_mask(self, query_indices: torch.Tensor,
                             min_overlap: int = 1,
                             query_mask: torch.Tensor | None = None
                             ) -> torch.Tensor:
        """(Q, n_items) bool masks, computed a few queries at a time."""
        if query_mask is None:
            query_mask = torch.ones_like(query_indices, dtype=torch.bool)
        q, k = query_indices.shape
        out = torch.empty((q, self.n_items), dtype=torch.bool,
                          device=self.table.device)
        step = max(1, _MASK_CHUNK // max(1, k * self.table.shape[1]))
        for i in range(0, q, step):
            out[i:i + step] = candidate_mask_from_table(
                self.table, self.spill, query_indices[i:i + step],
                query_mask[i:i + step], sentinel=self.n_items,
                min_overlap=min_overlap)
        return out
