"""Inverted index over sparse embeddings (paper §1.1), in PyTorch.

Counterpart of ``repro.core.inverted_index``, with every realisation on a
torch device:

* ``InvertedIndex``: the paper's CSR posting lists (``postings`` int32,
  ``offsets`` int64).  A query gathers its slots' posting slices and counts
  overlaps in an int32 ``(queries, n_items)`` counter, a chunk of queries at
  a time, so a request costs a few synchronisations a chunk and not one a
  query.
* ``CompressedInvertedIndex``: the same index factored through the pattern
  dictionary (slot -> pattern ids, pattern id -> items), both halves delta +
  group-varint coded with the reference's bytes.  A query decodes only its
  slots and the patterns that pass ``min_overlap``, on the device, and
  answers as the flat index does.
* ``DeviceIndex``: the dense-bucket ``(p, bucket)`` table of the fused
  kernel's path, built by ``build_segment`` (numpy, as in the reference);
  ``candidate_mask_from_table`` is the single definition of its candidate
  semantics, and ``table_to_csr`` / ``csr_to_table`` its codec-facing
  flattening.

Both CSR realisations answer ``query`` / ``batch_query`` with the
reference's ascending ids (int32) and overlaps (int64), as tensors on the
index's device; ``candidates`` gives one request's answer flat, the form the
``gam`` backend scores.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.compress.patterns import pattern_dict_encode
from repro_torch.compress.postings import (CodecError, CompressedPostings,
                                           decode_postings, encode_postings)
from repro_torch.device import resolve_device

__all__ = ["CompressedInvertedIndex", "DeviceIndex", "InvertedIndex",
           "build_segment", "candidate_mask_from_table", "csr_to_table",
           "expand_ranges", "table_to_csr"]

# table entries gathered per step of the batched mask (bounds temporaries)
_MASK_CHUNK = 1 << 24
# counter cells (queries x items, or x patterns) of one chunk of queries
_COUNTER_CHUNK = 1 << 25


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


def expand_ranges(starts: torch.Tensor, lens: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The concatenated ``arange(starts[i], starts[i] + lens[i])`` over i,
    and the i of each entry (both int64, on the inputs' device)."""
    lens = lens.reshape(-1).to(torch.int64)
    starts = starts.reshape(-1).to(torch.int64)
    total = int(lens.sum())
    owner = torch.repeat_interleave(
        torch.arange(lens.numel(), device=lens.device), lens,
        output_size=total)
    shift = torch.cumsum(lens, 0) - lens
    pos = torch.arange(total, device=lens.device) + (starts - shift)[owner]
    return pos, owner


def _tensor(x, device: torch.device) -> torch.Tensor:
    """A tensor on ``device``; host arrays are copied (they may be
    read-only)."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.tensor(np.asarray(x), device=device)


def _query_rows(query_indices, mask, device: torch.device
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, k) or (k,) slot indices + optional mask -> (Q, k) int64 and
    (Q, k) bool tensors on ``device``."""
    qi = _tensor(query_indices, device).to(torch.int64)
    if qi.dim() == 1:
        qi = qi[None]
    if mask is None:
        return qi, torch.ones_like(qi, dtype=torch.bool)
    return qi, _tensor(mask, device).to(torch.bool).reshape(qi.shape)


def _offsets(counts: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(counts.numel() + 1, dtype=torch.int64,
                      device=counts.device)
    torch.cumsum(counts, 0, out=out[1:])
    return out


def _empty_candidates(device) -> tuple[torch.Tensor, ...]:
    e = torch.empty(0, dtype=torch.int64, device=device)
    return e, e, e


class _PostingIndex:
    """``query`` / ``batch_query`` of both CSR realisations, over their
    ``candidates``."""

    n_items: int
    device: torch.device

    def candidates(self, query_indices, min_overlap: int = 1, mask=None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def query(self, query_indices, min_overlap: int = 1, mask=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """Candidates of one query: (ascending ids int32, overlaps int64) of
        the items sharing >= ``min_overlap`` slots with its pattern."""
        qi = _tensor(query_indices, self.device).reshape(1, -1)
        qm = None if mask is None else _tensor(mask, self.device).reshape(
            1, -1)
        _, ids, overlaps = self.candidates(qi, min_overlap, qm)
        return ids.to(torch.int32), overlaps

    def batch_query(self, query_indices, min_overlap: int = 1, mask=None
                    ) -> list[tuple[torch.Tensor, torch.Tensor]]:
        qi, qm = _query_rows(query_indices, mask, self.device)
        qrow, ids, overlaps = self.candidates(qi, min_overlap, qm)
        sizes = torch.bincount(qrow, minlength=qi.shape[0]).tolist()
        return list(zip(torch.split(ids.to(torch.int32), sizes),
                        torch.split(overlaps, sizes)))


class InvertedIndex(_PostingIndex):
    """CSR posting lists on a torch device: for each embedding slot i, the
    ascending items whose phi is non-zero at i."""

    def __init__(self, item_indices, p: int, mask=None, *,
                 device: str | torch.device | None = None):
        """``item_indices``: (N, k) destination indices tau of each item;
        ``mask``: optional (N, k) bool, only True slots are indexed (the
        paper stores only the coordinates where phi(v) is non-zero).
        ``device``: ``None`` is the card, ``"cpu"`` the plain path."""
        self.device = resolve_device(device)
        tau = _tensor(item_indices, self.device)
        n, k = tau.shape
        self.n_items, self.p, self.k = n, p, k
        mask = (torch.ones((n, k), dtype=torch.bool, device=self.device)
                if mask is None else _tensor(mask, self.device).to(torch.bool))
        flat_slots = tau[mask].to(torch.int64)
        flat_items = torch.arange(n, dtype=torch.int32, device=self.device
                                  )[:, None].expand(n, k)[mask]
        self.postings = flat_items[torch.argsort(flat_slots, stable=True)]
        self.offsets = _offsets(torch.bincount(flat_slots, minlength=p))

    @classmethod
    def from_csr(cls, postings, offsets, *, n_items: int, p: int, k: int,
                 device: str | torch.device | None = None) -> "InvertedIndex":
        """The index over a CSR as ``InvertedIndex`` lays it out (int32
        postings ascending in each slot, int64 offsets)."""
        out = cls.__new__(cls)
        out.device = resolve_device(device)
        out.n_items, out.p, out.k = int(n_items), int(p), int(k)
        out.postings = _tensor(postings, out.device).to(torch.int32)
        out.offsets = _tensor(offsets, out.device).to(torch.int64)
        return out

    def posting_list(self, slot: int) -> torch.Tensor:
        lo, hi = self.offsets[slot:slot + 2].tolist()
        return self.postings[lo:hi]

    def candidates(self, query_indices, min_overlap: int = 1, mask=None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One request's candidates, flat: (query row, item id, overlap),
        all int64, ordered by (row, id).  A query with no unmasked slot has
        none, whatever ``min_overlap``."""
        qi, qm = _query_rows(query_indices, mask, self.device)
        q, n = qi.shape[0], self.n_items
        if q == 0 or n == 0:
            return _empty_candidates(self.device)
        out = []
        step = max(1, _COUNTER_CHUNK // n)
        for c0 in range(0, q, step):
            s, m = qi[c0:c0 + step], qm[c0:c0 + step]
            qc = s.shape[0]
            starts = self.offsets[s]
            lens = torch.where(m, self.offsets[s + 1] - starts, 0)
            pos, owner = expand_ranges(starts, lens)
            counter = torch.zeros(qc * n, dtype=torch.int32,
                                  device=self.device)
            counter.index_add_(
                0, (owner // s.shape[1]) * n + self.postings[pos].long(),
                torch.ones(pos.numel(), dtype=torch.int32,
                           device=self.device))
            counter = counter.view(qc, n)
            hit = torch.nonzero((counter >= min_overlap)
                                & m.any(dim=1, keepdim=True))
            out.append((hit[:, 0] + c0, hit[:, 1],
                        counter[hit[:, 0], hit[:, 1]].to(torch.int64)))
        return tuple(torch.cat(parts) for parts in zip(*out))

    def compress(self) -> "CompressedInvertedIndex":
        """Factor this index through the pattern dictionary and encode both
        CSR halves (see :class:`CompressedInvertedIndex`)."""
        return CompressedInvertedIndex.from_inverted(self)

    @property
    def nbytes(self) -> int:
        return 4 * self.postings.numel() + 8 * self.offsets.numel()


class _Stream:
    """One encoded CSR half on the device: its bytes, per-slot counts and
    value offsets (the host :class:`CompressedPostings` stays beside it)."""

    def __init__(self, cp: CompressedPostings, device: torch.device):
        self.n_values = int(cp.n_values)
        self.data = torch.from_numpy(np.ascontiguousarray(cp.data,
                                                          np.uint8)).to(device)
        self.counts = torch.from_numpy(np.asarray(cp.counts, np.int64)).to(
            device)
        self.voff = _offsets(self.counts)


def _decode_slot_ranges(stream: _Stream, slots: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Decode only the requested slots of an encoded CSR stream, on its
    device -> (the concatenated values int64 in request order, per-slot
    lengths int64).

    Deltas restart absolute at every slot, so a slot decodes on its own:
    byte offsets come from the control bytes, the selected values' bytes
    are gathered and assembled little-endian with shifts, and a per-slot
    segmented cumsum restores the ids."""
    slots = slots.reshape(-1).to(torch.int64)
    lens = stream.counts[slots]
    vidx, _ = expand_ranges(stream.voff[slots], lens)
    total = vidx.numel()
    if total == 0:
        return vidx, lens
    ngroups = -(-stream.n_values // 4)
    ctrl = stream.data[:ngroups].to(torch.int64)
    shifts = 2 * torch.arange(4, device=ctrl.device)
    nb = (((ctrl[:, None] >> shifts) & 3) + 1).reshape(-1)
    boff = _offsets(nb)
    base = ngroups + boff[vidx]
    ln = nb[vidx]
    d = torch.zeros(total, dtype=torch.int64, device=ctrl.device)
    for j in range(4):
        sel = ln > j
        byte = stream.data[torch.where(sel, base + j, 0)].to(torch.int64)
        d |= torch.where(sel, byte << (8 * j), 0)
    # segmented cumsum: the first value of each slot is absolute
    c = torch.cumsum(d, 0)
    nz = lens > 0
    first = (torch.cumsum(lens, 0) - lens)[nz]
    bases = c[first] - d[first]
    return c - torch.repeat_interleave(bases, lens[nz], output_size=total), \
        lens


class CompressedInvertedIndex(_PostingIndex):
    """``InvertedIndex`` factored through shared patterns, varint-encoded.

    Two encoded CSR structures replace the flat posting lists:

      slot_patterns:  slot -> ascending ids of the distinct patterns with
                      that slot set (one entry per occupied cell).
      pattern_items:  pattern id -> ascending item ids carrying it.

    An item's overlap with a query is its pattern's overlap, so a query
    counts pattern hits first and expands only the patterns that pass
    ``min_overlap``: its answers equal :meth:`InvertedIndex.query`'s while
    storage shrinks to one posting per (pattern, slot) pair plus one id per
    item.  The bytes are the reference's; queries decode them on the
    index's device.
    """

    def __init__(self, slot_patterns: CompressedPostings,
                 pattern_items: CompressedPostings, *, n_items: int, p: int,
                 k: int, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.slot_patterns = slot_patterns
        self.pattern_items = pattern_items
        self.n_items = int(n_items)
        self.p = int(p)
        self.k = int(k)
        self._sp = _Stream(slot_patterns, self.device)
        self._pi = _Stream(pattern_items, self.device)

    @property
    def n_patterns(self) -> int:
        return self.pattern_items.p

    @property
    def nbytes(self) -> int:
        return int(self.slot_patterns.nbytes + self.pattern_items.nbytes)

    @classmethod
    def from_inverted(cls, index: InvertedIndex) -> "CompressedInvertedIndex":
        p, n, dev = index.p, index.n_items, index.device
        slots = torch.repeat_interleave(
            torch.arange(p, device=dev), torch.diff(index.offsets),
            output_size=index.postings.numel())
        items = index.postings.to(torch.int64)
        if torch.unique(slots * max(n, 1) + items).numel() != items.numel():
            raise CodecError("duplicate (slot, item) postings cannot be "
                             "pattern-factored")
        words = -(-p // 32)
        # distinct bits of one word add up to their OR
        bits = torch.zeros(n * words, dtype=torch.int64, device=dev)
        bits.index_add_(0, items * words + slots // 32,
                        torch.ones_like(slots) << (slots % 32))
        uniq, inverse = pattern_dict_encode(bits.view(n, words))
        u = max(uniq.shape[0], 1)
        inverse = inverse.to(torch.int64)
        # slot -> distinct pattern ids (unique (slot, pid) pairs, sorted)
        pairs = torch.unique(slots * u + inverse[items])
        sp_off = _offsets(torch.bincount(pairs // u, minlength=p))
        slot_patterns = encode_postings((pairs % u).cpu().numpy(),
                                        sp_off.cpu().numpy())
        # pattern id -> ascending item ids (stable sort keeps item order)
        order = torch.argsort(inverse, stable=True)
        pi_off = _offsets(torch.bincount(inverse, minlength=uniq.shape[0]))
        pattern_items = encode_postings(order.cpu().numpy(),
                                        pi_off.cpu().numpy())
        return cls(slot_patterns, pattern_items, n_items=n, p=p, k=index.k,
                   device=dev)

    # ------------------------------------------------------------- queries

    def posting_list(self, slot: int) -> torch.Tensor:
        pids, _ = _decode_slot_ranges(
            self._sp, torch.tensor([slot], device=self.device))
        items, _ = _decode_slot_ranges(self._pi, pids)
        return torch.sort(items).values.to(torch.int32)

    def candidates(self, query_indices, min_overlap: int = 1, mask=None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """As :meth:`InvertedIndex.candidates`, decoding only the queries'
        slots and the patterns that pass the overlap gate.  A query whose
        slots hold no pattern has no candidates, as in the reference."""
        qi, qm = _query_rows(query_indices, mask, self.device)
        q, n, u = qi.shape[0], self.n_items, self.n_patterns
        if q == 0 or u == 0:
            return _empty_candidates(self.device)
        out = []
        step = max(1, _COUNTER_CHUNK // u)
        for c0 in range(0, q, step):
            s, m = qi[c0:c0 + step], qm[c0:c0 + step]
            qc = s.shape[0]
            rows, cols = torch.nonzero(m, as_tuple=True)
            pids, lens = _decode_slot_ranges(self._sp, s[rows, cols])
            owner = torch.repeat_interleave(rows, lens,
                                            output_size=pids.numel())
            hits = torch.zeros(qc * u, dtype=torch.int32, device=self.device)
            hits.index_add_(0, owner * u + pids,
                            torch.ones(pids.numel(), dtype=torch.int32,
                                       device=self.device))
            live = torch.bincount(owner, minlength=qc) > 0
            hits = hits.view(qc, u)
            sel = torch.nonzero((hits >= min_overlap) & live[:, None])
            items, lens = _decode_slot_ranges(self._pi, sel[:, 1])
            qrow = torch.repeat_interleave(sel[:, 0], lens,
                                           output_size=items.numel())
            overlaps = torch.repeat_interleave(hits[sel[:, 0], sel[:, 1]],
                                               lens, output_size=items.numel())
            order = torch.argsort(qrow * max(n, 1) + items)
            out.append((qrow[order] + c0, items[order],
                        overlaps[order].to(torch.int64)))
        return tuple(torch.cat(parts) for parts in zip(*out))

    # --------------------------------------------------------------- state

    def decompress(self) -> InvertedIndex:
        """Bit-exact reconstruction of the flat CSR realisation."""
        dev = self.device
        sp_post, sp_off = (torch.from_numpy(a).to(dev)
                           for a in decode_postings(self.slot_patterns))
        pi_post, pi_off = (torch.from_numpy(a).to(dev)
                           for a in decode_postings(self.pattern_items))
        # expand every (slot, pattern) pair into the pattern's item list
        slot_of_pair = torch.repeat_interleave(
            torch.arange(self.p, device=dev), torch.diff(sp_off),
            output_size=sp_post.numel())
        idx, owner = expand_ranges(pi_off[sp_post],
                                   torch.diff(pi_off)[sp_post])
        post_items, post_slots = pi_post[idx], slot_of_pair[owner]
        order = torch.argsort(post_slots * max(self.n_items, 1) + post_items)
        return InvertedIndex.from_csr(
            post_items[order],
            _offsets(torch.bincount(post_slots, minlength=self.p)),
            n_items=self.n_items, p=self.p, k=self.k, device=dev)


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
              device: str | torch.device | None = None) -> "DeviceIndex":
        """The index on ``device`` (``None``: the card; ``"cpu"`` for the
        plain path)."""
        device = resolve_device(device)
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
