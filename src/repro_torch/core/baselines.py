"""Baselines the paper compares against (§5.1, §6), in PyTorch.

Counterpart of ``repro.core.baselines``:

* ``SrpLsh``: sign-random-projection hashing, L boosted tables (candidates
  are the union over the L hash instances, the paper's footnote 7).
* ``SuperBitLsh``: SRP with orthogonalised projections.
* ``CroHash``: concomitant rank-order hashing, the code is the set of the
  top-l of m random projections.
* ``PcaTree``: median splits along principal eigenvectors; a query's
  candidates are its leaf.

Planes and projections are drawn with numpy exactly as the reference draws
them (the same seed gives the same bits), then moved to the device.  A hash
table is its items sorted by packed int64 code (an SRP code is its sign
bits, a CRO code its sorted top-l indices in base m) and a query's bucket
is a ``searchsorted`` range.  The PCA tree is built level by level, with
one batched power iteration for every node of a level, and is held as
arrays of nodes (split direction, median, children, leaf range).
Projections use the kernels' f32 arithmetic (``fma_dot``), so an item and a
query with the same factors always hash alike.  Candidates are scored
exactly and ordered (score desc, row asc); the reference leaves ties in no
fixed order.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.inverted_index import expand_ranges
from repro_torch.core.retrieval import candidate_topk
from repro_torch.device import resolve_device
from repro_torch.kernels.gam_score import fma_dot
from repro_torch.retriever.types import RetrievalResult

__all__ = ["CroHash", "PcaTree", "SrpLsh", "SuperBitLsh"]

# (query, item) pairs gathered a step before duplicates are dropped
_PAIR_CHUNK = 1 << 25
# rows projected a step (bounds the f64 temporaries of fma_dot)
_PROJECT_CHUNK = 1 << 18


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, k) x (k, m) -> (B, m) f32 with the kernels' arithmetic."""
    out = torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    wt = w.T[None]
    for lo in range(0, x.shape[0], _PROJECT_CHUNK):
        out[lo:lo + _PROJECT_CHUNK] = fma_dot(
            x[lo:lo + _PROJECT_CHUNK, None, :], wt)
    return out


def _union_of_ranges(starts: torch.Tensor, lens: torch.Tensor,
                     pool: torch.Tensor, n: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each query's union of ``pool[starts[q, r] : starts[q, r] +
    lens[q, r]]`` over its ranges r -> flat (query, row) int64 pairs ordered
    by (query, row), a chunk of queries at a time."""
    per_query = lens.sum(dim=1).tolist()
    out, c0 = [], 0
    while c0 < len(per_query):
        c1, size = c0, 0
        while c1 < len(per_query) and (c1 == c0
                                       or size + per_query[c1] <= _PAIR_CHUNK):
            size += per_query[c1]
            c1 += 1
        pos, owner = expand_ranges(starts[c0:c1], lens[c0:c1])
        key = torch.unique((owner // lens.shape[1] + c0) * n + pool[pos])
        out.append((key // n, key % n))
        c0 = c1
    if not out:
        e = torch.empty(0, dtype=torch.int64, device=pool.device)
        return e, e
    return tuple(torch.cat(parts) for parts in zip(*out))


class _Baseline:
    """Candidates -> exact scores -> top-kappa, shared by every baseline."""

    items: torch.Tensor
    device: torch.device

    def candidates(self, users) -> tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def _users(self, users) -> torch.Tensor:
        return torch.as_tensor(users, device=self.device).to(torch.float32)

    def query(self, users, kappa: int) -> RetrievalResult:
        """Top-kappa in row space: ids -1 and scores -inf in empty slots."""
        u = self._users(users)
        qrow, rows = self.candidates(u)
        vals, top, counts = candidate_topk(u, self.items, qrow, rows, kappa)
        n_scored = counts.cpu().numpy()
        return RetrievalResult(top.cpu().numpy(), vals.cpu().numpy(),
                               n_scored, 1.0 - n_scored / self.items.shape[0])


class _HashRetriever(_Baseline):
    """L hash tables, each the items sorted by code; candidates = the union
    of the query's exact-bucket hits."""

    def __init__(self, items, n_tables: int, *,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.items = torch.as_tensor(items, device=self.device).to(
            torch.float32)
        self.n_tables = n_tables
        self._set_tables(self._codes(self.items))

    def _codes(self, x: torch.Tensor) -> torch.Tensor:
        """(B, k) -> (n_tables, B) int64 codes."""
        raise NotImplementedError

    def _set_tables(self, codes: torch.Tensor) -> None:
        """Item codes (n_tables, N) -> each table's codes ascending and its
        items in that order (ascending within a bucket)."""
        order = torch.argsort(codes, dim=1, stable=True)
        self.table_codes = torch.gather(codes, 1, order).contiguous()
        self.table_items = order

    def candidates(self, users) -> tuple[torch.Tensor, torch.Tensor]:
        """Flat (query, row) int64 pairs, ordered by (query, row)."""
        codes = self._codes(self._users(users)).contiguous()
        lo = torch.searchsorted(self.table_codes, codes)
        hi = torch.searchsorted(self.table_codes, codes, right=True)
        n = self.items.shape[0]
        base = torch.arange(self.n_tables, device=self.device)[:, None] * n
        return _union_of_ranges((lo + base).T, (hi - lo).T,
                                self.table_items.reshape(-1), n)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., b) bool -> (...) int64, bit j of the code = bits[..., j]."""
    shifts = torch.arange(bits.shape[-1], device=bits.device)
    return (bits.to(torch.int64) << shifts).sum(dim=-1)


class SrpLsh(_HashRetriever):
    """Sign random projection: b random hyperplanes a table -> a b-bit
    code."""

    def __init__(self, items, n_bits: int = 8, n_tables: int = 4,
                 seed: int = 0, *, device: str | torch.device | None = None):
        self.n_bits = n_bits
        k = items.shape[1]
        planes = np.random.default_rng(seed).normal(
            size=(n_tables, k, n_bits)).astype(np.float32)
        self._set_planes(planes, device)
        super().__init__(items, n_tables, device=device)

    def _set_planes(self, planes: np.ndarray, device) -> None:
        if planes.shape[-1] > 63:
            raise ValueError(f"an SRP code holds at most 63 bits, got "
                             f"{planes.shape[-1]} planes a table")
        self.planes = torch.as_tensor(planes, device=resolve_device(device))

    def _codes(self, x):
        return torch.stack([_pack_bits(_project(x, w) >= 0)
                            for w in self.planes])


class SuperBitLsh(SrpLsh):
    """SRP with orthogonalised hyperplanes (a QR a table, in f64)."""

    def __init__(self, items, n_bits: int = 8, n_tables: int = 4,
                 seed: int = 0, *, device: str | torch.device | None = None):
        self.n_bits = n_bits
        k = items.shape[1]
        rng = np.random.default_rng(seed + 1)
        planes = []
        for _ in range(n_tables):
            qmat, _ = np.linalg.qr(rng.normal(size=(k, max(n_bits, 1))))
            planes.append(qmat[:, :n_bits])
        self._set_planes(np.stack(planes).astype(np.float32), device)
        _HashRetriever.__init__(self, items, n_tables, device=device)


class CroHash(_HashRetriever):
    """Concomitant rank-order statistics: the code is the sorted indices of
    the top-l of m random Gaussian projections, packed in base m."""

    def __init__(self, items, n_proj: int = 16, top_l: int = 2,
                 n_tables: int = 4, seed: int = 0, *,
                 device: str | torch.device | None = None):
        self.n_proj, self.top_l = n_proj, top_l
        if n_proj ** top_l >= 1 << 63:
            raise ValueError(f"{top_l} indices in base {n_proj} do not fit "
                             "an int64 code")
        k = items.shape[1]
        proj = np.random.default_rng(seed).normal(
            size=(n_tables, k, n_proj)).astype(np.float32)
        self.proj = torch.as_tensor(proj, device=resolve_device(device))
        super().__init__(items, n_tables, device=device)

    def _codes(self, x):
        weights = self.n_proj ** torch.arange(self.top_l, device=x.device)
        out = []
        for w in self.proj:
            top = torch.topk(_project(x, w), self.top_l, dim=1).indices
            out.append((torch.sort(top, dim=1).values * weights).sum(dim=1))
        return torch.stack(out)


def _segment_sums(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """Sums of consecutive row segments of ``x`` (M, c) of lengths ``lens``
    -> (S, c) f64: a cumsum and its differences, so no atomics and the same
    on every run.  The scan runs along the innermost dimension of the
    transpose (a scan down the rows of an (M, c) tensor is c serial chains
    on the card)."""
    c = torch.cumsum(x.to(torch.float64).T.contiguous(), dim=1)
    c = torch.cat([torch.zeros_like(c[:, :1]), c], dim=1)
    ends = torch.cumsum(lens, 0)
    return (c[:, ends] - c[:, ends - lens]).T


class PcaTree(_Baseline):
    """Recursive median splits along principal eigenvectors; candidates are
    the query's leaf.

    Nodes are numbered level by level; ``child`` (n_nodes, 2) holds a split
    node's children (-1 at a leaf), ``split_v`` / ``split_med`` its
    direction and median, ``leaf_start`` / ``leaf_len`` a leaf's range of
    ``leaf_items``."""

    def __init__(self, items, depth: int = 4, seed: int = 0, *,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.items = torch.as_tensor(items, device=self.device).to(
            torch.float32)
        self.depth = depth
        self._build()

    def _build(self) -> None:
        dev, (n, k) = self.device, self.items.shape
        ids = torch.arange(n, device=dev)      # open nodes' items, by node
        lens = torch.tensor([n], device=dev)   # items of each open node
        first = 0                              # id of the first open node
        child, split_v, split_med, leaf_start, leaf_len = [], [], [], [], []
        leaf_items, n_leaf_items, level = [], 0, 0
        while lens.numel():
            n_open = lens.numel()
            leaf = (lens <= 4) | (level == self.depth)
            owner = torch.repeat_interleave(torch.arange(n_open, device=dev),
                                            lens, output_size=ids.numel())
            in_leaf = leaf[owner]
            leaf_items.append(ids[in_leaf])
            lo = n_leaf_items + torch.cumsum(lens * leaf, 0) - lens * leaf
            leaf_start.append(torch.where(leaf, lo, 0))
            leaf_len.append(torch.where(leaf, lens, 0))
            n_leaf_items += int(leaf_items[-1].numel())
            split = ~leaf
            n_split = int(split.sum())
            # children of the split nodes, numbered after this level's nodes
            kids = first + n_open + 2 * (torch.cumsum(split, 0) - 1)
            child.append(torch.where(split[:, None],
                                     torch.stack([kids, kids + 1], 1), -1))
            v = torch.zeros((n_open, k), dtype=torch.float32, device=dev)
            med = torch.zeros(n_open, dtype=torch.float32, device=dev)
            if n_split:
                ids, lens, v[split], med[split] = self._split(
                    ids[~in_leaf], lens[split])
            else:
                ids, lens = ids[:0], lens[:0]
            split_v.append(v)
            split_med.append(med)
            first += n_open
            level += 1
        self.levels = level
        self.child = torch.cat(child)
        self.split_v = torch.cat(split_v)
        self.split_med = torch.cat(split_med)
        self.leaf_start = torch.cat(leaf_start)
        self.leaf_len = torch.cat(leaf_len)
        self.leaf_items = torch.cat(leaf_items)

    def _split(self, ids: torch.Tensor, lens: torch.Tensor):
        """One level's splits: items ``ids`` grouped by node, ``lens`` a
        node -> (children's items grouped by child, children's lens,
        directions, medians)."""
        dev = ids.device
        s = lens.numel()
        owner = torch.repeat_interleave(torch.arange(s, device=dev), lens,
                                        output_size=ids.numel())
        x = self.items[ids]
        mean = (_segment_sums(x, lens) / lens[:, None]).to(torch.float32)
        xc = x - mean[owner]
        cov = _segment_sums((xc[:, :, None] * xc[:, None, :]).flatten(1),
                            lens).to(torch.float32).view(s, x.shape[1], -1)
        # principal eigenvector: a few power iterations, every node at once
        v = torch.ones((s, x.shape[1]), dtype=torch.float32, device=dev)
        for _ in range(32):
            v = torch.bmm(cov, v[:, :, None])[:, :, 0]
            v = v / (torch.linalg.vector_norm(v, dim=1, keepdim=True) + 1e-30)
        proj = fma_dot(x, v[owner])
        # the median of an even count is the mean of the two middle values
        order = torch.argsort(proj, stable=True)
        order = order[torch.argsort(owner[order], stable=True)]
        srt = proj[order]
        start = torch.cumsum(lens, 0) - lens
        hi = srt[start + lens // 2]
        lo = srt[start + (lens - 1) // 2]
        med = torch.where(lens % 2 == 1, hi, (lo + hi) / 2)
        right = (proj > med[owner]).to(torch.int64)
        side = torch.argsort(2 * owner + right, stable=True)
        kid_lens = torch.bincount(2 * owner + right, minlength=2 * s)
        return ids[side], kid_lens, v, med

    def leaf_of(self, users) -> torch.Tensor:
        """Each query's leaf node id (the descent of the reference's
        ``_leaf``: left where u.v <= median)."""
        u = self._users(users)
        node = torch.zeros(u.shape[0], dtype=torch.int64, device=self.device)
        for _ in range(self.levels):
            kids = self.child[node]
            go = (fma_dot(u, self.split_v[node])
                  > self.split_med[node]).to(torch.int64)
            node = torch.where(kids[:, 0] >= 0,
                               kids.gather(1, go[:, None])[:, 0], node)
        return node

    def candidates(self, users) -> tuple[torch.Tensor, torch.Tensor]:
        node = self.leaf_of(users)
        return _union_of_ranges(self.leaf_start[node][:, None],
                                self.leaf_len[node][:, None],
                                self.leaf_items, self.items.shape[0])
