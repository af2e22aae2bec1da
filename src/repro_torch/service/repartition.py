"""Skew-aware catalog partitioning for the sharded service tier.

The main segment keeps the catalog id-sorted and cut into CONTIGUOUS shards
— contiguity is load-bearing: the fused ``gam_retrieve`` accumulator breaks
score ties by ascending global row, and only an id-ordered flat layout makes
that identical to the API's (score desc, id asc) total order.  A
repartitioner therefore cannot reassign arbitrary items to arbitrary shards;
what it CAN move are the cut points (variable shard lengths) and the
per-shard kernel item-block width ``bn`` (finer blocks where the catalog is
hot or dense buy back block-skip granularity; coarser blocks elsewhere keep
the grid small).

:class:`Partition` is the plan — per-shard (length, bn, cap) with caps a
whole number of blocks — and :class:`Repartitioner` produces one from
per-item load weights and decides, from :class:`ServiceMetrics` skew
statistics, when rebalancing is worth a compaction.  The plan is consumed by
``ShardedGamIndex.build(partition=...)`` (directly or through the background
:class:`~repro_torch.service.compaction.CompactionPlanner`).

:class:`MapCache` is the repartitioner's incremental weight/map cache: the
per-item phi-mapping (tau destinations + non-zero mask) is a pure per-row
function of the factor row, so ``repartition()``'s plan step only needs to
re-map items that changed since the last plan instead of the whole catalog.
"""
from __future__ import annotations

import dataclasses

import numpy as np

import torch

from repro_torch.core.mapping import sparse_map
from repro_torch.device import resolve_device
from repro_torch.kernels.gam_retrieve import ROW_CAPACITY, RowCapacityError

__all__ = ["MapCache", "Partition", "Repartitioner"]


def _round8(x: int) -> int:
    return -(-int(x) // 8) * 8


@dataclasses.dataclass(frozen=True)
class Partition:
    """Per-shard layout of the id-sorted catalog: lengths, block widths, caps.

    ``lengths[s]`` live rows of shard ``s`` (contiguous in id order, summing
    to the catalog size), ``bns[s]`` the fused-kernel item-block width the
    shard is served with, ``caps[s]`` the padded row count (a multiple of
    ``bns[s]``, so kernel blocks never straddle a shard boundary and
    per-block candidate counts fold exactly into per-shard counts).

    Consecutive shards with equal ``bn`` form a *group*: one slab of the flat
    factor matrix, one :class:`~repro_torch.kernels.gam_retrieve.RetrievalMeta`,
    one fused-kernel launch.  The uniform default is a single group — the
    legacy single-launch layout, byte-for-byte.
    """

    lengths: tuple[int, ...]
    bns: tuple[int, ...]
    caps: tuple[int, ...]

    def __post_init__(self):
        if not (len(self.lengths) == len(self.bns) == len(self.caps)):
            raise ValueError("lengths/bns/caps must have one entry per shard")
        if not self.lengths:
            raise ValueError("partition needs at least one shard")
        for s, (ln, bn, cap) in enumerate(
                zip(self.lengths, self.bns, self.caps)):
            if ln < 0:
                raise ValueError(f"shard {s}: negative length {ln}")
            if bn < 8 or bn % 8:
                raise ValueError(f"shard {s}: bn={bn} must be a multiple "
                                 f"of 8 and >= 8")
            if cap < max(ln, bn) or cap % bn:
                raise ValueError(f"shard {s}: cap={cap} must be a multiple "
                                 f"of bn={bn} covering length={ln}")
        # shard offsets are cap prefix sums, so the last flat row is
        # sum(caps) - 1; at 2^30 structural rows global ids would collide
        # with the kernel's _NO_ROW sentinel — fail the plan loudly here,
        # before any slab is allocated or assembled.
        total = sum(self.caps)
        if total > ROW_CAPACITY:
            raise RowCapacityError("partition (sum of shard caps)", total)

    # ------------------------------------------------------------- derived

    @property
    def n(self) -> int:
        """Catalog rows covered (live, unpadded)."""
        return sum(self.lengths)

    @property
    def n_shards(self) -> int:
        return len(self.lengths)

    @property
    def n_rows(self) -> int:
        """Total structural rows of the flat factor matrix (incl. pads)."""
        return sum(self.caps)

    @property
    def starts(self) -> tuple[int, ...]:
        """Catalog rank where each shard begins (exclusive prefix sum)."""
        out, acc = [], 0
        for ln in self.lengths:
            out.append(acc)
            acc += ln
        return tuple(out)

    @property
    def offsets(self) -> tuple[int, ...]:
        """Flat row where each shard's slab begins."""
        out, acc = [], 0
        for cap in self.caps:
            out.append(acc)
            acc += cap
        return tuple(out)

    @property
    def groups(self) -> tuple[tuple[int, int], ...]:
        """Maximal runs ``(s_lo, s_hi)`` of shards sharing one ``bn`` — each
        is one kernel launch over one contiguous slab."""
        runs, lo = [], 0
        for s in range(1, self.n_shards):
            if self.bns[s] != self.bns[lo]:
                runs.append((lo, s))
                lo = s
        runs.append((lo, self.n_shards))
        return tuple(runs)

    def group_rows(self, g: int) -> tuple[int, int]:
        """Flat row range ``[lo, hi)`` of group ``g``'s slab."""
        s_lo, s_hi = self.groups[g]
        lo = self.offsets[s_lo]
        return lo, lo + sum(self.caps[s_lo:s_hi])

    @staticmethod
    def uniform(n: int, n_shards: int) -> "Partition":
        """The legacy equal-cut layout: one shared cap and bn, pads only at
        the catalog tail — a single group, identical to the pre-repartitioner
        ``ShardedGamIndex.build`` arithmetic."""
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        cap0 = -(-n // n_shards) if n else 1
        bn = min(256, _round8(cap0))
        cap = -(-cap0 // bn) * bn
        lengths = tuple(max(0, min(cap, n - s * cap))
                        for s in range(n_shards))
        return Partition(lengths, (bn,) * n_shards, (cap,) * n_shards)

    @staticmethod
    def from_lengths(lengths, bns) -> "Partition":
        """Caps = lengths rounded up to whole blocks (min one block)."""
        caps = tuple(max(-(-ln // bn) * bn, bn)
                     for ln, bn in zip(lengths, bns))
        return Partition(tuple(int(x) for x in lengths),
                         tuple(int(b) for b in bns), caps)


class MapCache:
    """Incremental per-item phi-mapping cache (id -> (tau row, mask row)).

    ``sparse_map`` is row-wise — each catalog row's (tau, mask) depends only
    on that row's factors and the schema — so cached rows are bit-identical
    to a fresh full-catalog mapping.  The service invalidates an id on every
    upsert/delete; :meth:`lookup` then maps ONLY the missing rows (padded to
    a power of two so the jit cache sees a bounded set of shapes) and
    answers the rest from the cache.  This is the ROADMAP's incremental
    weight/map cache: a repartition of an N-item catalog with M changed
    items costs O(M) mapping work, not O(N).
    """

    def __init__(self, cfg, device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._tau: dict[int, np.ndarray] = {}
        self._mask: dict[int, np.ndarray] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._tau)

    def clear(self) -> None:
        self._tau.clear()
        self._mask.clear()

    def invalidate(self, ids) -> None:
        """Drop cached rows (changed or deleted items)."""
        for i in np.asarray(ids, np.int64).ravel():
            self._tau.pop(int(i), None)
            self._mask.pop(int(i), None)

    def retain(self, live_ids) -> None:
        """Bound memory: keep only the given (live) catalog ids."""
        live = {int(i) for i in live_ids}
        for i in [i for i in self._tau if i not in live]:
            del self._tau[i], self._mask[i]

    def lookup(self, ids: np.ndarray,
               factors: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(tau, mask) rows for ``ids`` (aligned with ``factors``), mapping
        only the cache misses, on the cache's device.  Bit-identical to
        mapping the whole batch."""
        ids = np.asarray(ids, np.int64).ravel()
        n, k = ids.size, self.cfg.k
        tau = np.zeros((n, k), np.int32)
        mask = np.zeros((n, k), bool)
        miss = [j for j, i in enumerate(ids) if int(i) not in self._tau]
        self.misses += len(miss)
        self.hits += n - len(miss)
        if miss:
            batch = torch.as_tensor(
                np.ascontiguousarray(np.asarray(factors, np.float32)[miss]),
                device=self.device)
            t_dev, v_dev = sparse_map(batch, self.cfg)
            t = t_dev.cpu().numpy().astype(np.int32)
            v = (v_dev != 0.0).cpu().numpy()
            for row, j in enumerate(miss):
                self._tau[int(ids[j])] = t[row]
                self._mask[int(ids[j])] = v[row]
        for j, i in enumerate(ids):
            tau[j] = self._tau[int(i)]
            mask[j] = self._mask[int(i)]
        return tau, mask

    def stats(self) -> dict:
        return {"size": len(self), "hits": self.hits, "misses": self.misses}


class Repartitioner:
    """Measures shard/block load skew and plans rebalanced partitions.

    Load comes from :class:`ServiceMetrics` (per-shard and per-block
    candidate totals accumulated on the query path) or, before any traffic,
    from static structure (posting load / pattern sizes).  ``skew`` is the
    max/mean ratio; :meth:`should_repartition` compares it against a
    threshold.  :meth:`plan` cuts the id-sorted catalog so every shard
    carries ~equal total weight, then sizes each shard's ``bn`` so it serves
    ~``target_blocks`` kernel blocks — short (hot, finely cut) shards get
    narrow blocks and better skip granularity.
    """

    def __init__(self, *, target_blocks: int = 8, min_bn: int = 8,
                 max_bn: int = 256):
        if target_blocks < 1:
            raise ValueError("target_blocks must be >= 1")
        self.target_blocks = target_blocks
        self.min_bn = min_bn
        self.max_bn = max_bn

    # ------------------------------------------------------------- skew

    @staticmethod
    def skew(loads) -> float:
        """max/mean of a per-shard (or per-block) load vector; 1.0 = balanced
        (and the degenerate no-load case)."""
        loads = np.asarray(loads, np.float64).ravel()
        if loads.size == 0 or loads.sum() <= 0:
            return 1.0
        return float(loads.max() / loads.mean())

    def should_repartition(self, loads, threshold: float = 1.5) -> bool:
        return self.skew(loads) > threshold

    # ------------------------------------------------------------- planning

    def pick_bn(self, length: int) -> int:
        """Block width giving ~``target_blocks`` blocks over ``length`` rows,
        clamped to [min_bn, max_bn] multiples of 8."""
        if length <= 0:
            return self.min_bn
        bn = _round8(-(-length // self.target_blocks))
        return max(self.min_bn, min(self.max_bn, bn))

    def plan(self, weights, n_shards: int) -> Partition:
        """Per-item load weights (id-sorted order) -> balanced partition.

        Contiguous cuts at the weight-quantile boundaries (each shard gets
        ~total/S weight), then a per-shard ``bn`` from :meth:`pick_bn`.
        Deterministic: equal inputs yield equal plans.
        """
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        w = np.asarray(weights, np.float64).ravel()
        n = w.size
        if n == 0:
            return Partition.uniform(0, n_shards)
        w = np.maximum(w, 1e-12)           # zero-weight rows still need a home
        cum = np.cumsum(w)
        targets = cum[-1] * np.arange(1, n_shards) / n_shards
        cuts = np.searchsorted(cum, targets, side="left")
        bounds = np.concatenate([[0], cuts, [n]])
        lengths = np.diff(np.clip(bounds, 0, n)).astype(int)
        bns = tuple(self.pick_bn(int(ln)) for ln in lengths)
        return Partition.from_lengths(tuple(int(x) for x in lengths), bns)
