"""Fixed log-spaced-bucket streaming histogram with an associative merge.

Replaces the service tier's windowed per-sample lists: O(bins) memory no
matter how long the service runs, O(1) record, and ``merge`` adds bucket
counts — exactly associative and commutative on the counts — so per-batch,
per-shard and per-host histograms fold into one (the multi-host snapshot
path ships ``to_dict`` payloads and merges them host-side; no sample list
ever crosses a process boundary).

Quantiles come from the bucket cumulative counts: ``quantile(q)`` locates
the bucket holding the order statistic of rank ``floor(q * (n - 1))`` (the
same rank ``np.percentile(..., method="lower")`` returns) and reports the
bucket's geometric midpoint, so the relative error against that exact order
statistic is bounded by ``sqrt(hi / lo) ** (1 / bins) - 1`` for in-range
values — about 2% at the default latency layout.  Means are EXACT: the
running sum/count ride alongside the buckets.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["LogHistogram"]


class LogHistogram:
    """Log-spaced buckets over ``[lo, hi]`` plus underflow/overflow slots.

    ``counts[0]`` holds values ``< lo`` (including zeros and negatives —
    log-spacing cannot represent them, but latencies/fractions of zero must
    still count), ``counts[1 : bins + 1]`` the log buckets, and
    ``counts[bins + 1]`` values ``> hi``.  Observed min/max are tracked so
    the edge buckets report honest representatives.
    """

    __slots__ = ("lo", "hi", "bins", "edges", "counts", "sum", "vmin", "vmax")

    def __init__(self, lo: float, hi: float, bins: int):
        if not (0.0 < lo < hi) or bins < 1:
            raise ValueError(f"need 0 < lo < hi and bins >= 1, got "
                             f"lo={lo} hi={hi} bins={bins}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.bins = int(bins)
        self.edges = np.geomspace(self.lo, self.hi, self.bins + 1)
        self.counts = np.zeros(self.bins + 2, np.int64)
        self.sum = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    # ------------------------------------------------------------ presets

    @classmethod
    def latency(cls) -> "LogHistogram":
        """1 microsecond .. 1000 seconds, ~2% quantile error (seconds)."""
        return cls(1e-6, 1e3, 512)

    @classmethod
    def fraction(cls) -> "LogHistogram":
        """Unit-interval statistics (occupancy, discard fraction)."""
        return cls(1e-4, 1.0, 128)

    # ---------------------------------------------------------- recording

    @property
    def n(self) -> int:
        return int(self.counts.sum())

    @property
    def mean(self) -> float | None:
        n = self.n
        return self.sum / n if n else None

    @property
    def bucket_ratio(self) -> float:
        """Width ratio of adjacent buckets; the quantile error bound is
        ``sqrt(bucket_ratio) - 1``."""
        return (self.hi / self.lo) ** (1.0 / self.bins)

    def record(self, value: float) -> None:
        self.record_many((value,))

    def record_many(self, values) -> None:
        v = np.asarray(values, np.float64).ravel()
        if v.size == 0:
            return
        self.sum += float(v.sum())
        self.vmin = min(self.vmin, float(v.min()))
        self.vmax = max(self.vmax, float(v.max()))
        # side="left": v < lo -> 0 (underflow), v in (edges[i-1], edges[i]]
        # -> bucket i, v > hi -> bins + 1 (overflow).  searchsorted puts
        # v == lo at index 0, but the documented contract is [lo, hi]
        # in-range — lift exact-lo values into the first bucket.
        idx = np.searchsorted(self.edges, v, side="left")
        idx = np.where((idx == 0) & (v >= self.lo), 1, idx)
        idx = np.where(v > self.hi, self.bins + 1, idx)
        self.counts += np.bincount(idx, minlength=self.counts.size)

    # ------------------------------------------------------------- merging

    def compatible(self, other: "LogHistogram") -> bool:
        return (self.lo == other.lo and self.hi == other.hi
                and self.bins == other.bins)

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Fold ``other`` into self (in place; returns self).

        Bucket counts add — exactly associative and commutative — so any
        merge tree over per-batch/shard/host histograms lands on the same
        counts; the running sum is float addition (associative to rounding).
        """
        if not self.compatible(other):
            raise ValueError(
                f"histogram layouts differ: ({self.lo}, {self.hi}, "
                f"{self.bins}) vs ({other.lo}, {other.hi}, {other.bins})")
        self.counts += other.counts
        self.sum += other.sum
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        return self

    # ------------------------------------------------------------ quantiles

    def _representative(self, bucket: int) -> float:
        if bucket == 0:                       # underflow: all values < lo
            return self.vmin if math.isfinite(self.vmin) else self.lo
        if bucket == self.bins + 1:           # overflow: all values > hi
            return self.vmax if math.isfinite(self.vmax) else self.hi
        rep = math.sqrt(self.edges[bucket - 1] * self.edges[bucket])
        # never report outside the observed range (tightens edge buckets)
        return min(max(rep, self.vmin), self.vmax)

    def quantile(self, q: float) -> float | None:
        """Approximate order statistic of rank ``floor(q * (n - 1))`` —
        the rank convention of ``np.percentile(..., method="lower")`` —
        with relative error <= ``sqrt(bucket_ratio) - 1`` for values inside
        ``[lo, hi]``.  None while empty."""
        n = self.n
        if n == 0:
            return None
        rank = int(math.floor(min(max(q, 0.0), 1.0) * (n - 1))) + 1
        bucket = int(np.searchsorted(np.cumsum(self.counts), rank))
        return self._representative(bucket)

    def percentile(self, p: float) -> float | None:
        return self.quantile(p / 100.0)

    # -------------------------------------------------------- serialization

    def to_dict(self) -> dict:
        """JSON-safe payload (the JSONL exporter and the cross-host metric
        merge both ship this)."""
        return {"lo": self.lo, "hi": self.hi, "bins": self.bins,
                "counts": self.counts.tolist(), "sum": self.sum,
                "min": (self.vmin if math.isfinite(self.vmin) else None),
                "max": (self.vmax if math.isfinite(self.vmax) else None)}

    @classmethod
    def from_dict(cls, d: dict) -> "LogHistogram":
        h = cls(d["lo"], d["hi"], d["bins"])
        h.counts = np.asarray(d["counts"], np.int64).copy()
        h.sum = float(d["sum"])
        h.vmin = math.inf if d.get("min") is None else float(d["min"])
        h.vmax = -math.inf if d.get("max") is None else float(d["max"])
        return h

    def __repr__(self) -> str:
        return (f"LogHistogram(lo={self.lo}, hi={self.hi}, bins={self.bins}, "
                f"n={self.n}, mean={self.mean})")
