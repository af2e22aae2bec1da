"""Production-traffic load harness: Zipf popularity + diurnal arrivals (a
copy of ``repro.service.loadgen``; numpy only, so both packages draw the
same traffic from one profile).

Every earlier benchmark drew a FRESH random user vector per request — a
uniform, memoryless stream that no cache can serve and no admission
controller is stressed by.  Real retrieval traffic is neither: query
popularity is Zipf-skewed (a small hot set dominates), item churn
concentrates on popular items, and arrival rates swing diurnally with
bursts.  This module generates that traffic deterministically:

* :class:`LoadProfile` — one frozen, string-parseable description of the
  workload (``"zipf=1.1,curve=diurnal,qps=500,peak=4,period=30"`` is what
  ``launch/serve.py --load-profile`` accepts).
* :class:`LoadGenerator` — seeded sampler over a fixed pool of *reusable
  query identities* (the same user vector really does come back — that is
  what makes hot-query caching honest), a Zipf item-popularity upsert
  stream, and an inhomogeneous-Poisson arrival process whose rate curve is
  ``constant`` / ``diurnal`` (sinusoid) / ``bursty`` (square-wave spikes),
  sampled exactly by Lewis–Shedler thinning.

Everything is a pure function of ``(profile, seed)``: two generators with
the same profile emit identical queries, upserts and arrival times, which
is what lets ``benchmarks/service_bench.py`` replay one stream against a
cache-on and a cache-off service and diff the answers bit-for-bit.  See
``docs/load_testing.md`` for the model and parameter guidance.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["LoadGenerator", "LoadProfile", "zipf_weights"]

_CURVES = ("constant", "diurnal", "bursty")


def zipf_weights(n: int, s: float) -> np.ndarray:
    """Normalized Zipf pmf over ranks 1..n: p(r) ∝ r^-s (s=0 ⇒ uniform)."""
    if n < 1:
        raise ValueError("need n >= 1 ranks")
    w = np.arange(1, n + 1, dtype=np.float64) ** -float(s)
    return w / w.sum()


@dataclasses.dataclass(frozen=True)
class LoadProfile:
    """One workload, frozen.  ``zipf_q``/``zipf_items`` are the popularity
    exponents for queries and upserted items (1.1 ≈ web-traffic skew, 0 =
    uniform); ``n_queries`` sizes the reusable query-identity pool.  The
    arrival process has mean rate ``qps`` shaped by ``curve``: ``diurnal``
    swings sinusoidally between trough and ``peak_ratio``×trough over each
    ``period_s``; ``bursty`` idles at a trough with square-wave spikes of
    ``burst_frac`` duty; ``constant`` is homogeneous Poisson."""

    zipf_q: float = 1.1
    zipf_items: float = 1.1
    n_queries: int = 512
    curve: str = "constant"
    qps: float = 1000.0
    peak_ratio: float = 4.0
    period_s: float = 60.0
    burst_frac: float = 0.1
    seed: int = 0

    def __post_init__(self):
        if self.curve not in _CURVES:
            raise ValueError(f"unknown rate curve {self.curve!r}; "
                             f"known: {_CURVES}")
        if self.qps <= 0 or self.peak_ratio < 1.0 or self.period_s <= 0:
            raise ValueError("need qps > 0, peak_ratio >= 1, period_s > 0")
        if not 0.0 < self.burst_frac < 1.0:
            raise ValueError("burst_frac must be in (0, 1)")

    _ALIASES = {"zipf": "zipf_q", "peak": "peak_ratio", "period": "period_s",
                "queries": "n_queries"}

    @classmethod
    def parse(cls, text: str) -> "LoadProfile":
        """Build from a ``k=v,k=v`` CLI string, e.g.
        ``"zipf=1.1,curve=diurnal,qps=500,peak=4,period=30"``.  Unknown
        keys fail loudly with the accepted vocabulary."""
        kw = {}
        fields = {f.name: f.type for f in dataclasses.fields(cls)}
        for part in filter(None, (p.strip() for p in text.split(","))):
            if "=" not in part:
                raise ValueError(f"load profile term {part!r} is not k=v")
            key, val = (t.strip() for t in part.split("=", 1))
            key = cls._ALIASES.get(key, key)
            if key not in fields:
                raise ValueError(
                    f"unknown load-profile key {key!r}; known: "
                    f"{sorted(set(fields) | set(cls._ALIASES))}")
            kw[key] = val if key == "curve" else (
                int(val) if key in ("n_queries", "seed") else float(val))
        return cls(**kw)

    # ------------------------------------------------------------- rates

    def rate(self, t: float) -> float:
        """The instantaneous arrival rate λ(t) in requests/second.  Mean
        over a full period equals ``qps`` for every curve."""
        if self.curve == "constant":
            return self.qps
        peak = self.peak_ratio
        if self.curve == "diurnal":
            # trough lo, peak hi = peak*lo, sinusoid between them:
            # mean = (lo + hi) / 2 = qps
            lo = 2.0 * self.qps / (1.0 + peak)
            phase = 2.0 * np.pi * (t % self.period_s) / self.period_s
            return lo + (peak - 1.0) * lo * 0.5 * (1.0 + np.sin(phase))
        # bursty: square wave, duty d at hi = peak*lo:
        # mean = lo*(1-d) + peak*lo*d = qps
        d = self.burst_frac
        lo = self.qps / (1.0 - d + peak * d)
        in_burst = (t % self.period_s) < d * self.period_s
        return peak * lo if in_burst else lo

    @property
    def peak_rate(self) -> float:
        if self.curve == "constant":
            return self.qps
        if self.curve == "diurnal":
            return self.peak_ratio * 2.0 * self.qps / (1.0 + self.peak_ratio)
        d = self.burst_frac
        return self.peak_ratio * self.qps / (1.0 - d + self.peak_ratio * d)


class LoadGenerator:
    """Deterministic traffic source for one :class:`LoadProfile`.

    ``dim`` is the factor dimensionality k; ``item_ids`` (optional) is the
    catalog the Zipf item-popularity upsert stream mutates — hot items are
    overwritten far more often than the tail, exactly the churn a result
    cache must invalidate against.
    """

    def __init__(self, profile: LoadProfile, dim: int,
                 item_ids=None):
        self.profile = profile
        self.dim = int(dim)
        self.rng = np.random.default_rng(profile.seed)
        # the reusable identities: popularity rank r gets probability ∝ r^-s
        self.queries = self._unit_rows(profile.n_queries)
        self._q_weights = zipf_weights(profile.n_queries, profile.zipf_q)
        self.item_ids = (None if item_ids is None
                         else np.asarray(item_ids, np.int64).ravel())
        self._i_weights = (None if self.item_ids is None else
                           zipf_weights(self.item_ids.size,
                                        profile.zipf_items))

    def _unit_rows(self, n: int) -> np.ndarray:
        rows = self.rng.standard_normal((n, self.dim)).astype(np.float32)
        rows /= np.linalg.norm(rows, axis=1, keepdims=True) + 1e-12
        return rows

    # ----------------------------------------------------------- queries

    def sample_queries(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """``n`` Zipf-popular query identities -> (pool indices (n,),
        vectors (n, dim)).  Hot identities repeat — byte-identical rows,
        so the result cache's exact keying actually fires."""
        idx = self.rng.choice(self.profile.n_queries, size=n,
                              p=self._q_weights)
        return idx.astype(np.int64), self.queries[idx]

    # ----------------------------------------------------------- upserts

    def sample_upserts(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """``n`` item mutations under Zipf item popularity -> (ids,
        fresh factors).  Requires ``item_ids``; duplicates within one call
        are last-write-wins, same as the retriever contract."""
        if self.item_ids is None:
            raise ValueError("LoadGenerator built without item_ids "
                             "cannot emit an upsert stream")
        ids = self.rng.choice(self.item_ids, size=n, p=self._i_weights)
        return ids.astype(np.int64), self._unit_rows(n)

    # ----------------------------------------------------------- arrivals

    def arrivals(self, n: int, t0: float = 0.0) -> np.ndarray:
        """The first ``n`` arrival times (seconds from ``t0``) of the
        inhomogeneous Poisson process with rate ``profile.rate`` — exact
        Lewis–Shedler thinning against the curve's peak rate."""
        lam_max = self.profile.peak_rate
        out = np.empty(n, np.float64)
        t, kept = float(t0), 0
        while kept < n:
            # vectorized candidate block: more than enough on average
            gaps = self.rng.exponential(1.0 / lam_max,
                                        size=max(2 * (n - kept), 16))
            accept = self.rng.random(gaps.size)
            for g, u in zip(gaps, accept):
                t += g
                if u * lam_max <= self.profile.rate(t):
                    out[kept] = t
                    kept += 1
                    if kept == n:
                        break
        return out
