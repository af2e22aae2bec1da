"""Metric exporters: Prometheus text exposition and JSON-lines dumps (a copy
of ``repro.obs.exporters``; numpy and the standard library only).

Both render from the same inputs — a ``ServiceMetrics.snapshot()`` dict of
scalars plus the named :class:`~repro_torch.obs.histogram.LogHistogram` map — so
the serve launcher's ``--metrics-out`` chooses a format by file extension
(``.prom`` -> Prometheus text, anything else -> appended JSONL) without two
collection paths.  The text equals the reference's character for
character.

Prometheus histograms are CUMULATIVE bucket counts with ``le`` upper-bound
labels (the exposition-format contract); the log histogram's underflow slot
folds into the first bucket and the overflow slot into ``+Inf``, and
``_sum``/``_count`` come from the exact running sum.
"""
from __future__ import annotations

import json
import re
import time

import numpy as np

from repro_torch.obs.histogram import LogHistogram

__all__ = ["JsonlMetricsWriter", "histogram_to_prometheus",
           "snapshot_to_prometheus"]

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(key: str, prefix: str) -> str:
    return f"{prefix}_{_NAME_RE.sub('_', key)}"


def histogram_to_prometheus(name: str, hist: LogHistogram,
                            help_text: str | None = None) -> str:
    lines = []
    if help_text:
        lines.append(f"# HELP {name} {help_text}")
    lines.append(f"# TYPE {name} histogram")
    cum = np.cumsum(hist.counts)
    # bucket i (1..bins) has upper bound edges[i]; underflow folds into the
    # first finite bucket, overflow into +Inf
    for i in range(1, hist.bins + 1):
        lines.append(f'{name}_bucket{{le="{hist.edges[i]:.6g}"}} '
                     f"{int(cum[i])}")
    lines.append(f'{name}_bucket{{le="+Inf"}} {hist.n}')
    lines.append(f"{name}_sum {hist.sum:.9g}")
    lines.append(f"{name}_count {hist.n}")
    return "\n".join(lines) + "\n"


def snapshot_to_prometheus(snapshot: dict, histograms: dict | None = None,
                           prefix: str = "repro") -> str:
    """Render a metrics snapshot as Prometheus text exposition.

    Numeric scalars become gauges; lists of numbers (e.g. ``host_load``)
    become one gauge per index with an ``index`` label; None values are
    skipped (absent metric, not zero).  ``histograms`` maps metric suffix ->
    :class:`LogHistogram`.
    """
    out = []
    for key, val in snapshot.items():
        name = _metric_name(key, prefix)
        if isinstance(val, bool) or val is None:
            continue
        if isinstance(val, (int, float)):
            out.append(f"# TYPE {name} gauge")
            out.append(f"{name} {float(val):.9g}")
        elif isinstance(val, (list, tuple)) and val and \
                all(isinstance(v, (int, float)) for v in val):
            out.append(f"# TYPE {name} gauge")
            for i, v in enumerate(val):
                out.append(f'{name}{{index="{i}"}} {float(v):.9g}')
    text = "\n".join(out) + ("\n" if out else "")
    for key, hist in (histograms or {}).items():
        text += histogram_to_prometheus(_metric_name(key, prefix), hist)
    return text


class JsonlMetricsWriter:
    """Appends snapshot lines to a JSONL file, rate-limited for periodic
    in-loop dumps (``interval_s=0`` writes every call)."""

    def __init__(self, path: str, clock=time.monotonic,
                 interval_s: float = 0.0):
        self.path = path
        self.clock = clock
        self.interval_s = float(interval_s)
        self._last: float | None = None
        self.n_written = 0
        open(path, "w").close()        # truncate: one run, one file

    def write(self, snapshot: dict, histograms: dict | None = None) -> None:
        line: dict = {"ts": self.clock(), **snapshot}
        if histograms:
            line["histograms"] = {k: h.to_dict()
                                  for k, h in histograms.items()}
        with open(self.path, "a") as f:
            f.write(json.dumps(line) + "\n")
        self._last = self.clock()
        self.n_written += 1

    def maybe_write(self, snapshot_fn, histograms_fn=None) -> bool:
        """Periodic variant: takes CALLABLES so the (possibly costly)
        snapshot is only rendered when the interval has elapsed."""
        now = self.clock()
        if self._last is not None and now - self._last < self.interval_s:
            return False
        self.write(snapshot_fn(),
                   histograms_fn() if histograms_fn is not None else None)
        return True
