"""Observability layer of the port: streaming histograms, request tracing,
the event journal and the metric exporters.

Copies of ``repro.obs.{histogram,tracing,events,exporters}`` (numpy and the
standard library only), kept in the port so it imports nothing of
``repro``.
"""
from repro_torch.obs.events import EventJournal
from repro_torch.obs.exporters import (JsonlMetricsWriter,
                                       histogram_to_prometheus,
                                       snapshot_to_prometheus)
from repro_torch.obs.histogram import LogHistogram
from repro_torch.obs.tracing import NOOP_SPAN, NOOP_TRACER, Span, Tracer

__all__ = ["EventJournal", "JsonlMetricsWriter", "LogHistogram", "NOOP_SPAN",
           "NOOP_TRACER", "Span", "Tracer", "histogram_to_prometheus",
           "snapshot_to_prometheus"]
