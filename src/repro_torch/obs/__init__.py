"""Observability layer of the port: streaming histograms, request tracing and
the event journal.

Copies of ``repro.obs.{histogram,tracing,events}`` (numpy and the standard
library only), kept in the port so it imports nothing of ``repro``; the
metric exporters come with a later slice.
"""
from repro_torch.obs.events import EventJournal
from repro_torch.obs.histogram import LogHistogram
from repro_torch.obs.tracing import NOOP_SPAN, NOOP_TRACER, Span, Tracer

__all__ = ["EventJournal", "LogHistogram", "NOOP_SPAN", "NOOP_TRACER", "Span",
           "Tracer"]
