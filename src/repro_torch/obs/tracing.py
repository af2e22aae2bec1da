"""Request tracing: nested spans, probabilistic sampling, JSONL export.

One :class:`Tracer` per process, injected clock (``time.monotonic`` default,
like ``ServiceMetrics``) so span timing is deterministic under test.  The
sampling decision is made ONCE per root ``trace(...)`` from a seeded RNG;
unsampled traces and child ``span(...)`` calls outside any open trace cost
one method call returning the shared :data:`NOOP_SPAN` — the steady-state
overhead story at low sample rates.

Cross-host reassembly (the ``sharded-multihost`` SPMD serving loop): every
host drives the identical request sequence, so tracers constructed with the
same ``seed`` make the SAME sampling decisions in lockstep and assign the
same monotonically increasing ``trace_id`` to the same request.  Each host
annotates its spans with its ``host`` id; concatenating the per-host JSONL
files and grouping on ``trace_id`` reassembles the distributed trace
(see ``docs/deployment.md``).

Profiler ranges: while a ``torch.profiler`` records in the process, every
``trace`` / ``span`` / ``trace_or_span`` (of a :class:`Tracer`, sampled or
not, and of :data:`NOOP_TRACER`) also opens a host range named
``repro_torch.<stage>`` on the profiler's timeline, so a trace can put the
card's idle time down to the program's stages.  The range is a kineto
``cpu_op`` (``_RecordFunctionFast``), never a ``record_function``: that
one is a user annotation, which kineto mirrors onto the CUDA timeline as a
range covering the kernels it launched, and a reader of device time would
count it as busy.  With no profiler recording, a stage costs one check.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import random
import time
from typing import Any

from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

__all__ = ["NOOP_SPAN", "NOOP_TRACER", "RANGE_PREFIX", "Span", "Tracer"]

#: the prefix of every stage's range on the profiler's timeline
RANGE_PREFIX = "repro_torch."


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    trace_id: int
    host: int | None = None
    attrs: dict = dataclasses.field(default_factory=dict)
    children: list = dataclasses.field(default_factory=list)
    t1: float | None = None

    @property
    def duration_s(self) -> float | None:
        return None if self.t1 is None else self.t1 - self.t0

    def set(self, **attrs: Any) -> None:
        self.attrs.update(attrs)

    def to_dict(self) -> dict:
        d: dict = {"name": self.name, "trace_id": self.trace_id,
                   "t0": self.t0, "duration_s": self.duration_s}
        if self.host is not None:
            d["host"] = self.host
        if self.attrs:
            d["attrs"] = self.attrs
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d

    def find(self, name: str) -> list["Span"]:
        """All descendant spans (self included) with this name, in
        depth-first order — how the bench attributes time to stages."""
        out = [self] if self.name == name else []
        for c in self.children:
            out.extend(c.find(name))
        return out


class _NoopSpan:
    """Shared do-nothing span for unsampled traces; accepts ``set`` so
    instrumented code never branches on whether it is being traced."""

    __slots__ = ()

    def set(self, **attrs: Any) -> None:
        pass


NOOP_SPAN = _NoopSpan()
_NO_RANGE = contextlib.nullcontext(NOOP_SPAN)


class _Range:
    """A stage's range on a recording profiler's timeline; enters as
    :data:`NOOP_SPAN`."""

    __slots__ = ("_rf",)

    def __init__(self, name: str):
        self._rf = _RecordFunctionFast(RANGE_PREFIX + name)

    def __enter__(self) -> _NoopSpan:
        self._rf.__enter__()
        return NOOP_SPAN

    def __exit__(self, *exc) -> None:
        self._rf.__exit__(*exc)


def _stage_range(name: str):
    """The range of stage ``name`` while a profiler records, else a shared
    do-nothing context (either enters as :data:`NOOP_SPAN`)."""
    return _Range(name) if _profiler_enabled() else _NO_RANGE


class Tracer:
    def __init__(self, clock=time.monotonic, sample_rate: float = 1.0,
                 host: int | None = None, max_traces: int = 512,
                 seed: int = 0):
        self.clock = clock
        self.sample_rate = float(sample_rate)
        self.host = host
        self.finished: collections.deque[Span] = collections.deque(
            maxlen=max_traces)
        self._rng = random.Random(seed)
        self._stack: list[Span] = []
        self.n_started = 0          # every root, sampled or not (= trace ids)
        self.n_sampled = 0

    @property
    def active(self) -> bool:
        """True inside a sampled root trace."""
        return bool(self._stack)

    # ----------------------------------------------------------- recording

    @contextlib.contextmanager
    def trace(self, name: str, **attrs: Any):
        """Open a ROOT span; the per-trace sampling decision happens here.

        The trace id advances for every root (sampled or not) so ids stay
        aligned across SPMD hosts regardless of the sample rate.
        """
        tid = self.n_started
        self.n_started += 1
        with _stage_range(name):
            if self.sample_rate <= 0.0 or (
                    self.sample_rate < 1.0
                    and self._rng.random() >= self.sample_rate):
                yield NOOP_SPAN
                return
            self.n_sampled += 1
            sp = Span(name, self.clock(), tid, host=self.host,
                      attrs=dict(attrs))
            self._stack.append(sp)
            try:
                yield sp
            finally:
                sp.t1 = self.clock()
                self._stack.pop()
                self.finished.append(sp)

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any):
        """Child span under the innermost open span; a cheap no-op when no
        sampled trace is active (so instrumentation can stay unconditional
        on hot paths)."""
        with _stage_range(name):
            if not self._stack:
                yield NOOP_SPAN
                return
            sp = Span(name, self.clock(), self._stack[-1].trace_id,
                      host=self.host, attrs=dict(attrs))
            self._stack[-1].children.append(sp)
            self._stack.append(sp)
            try:
                yield sp
            finally:
                sp.t1 = self.clock()
                self._stack.pop()

    @contextlib.contextmanager
    def trace_or_span(self, name: str, **attrs: Any):
        """Root when nothing is open (direct ``query()`` callers), child
        when the microbatcher already opened the request trace."""
        cm = self.span(name, **attrs) if self.active \
            else self.trace(name, **attrs)
        with cm as sp:
            yield sp

    def record_span(self, name: str, t0: float, t1: float,
                    **attrs: Any) -> None:
        """Attach an already-elapsed interval (e.g. queue wait measured from
        enqueue timestamps) as a child of the innermost open span."""
        if not self._stack:
            return
        sp = Span(name, t0, self._stack[-1].trace_id, host=self.host,
                  attrs=dict(attrs), t1=t1)
        self._stack[-1].children.append(sp)

    # ------------------------------------------------------------- export

    def export_jsonl(self, path: str, append: bool = False) -> int:
        """One JSON object per finished root trace; returns the count."""
        with open(path, "a" if append else "w") as f:
            for sp in self.finished:
                f.write(json.dumps(sp.to_dict()) + "\n")
        return len(self.finished)

    def stats(self) -> dict:
        return {"n_started": self.n_started, "n_sampled": self.n_sampled,
                "sample_rate": self.sample_rate, "host": self.host,
                "n_retained": len(self.finished)}


class _NoopTracer:
    """Module-level default for instrumented components constructed without
    a tracer: every entry point yields :data:`NOOP_SPAN` at one call's cost
    and never samples (its stages still reach a recording profiler)."""

    __slots__ = ()
    active = False

    def trace(self, name: str, **attrs: Any):
        return _stage_range(name)

    span = trace
    trace_or_span = trace

    def record_span(self, name: str, t0: float, t1: float,
                    **attrs: Any) -> None:
        pass


NOOP_TRACER = _NoopTracer()
