"""Dynamic microbatching front-end with QoS admission control.

Single-user queries arrive one at a time; the device wants fixed-size padded
batches through one query step.  ``Microbatcher`` coalesces: a request
enqueues and the batch fires when either (a) ``batch_size`` requests are
waiting — size trigger — or (b) the oldest request has waited
``max_delay_s`` — deadline trigger, checked by ``poll()`` (which drains
EVERY overdue batch, so a stalled driver catches up in one call).  Short
batches pad with zero factor rows (discarded on the way out), so every
launch sees the same shapes.  The port's copy of
``repro.service.microbatch``.

A :class:`~repro_torch.service.qos.QosPolicy` adds the QoS layer (the default
policy is a no-op):

* **Admission control** — per-priority-class queue caps; an over-cap
  ``submit`` raises the typed :class:`~repro_torch.service.qos.RequestShed`.
* **Priority coalescing** — a flush serves the queued requests in
  (priority, arrival) order, so class 0 never waits behind a burst of
  best-effort traffic.
* **Queue-wait sheds** — at flush time, requests whose queue-wait budget or
  per-request deadline already expired are shed (typed ``RequestShed``
  returned from :meth:`result`) instead of burning a device pass on an
  answer nobody can use.
* **Deadline threading** — the minimum remaining budget of the batch is
  forwarded to ``query_fn(users, n_real, deadline_s=...)`` when the
  callee accepts it, driving the retriever's degrade ladder; a 3rd return
  element carries the degraded flag back onto every ``QueryResult``.

Per-request latency decomposes at the flush point: **queue wait** (enqueue
to flush start) and **service time** (the batch's shared ``query_fn`` call)
are recorded as separate histogram keys in ``ServiceMetrics``, and each
flush runs under a root tracer span (``request_batch`` -> ``queue_wait`` +
``flush``) when a sampling :class:`~repro_torch.obs.tracing.Tracer` is attached.

The design is synchronous and single-threaded on purpose: deterministic to
test (the clock is injectable) and trivial to pump from any event loop; the
concurrency story lives in the driver, not here.
"""
from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Callable

import numpy as np

from repro_torch.obs.tracing import NOOP_TRACER
from repro_torch.service.collective import NoLiveReplica
from repro_torch.service.metrics import ServiceMetrics
from repro_torch.service.qos import QosPolicy, RequestShed, ResultEvicted

__all__ = ["Microbatcher", "QueryResult"]


@dataclasses.dataclass
class QueryResult:
    ids: np.ndarray         # (kappa,) catalog ids, -1 pads
    scores: np.ndarray      # (kappa,) f32, -inf pads
    latency_s: float        # enqueue -> batch done (= queue_wait + service)
    queue_wait_s: float = 0.0   # enqueue -> flush start
    service_s: float = 0.0      # the batch's shared query_fn time
    degraded: bool = False      # a degrade-ladder rung reduced the work
    degrade_rung: str | None = None


@dataclasses.dataclass
class _Pending:
    req_id: int
    user: np.ndarray
    t_submit: float
    priority: int = 0
    deadline_s: float | None = None


def _accepts_deadline(query_fn: Callable) -> bool:
    """True iff ``query_fn`` names a ``deadline_s`` parameter — only then is
    the batch deadline forwarded, so plain ``(users, n_real)`` callables
    (benchmarks, tests) keep working unchanged."""
    try:
        params = inspect.signature(query_fn).parameters
    except (TypeError, ValueError):
        return False
    return "deadline_s" in params


class Microbatcher:
    """Coalesces single-row queries into fixed-size device batches.

    ``query_fn``: (users (B, k) f32, n_real int[, deadline_s float|None]) ->
    (ids (B, kappa), scores (B, kappa)[, info dict]) — called with a FIXED
    leading dim B so every launch sees one shape; rows past
    ``n_real`` are zero padding (the callee must not fold them into its
    statistics).  The optional ``info`` dict carries the degraded flag /
    rung of the shared batch answer.  Results are keyed by the request id
    ``submit`` returned.
    """

    def __init__(self, query_fn: Callable, dim: int, *, batch_size: int = 8,
                 max_delay_s: float = 2e-3, clock=time.monotonic,
                 metrics: ServiceMetrics | None = None,
                 max_results: int = 65536, tracer=None,
                 policy: QosPolicy | None = None, events=None,
                 cache_probe: Callable | None = None):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.query_fn = query_fn
        # optional result-cache probe ``user -> (ids, scores) | None``: a
        # hit answers at submit time without queueing — the QoS ladder's
        # zero-cost rung, exempt from admission control because serving it
        # consumes no queue slot and no device pass
        self.cache_probe = cache_probe
        self.dim = dim
        self.batch_size = batch_size
        self.max_delay_s = max_delay_s
        self.clock = clock
        self.metrics = metrics
        self.tracer = NOOP_TRACER if tracer is None else tracer
        self.policy = QosPolicy() if policy is None else policy
        self.events = events
        self.max_results = max_results     # uncollected results are evicted
        self._queue: list[_Pending] = []
        # req_id -> QueryResult | RequestShed (flush-time shed)
        self._results: dict[int, QueryResult | RequestShed] = {}
        self._evicted: dict[int, None] = {}    # bounded insertion-ordered set
        self._next_id = 0
        self._fn_takes_deadline = _accepts_deadline(query_fn)

    # ---------------------------------------------------------- intake

    def submit(self, user: np.ndarray, *, priority: int = 0,
               deadline_s: float | None = None) -> int:
        """Enqueue one query row; fires the batch on the size trigger.

        ``priority``: QoS class (0 = most important).  ``deadline_s``:
        per-request total budget from now (defaults to the policy's
        per-class deadline).  Raises :class:`RequestShed` when the class's
        queue cap rejects the request (admission control).

        When a ``cache_probe`` is attached and hits, the request completes
        here — no queue slot, no admission check, no device pass; the
        result is immediately collectable and its (near-zero) latency is
        recorded via ``ServiceMetrics.record_cached_request``."""
        if self.cache_probe is not None:
            t0 = self.clock()
            user_row = np.asarray(user, np.float32).reshape(self.dim)
            hit = self.cache_probe(user_row)
            if hit is not None:
                req_id = self._next_id
                self._next_id += 1
                el = self.clock() - t0
                self._results[req_id] = QueryResult(
                    ids=np.asarray(hit[0]), scores=np.asarray(hit[1]),
                    latency_s=el, queue_wait_s=0.0, service_s=el)
                if self.metrics is not None:
                    self.metrics.record_cached_request(el)
                self._evict_overflow()
                return req_id
        cap = self.policy.queue_cap(priority)
        if cap is not None and \
                sum(p.priority == priority for p in self._queue) >= cap:
            shed = RequestShed("queue_full", priority)
            self._record_shed(shed)
            raise shed
        user = np.asarray(user, np.float32).reshape(self.dim)
        req_id = self._next_id
        self._next_id += 1
        if deadline_s is None:
            deadline_s = self.policy.deadline_for(priority)
        self._queue.append(_Pending(req_id, user, self.clock(),
                                    int(priority), deadline_s))
        if len(self._queue) >= self.batch_size:
            self.flush()
        return req_id

    def poll(self) -> bool:
        """Deadline trigger: flush while the oldest queued request has
        waited past ``max_delay_s`` — EVERY overdue batch drains, not just
        the first, so a driver that stalled between polls catches up in one
        call.  Returns True if at least one batch fired."""
        fired = False
        while self._queue:
            oldest = min(p.t_submit for p in self._queue)
            if self.clock() - oldest < self.max_delay_s:
                break
            self.flush()
            fired = True
        return fired

    @property
    def pending(self) -> int:
        return len(self._queue)

    # ---------------------------------------------------------- firing

    def _record_shed(self, shed: RequestShed) -> None:
        if self.metrics is not None:
            self.metrics.record_shed(shed.reason, shed.priority)
        if self.events is not None:
            self.events.emit("request_shed", reason=shed.reason,
                             priority=shed.priority, req_id=shed.req_id)

    def flush(self) -> None:
        """Fire the current queue as one padded fixed-size batch, serving
        the highest-priority (then oldest) requests first and shedding any
        whose queue-wait budget already expired."""
        if not self._queue:
            return
        # priority coalescing: stable sort keeps FIFO order within a class
        self._queue.sort(key=lambda p: p.priority)
        batch, self._queue = self._queue[: self.batch_size], \
            self._queue[self.batch_size:]
        t_fire = self.clock()
        kept = []
        for p in batch:
            wait = t_fire - p.t_submit
            budget = self.policy.max_queue_wait_s
            if (budget is not None and wait > budget) or \
                    (p.deadline_s is not None and wait >= p.deadline_s):
                shed = RequestShed("deadline", p.priority, req_id=p.req_id,
                                   waited_s=wait)
                self._results[p.req_id] = shed
                self._record_shed(shed)
            else:
                kept.append(p)
        batch = kept
        if not batch:
            self._evict_overflow()
            return
        users = np.zeros((self.batch_size, self.dim), np.float32)
        for i, p in enumerate(batch):
            users[i] = p.user
        # the shared batch degrades as a unit: thread the TIGHTEST remaining
        # budget so no request in the batch overruns its own deadline
        deadline_left = None
        budgets = [p.deadline_s - (t_fire - p.t_submit) for p in batch
                   if p.deadline_s is not None]
        if budgets:
            deadline_left = max(min(budgets), 0.0)
        kw = ({"deadline_s": deadline_left} if self._fn_takes_deadline
              else {})
        try:
            with self.tracer.trace("request_batch", n_real=len(batch),
                                   batch_size=self.batch_size) as root:
                t_fire = self.clock()
                # queue wait as a span: oldest enqueue -> flush start
                self.tracer.record_span("queue_wait",
                                        min(p.t_submit for p in batch),
                                        t_fire, n_waiting=len(batch))
                with self.tracer.span("flush"):
                    out = self.query_fn(users, len(batch), **kw)
                ids, scores, info = out if len(out) == 3 else (*out, {})
                t_done = self.clock()
                waits = [t_fire - p.t_submit for p in batch]
                service = t_done - t_fire
                root.set(queue_wait_max_s=max(waits), service_s=service)
        except NoLiveReplica:
            # the round was unservable (every replica of some slice down or
            # faulted): the batch becomes typed sheds, the server keeps
            # serving — later batches may succeed after probe/mark_up
            for p in batch:
                shed = RequestShed("no_live_replica", p.priority,
                                   req_id=p.req_id)
                self._results[p.req_id] = shed
                self._record_shed(shed)
            self._evict_overflow()
            return
        lats = [w + service for w in waits]
        degraded = bool(info.get("degraded", False))
        rung = info.get("degrade_rung")
        for i, p in enumerate(batch):
            self._results[p.req_id] = QueryResult(
                ids=np.asarray(ids[i]), scores=np.asarray(scores[i]),
                latency_s=lats[i], queue_wait_s=waits[i], service_s=service,
                degraded=degraded, degrade_rung=rung)
        self._evict_overflow()
        if self.metrics is not None:
            self.metrics.record_batch(len(batch), self.batch_size, lats,
                                      queue_waits_s=waits, service_s=service)

    def _evict_overflow(self) -> None:
        """Bound memory when clients never collect: evict oldest-first, but
        LOUDLY — counted, journaled, and :meth:`result` returns the typed
        :class:`ResultEvicted` for the lost ids (bounded memory too)."""
        while len(self._results) > self.max_results:
            rid = next(iter(self._results))
            del self._results[rid]
            self._evicted[rid] = None
            if self.metrics is not None:
                self.metrics.record_evicted()
            if self.events is not None:
                self.events.emit("result_evicted", req_id=rid)
        while len(self._evicted) > self.max_results:
            del self._evicted[next(iter(self._evicted))]

    def result(self, req_id: int
               ) -> QueryResult | RequestShed | ResultEvicted | None:
        """Pop the outcome for a request id: a :class:`QueryResult`, a
        :class:`RequestShed` (shed at flush time), a :class:`ResultEvicted`
        marker (finished but evicted uncollected), or None while still
        queued / for unknown ids."""
        out = self._results.pop(req_id, None)
        if out is None and req_id in self._evicted:
            del self._evicted[req_id]
            return ResultEvicted(req_id)
        return out
