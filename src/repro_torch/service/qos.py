"""Quality-of-service policy: admission control, deadlines, degradation.

The paper's core trade — a controlled amount of accuracy for run time — is
what a deadline needs at serving time: when the remaining budget cannot pay
for the full answer, a *reduced-work* answer is always available (approximate
candidate generation instead of exact scoring, a tighter prune threshold, or
the compacted base segment alone).  This module is the policy half of that
trade; the mechanisms live in the `Microbatcher` (admission + queue-wait
sheds), `ShardedRetriever.query` (the degrade ladder) and the multi-host
router (breaker + hedging).

Three invariants the whole layer is built around:

* **Never silently wrong.**  Every response is exact, *flagged* degraded
  (``RetrievalResult.degraded`` + which rung fired), or a *typed* shed
  (:class:`RequestShed` / :class:`ResultEvicted`) — the overload bench and
  the chaos CI job assert exactly this.
* **Deterministic ladder.**  The rung is a pure function of the remaining
  budget and a cost estimate; no randomness, so SPMD hosts agree.
* **Exact failover/hedging.**  Replicas are bit-identical copies, so which
  replica answers (breaker reroute or hedge winner) never changes a result.
"""
from __future__ import annotations

import dataclasses
import time

__all__ = ["DEGRADE_RUNGS", "HealthTracker", "QosPolicy", "RequestShed",
           "ResultEvicted"]

#: rung 0 = full answer; 1..3 = progressively cheaper reduced-work answers.
#: Below rung 0 sits an implicit ZERO-COST rung: a hot-query result-cache
#: hit (``RetrieverSpec.cache_capacity`` > 0) returns the full
#: current-generation answer before the ladder is even consulted — no
#: queue slot, no device pass, never degraded — and the microbatcher's
#: pre-queue probe exempts such requests from admission control (shedding
#: a request that costs nothing to serve would waste the answer).
DEGRADE_RUNGS = ("none", "skip_exact", "raise_overlap", "base_only")


@dataclasses.dataclass(frozen=True)
class QosPolicy:
    """Per-deployment QoS knobs (frozen + hashable, so it can ride in
    ``RetrieverSpec.options``).  The default policy is a strict no-op:
    unbounded queues, no deadlines, hedging off — existing deployments are
    unchanged until a knob is set.

    Priority classes are small ints, 0 = most important.  Per-class tuples
    index by ``min(priority, len - 1)``, so one entry means "every class".
    """

    # ------------------------------------------------- admission control
    queue_caps: tuple[int, ...] | None = None     # per-class queued-request cap
    deadlines_s: tuple[float, ...] | None = None  # per-class default deadline
    max_queue_wait_s: float | None = None         # shed budget at flush time

    # -------------------------------------------------- degrade ladder
    # remaining_budget / estimated_full_cost thresholds for rungs 1..3:
    # ratio >= [0] -> full answer, >= [1] -> skip exact re-rank,
    # >= [2] -> raise the prune threshold one notch, else base segment only
    degrade_ratios: tuple[float, float, float] = (1.0, 0.5, 0.25)

    # ------------------------------------------------------- hedging
    hedge_factor: float | None = None   # hedge delay = factor * host p99
    hedge_min_samples: int = 16         # per-host latencies before hedging

    # ------------------------------------------------- circuit breaker
    breaker_failures: int = 3           # consecutive failures that open it
    breaker_probe_s: float = 1.0        # first probe backoff after opening
    breaker_probe_max_s: float = 30.0   # backoff cap (doubles per failure)

    @staticmethod
    def _pick(per_class, priority: int):
        if not per_class:
            return None
        return per_class[min(int(priority), len(per_class) - 1)]

    def queue_cap(self, priority: int) -> int | None:
        return self._pick(self.queue_caps, priority)

    def deadline_for(self, priority: int) -> float | None:
        return self._pick(self.deadlines_s, priority)

    def choose_rung(self, remaining_s: float | None,
                    est_cost_s: float | None) -> int:
        """Deterministic degrade-ladder selection: index into
        :data:`DEGRADE_RUNGS` from the remaining-budget / estimated-cost
        ratio.  With no cost estimate yet only the hard floor applies
        (budget already spent -> cheapest rung)."""
        if remaining_s is None:
            return 0
        if remaining_s <= 0.0:
            return 3
        if est_cost_s is None or est_cost_s <= 0.0:
            return 0
        ratio = remaining_s / est_cost_s
        full, mid, low = self.degrade_ratios
        if ratio >= full:
            return 0
        if ratio >= mid:
            return 1
        if ratio >= low:
            return 2
        return 3

    @classmethod
    def from_spec(cls, spec) -> "QosPolicy":
        """Build a policy from ``RetrieverSpec.options`` entries named after
        the policy fields (absent fields keep their no-op defaults)."""
        kw = {}
        for f in dataclasses.fields(cls):
            v = spec.opt(f.name)
            if v is not None:
                kw[f.name] = tuple(v) if isinstance(v, list) else v
        return cls(**kw)


class RequestShed(RuntimeError):
    """A request the service refused (admission) or abandoned (budget) —
    the typed alternative to a silently missing or late answer.

    Raised from ``Microbatcher.submit`` when a class queue cap rejects the
    request; *returned* from ``Microbatcher.result`` when the request was
    shed at flush time (its queue-wait budget or deadline expired before
    service) or when the serve loop sheds on :class:`NoLiveReplica`.
    """

    def __init__(self, reason: str, priority: int = 0, *,
                 req_id: int | None = None, waited_s: float | None = None):
        self.reason = reason              # "queue_full" | "deadline" | ...
        self.priority = int(priority)
        self.req_id = req_id
        self.waited_s = waited_s
        detail = "" if waited_s is None else f" after {waited_s * 1e3:.2f}ms"
        super().__init__(f"request shed ({reason}, class {priority}{detail})")


@dataclasses.dataclass(frozen=True)
class ResultEvicted:
    """Typed marker ``Microbatcher.result`` returns for a request whose
    finished result was evicted by the ``max_results`` bound before the
    client collected it — distinguishable from ``None`` (= unknown id or
    already collected), so the overflow is data loss the caller can see."""

    req_id: int


class HealthTracker:
    """Per-host circuit breaker: consecutive observed failures open the
    breaker (automatic ``mark_down`` via ``on_open``); once open, probes are
    nominated on an exponential backoff schedule, and a successful probe
    closes it again (``on_close`` -> ``mark_up``).

    The tracker never performs I/O itself: the router reports outcomes
    (:meth:`record_failure` / :meth:`record_success`), asks which hosts are
    due a probe (:meth:`due_probes`) and reports the probe outcome
    (:meth:`probe_result`).  Everything is deterministic given the clock
    and the outcome stream, so SPMD hosts that observe the same (seeded)
    fault fates open and close breakers in lockstep.  Manual ``mark_down``
    stays manual: the breaker only reopens hosts *it* closed.
    """

    def __init__(self, n_hosts: int, *, failures: int = 3,
                 probe_s: float = 1.0, probe_max_s: float = 30.0,
                 clock=time.monotonic, on_open=None, on_close=None,
                 metrics=None, events=None):
        self.n_hosts = int(n_hosts)
        self.failures = max(1, int(failures))
        self.probe_s = float(probe_s)
        self.probe_max_s = float(probe_max_s)
        self.clock = clock
        self.on_open = on_open
        self.on_close = on_close
        self.metrics = metrics
        self.events = events
        self._streak = [0] * self.n_hosts
        # host -> {"next_probe": t, "fails": consecutive failed probes}
        self._open: dict[int, dict] = {}

    def is_open(self, host: int) -> bool:
        return host in self._open

    @property
    def open_hosts(self) -> tuple[int, ...]:
        return tuple(sorted(self._open))

    def record_success(self, host: int) -> None:
        self._streak[host] = 0

    def record_failure(self, host: int) -> None:
        if host in self._open:
            return                        # already open; probes take over
        self._streak[host] += 1
        if self._streak[host] >= self.failures:
            self._open_breaker(host)

    def _open_breaker(self, host: int) -> None:
        self._open[host] = {"next_probe": self.clock() + self.probe_s,
                            "fails": 0}
        if self.metrics is not None:
            self.metrics.record_breaker("open")
        if self.events is not None:
            self.events.emit("breaker_open", breaker_host=host,
                             streak=self._streak[host])
        if self.on_open is not None:
            self.on_open(host)

    def due_probes(self) -> list[int]:
        """Open hosts whose backoff elapsed — the router should attempt one
        probe call per listed host this round and report via
        :meth:`probe_result`."""
        now = self.clock()
        return [h for h in sorted(self._open)
                if now >= self._open[h]["next_probe"]]

    def probe_result(self, host: int, ok: bool) -> None:
        st = self._open.get(host)
        if st is None:
            return
        if self.metrics is not None:
            self.metrics.record_breaker("probe")
        if ok:
            del self._open[host]
            self._streak[host] = 0
            if self.metrics is not None:
                self.metrics.record_breaker("close")
            if self.events is not None:
                self.events.emit("breaker_close", breaker_host=host)
            if self.on_close is not None:
                self.on_close(host)
        else:
            st["fails"] += 1
            backoff = min(self.probe_s * (2.0 ** st["fails"]),
                          self.probe_max_s)
            st["next_probe"] = self.clock() + backoff
            if self.events is not None:
                self.events.emit("breaker_probe_failed", breaker_host=host,
                                 backoff_s=round(backoff, 4))
