"""Seeded, deterministic fault injection for the serving tier.

The chaos path must be reproducible to be testable: every fault the
injector deals — a host stalling, a dropped response, a slow replica, a
delta-apply error — comes from one seeded generator, so a failing run
replays bit-for-bit from its seed, and SPMD processes that share the seed
*agree on the fates* (the property that keeps distributed routing
collective-consistent while hosts "fail").

Faults are dealt per query round: :meth:`FaultInjector.host_fates` draws
one fate per host in host order — exactly ``n_hosts`` draws whatever the
routing — and the multi-host router consults the fates to reroute, feed the
circuit breaker and simulate slow replicas.  ``stall`` and ``drop`` both
make the host unusable for the round (they differ only in the counter they
feed); ``slow`` adds simulated latency that the hedging policy sees.

Wired in via ``open_retriever(spec, items=..., faults=FaultInjector(...))``
or ``launch/serve.py --inject-faults SPEC`` with a spec string like::

    stall=0.1,drop=0.05,slow=0.3:0.02,delta_error=0.01,hosts=1+2

(``slow=p:seconds``; ``hosts=`` restricts host faults to the listed hosts,
``+``-separated; ``delta_error`` applies to upsert/delete regardless.)
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["FaultInjected", "FaultInjector", "FaultSpec"]


class FaultInjected(RuntimeError):
    """An injected fault surfacing as an error (currently: delta-apply).
    Typed so harnesses and serve loops can catch exactly the injected
    failures without masking real bugs."""

    def __init__(self, kind: str):
        self.kind = kind
        super().__init__(f"injected fault: {kind}")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Per-round fault probabilities (all default 0 = no faults)."""

    stall: float = 0.0          # P(host stalls for the round)
    drop: float = 0.0           # P(host's response is dropped)
    slow: float = 0.0           # P(host is a slow replica this round)
    slow_s: float = 0.02        # simulated extra latency when slow
    delta_error: float = 0.0    # P(a delta apply raises FaultInjected)
    hosts: tuple[int, ...] | None = None   # restrict host faults to these

    def __post_init__(self):
        for name in ("stall", "drop", "slow", "delta_error"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be a probability, got {v}")
        if self.stall + self.drop + self.slow > 1.0:
            raise ValueError("stall + drop + slow probabilities exceed 1")

    @staticmethod
    def parse(text: str) -> "FaultSpec":
        """Parse the ``--inject-faults`` spec string (see module docstring).
        Unknown keys are a loud error, not a silently ignored typo."""
        kw: dict = {}
        for part in filter(None, (p.strip() for p in text.split(","))):
            if "=" not in part:
                raise ValueError(f"bad fault spec entry {part!r} "
                                 f"(expected key=value)")
            key, _, val = part.partition("=")
            key = key.strip()
            if key == "hosts":
                kw["hosts"] = tuple(int(h) for h in val.split("+"))
            elif key == "slow":
                p, _, s = val.partition(":")
                kw["slow"] = float(p)
                if s:
                    kw["slow_s"] = float(s)
            elif key in ("stall", "drop", "delta_error", "slow_s"):
                kw[key] = float(val)
            else:
                raise ValueError(f"unknown fault spec key {key!r}")
        return FaultSpec(**kw)


class FaultInjector:
    """Deals deterministic fault fates from a seeded generator.

    One instance per retriever; ``host_fates`` must be called exactly once
    per query round (the router does) so that processes sharing the seed
    stay aligned.  Counters record every dealt fault for the metrics/bench
    assertions (``stats()``).
    """

    def __init__(self, spec: FaultSpec | str, seed: int = 0):
        self.spec = FaultSpec.parse(spec) if isinstance(spec, str) else spec
        self.seed = int(seed)
        self._rng = np.random.default_rng(self.seed)
        self.n_stalls = 0
        self.n_drops = 0
        self.n_slows = 0
        self.n_delta_errors = 0

    def host_fates(self, n_hosts: int) -> list[tuple[str | None, float]]:
        """One ``(kind, extra_latency_s)`` fate per host for this query
        round; kind in ``{None, "stall", "drop", "slow"}``.  Always draws
        ``n_hosts`` uniforms in host order so the stream is independent of
        routing — the SPMD-consistency requirement."""
        sp = self.spec
        fates: list[tuple[str | None, float]] = []
        for h in range(n_hosts):
            u = float(self._rng.random())
            if sp.hosts is not None and h not in sp.hosts:
                fates.append((None, 0.0))
                continue
            if u < sp.stall:
                fates.append(("stall", 0.0))
                self.n_stalls += 1
            elif u < sp.stall + sp.drop:
                fates.append(("drop", 0.0))
                self.n_drops += 1
            elif u < sp.stall + sp.drop + sp.slow:
                fates.append(("slow", sp.slow_s))
                self.n_slows += 1
            else:
                fates.append((None, 0.0))
        return fates

    def roll_delta_error(self) -> bool:
        """One draw per delta apply (upsert/delete); True -> the caller must
        raise :class:`FaultInjected` *before* mutating any state."""
        if self.spec.delta_error <= 0.0:
            return False
        hit = float(self._rng.random()) < self.spec.delta_error
        if hit:
            self.n_delta_errors += 1
        return hit

    def stats(self) -> dict:
        return {"seed": self.seed,
                "n_stalls": self.n_stalls, "n_drops": self.n_drops,
                "n_slows": self.n_slows,
                "n_delta_errors": self.n_delta_errors}
