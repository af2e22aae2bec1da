"""Structured event journal: a bounded flight recorder of lifecycle events.

The service tier emits one event per lifecycle transition — compaction
phase changes, segment swaps, repartitions, host ``mark_down``/``mark_up``,
failovers — into a fixed-capacity deque (O(capacity) memory, O(1) emit).
``dump_jsonl`` writes the retained window as JSON lines; the launcher dumps
it on error so the last N lifecycle transitions before a crash are always
recoverable.

Named ``events`` on its owners, deliberately NOT ``journal`` — the
compaction planner's mutation *journal* (the replay log of upserts/deletes
racing a background build) is a different thing with a different lifetime.
"""
from __future__ import annotations

import collections
import json
import time

__all__ = ["EventJournal"]


class EventJournal:
    def __init__(self, capacity: int = 1024, clock=time.monotonic,
                 host: int | None = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.clock = clock
        self.host = host
        self._events: collections.deque[dict] = collections.deque(
            maxlen=capacity)
        self.n_emitted = 0           # total ever, beyond the retained window

    def emit(self, kind: str, **fields) -> dict:
        ev = {"seq": self.n_emitted, "ts": self.clock(), "kind": kind}
        if self.host is not None:
            ev["host"] = self.host
        ev.update(fields)
        self._events.append(ev)
        self.n_emitted += 1
        return ev

    def __len__(self) -> int:
        return len(self._events)

    def tail(self, n: int | None = None) -> list[dict]:
        """The newest ``n`` retained events, oldest first (all by default)."""
        evs = list(self._events)
        return evs if n is None else evs[-n:]

    def dump_jsonl(self, path_or_buf, append: bool = True) -> int:
        """Write the retained window as JSON lines (to a path or any
        write()-able); returns the number of events written."""
        evs = self.tail()
        if hasattr(path_or_buf, "write"):
            for ev in evs:
                path_or_buf.write(json.dumps(ev) + "\n")
        else:
            with open(path_or_buf, "a" if append else "w") as f:
                for ev in evs:
                    f.write(json.dumps(ev) + "\n")
        return len(evs)
