"""Timestamp-ordered implicit-feedback events — the input contract of the
streaming trainer (a copy of ``repro.online.events``; numpy only).

An :class:`EventBatch` is a struct-of-arrays batch of ``(ts, user, item,
value)`` interactions, stable-sorted by timestamp on construction so
``partial_fit`` always consumes events in arrival order regardless of how
the producer assembled them.  ``value`` is the implicit-feedback strength
(play count, dwell, rating residual, ...); the trainer derives WMF-style
confidence ``1 + alpha * |value|`` from it.

The JSONL spelling is one ``{"ts":..., "user":..., "item":..., "value":...}``
object per line, ``value`` optional (1.0); see docs/online_learning.md.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

__all__ = ["EventBatch"]


@dataclasses.dataclass
class EventBatch:
    ts: np.ndarray        # (n,) float64 event timestamps (any monotone unit)
    users: np.ndarray     # (n,) int64 user ids (row ids, growable)
    items: np.ndarray     # (n,) int64 item ids (catalog ids, growable)
    values: np.ndarray    # (n,) float32 implicit-feedback strength

    def __post_init__(self):
        self.ts = np.asarray(self.ts, np.float64).ravel()
        self.users = np.asarray(self.users, np.int64).ravel()
        self.items = np.asarray(self.items, np.int64).ravel()
        self.values = np.asarray(self.values, np.float32).ravel()
        n = self.ts.size
        if not (self.users.size == self.items.size == self.values.size == n):
            raise ValueError("ts/users/items/values lengths differ")
        if n and (self.users.min() < 0 or self.items.min() < 0):
            raise ValueError("negative user/item id")
        # stable sort: equal timestamps keep producer order, so duplicate
        # (user, item) events resolve last-write-wins downstream
        order = np.argsort(self.ts, kind="stable")
        if not np.array_equal(order, np.arange(n)):
            self.ts = self.ts[order]
            self.users = self.users[order]
            self.items = self.items[order]
            self.values = self.values[order]

    def __len__(self) -> int:
        return int(self.ts.size)

    @classmethod
    def empty(cls) -> "EventBatch":
        return cls(np.empty(0), np.empty(0, np.int64),
                   np.empty(0, np.int64), np.empty(0, np.float32))

    @classmethod
    def concat(cls, batches) -> "EventBatch":
        batches = list(batches)
        if not batches:
            return cls.empty()
        return cls(np.concatenate([b.ts for b in batches]),
                   np.concatenate([b.users for b in batches]),
                   np.concatenate([b.items for b in batches]),
                   np.concatenate([b.values for b in batches]))

    # ------------------------------------------------------------- JSONL io

    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for t, u, i, v in zip(self.ts, self.users, self.items,
                                  self.values):
                f.write(json.dumps({"ts": float(t), "user": int(u),
                                    "item": int(i), "value": float(v)}) +
                        "\n")

    @classmethod
    def from_jsonl(cls, path: str) -> "EventBatch":
        ts, users, items, values = [], [], [], []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                ts.append(rec["ts"])
                users.append(rec["user"])
                items.append(rec["item"])
                values.append(rec.get("value", 1.0))
        return cls(np.asarray(ts), np.asarray(users, np.int64),
                   np.asarray(items, np.int64),
                   np.asarray(values, np.float32))
