"""What a traced window's ``torch.profiler`` trace holds, read in memory.

The window is the CPU annotation ``gpubench.window``; every device
activity (kernels, copies, sets) is clipped to it.  Idle gaps are labelled
by the innermost host operation running at their middle, or ``host
(python)`` where the host ran no torch operation.
"""
from __future__ import annotations

import collections
import re

__all__ = ["Profile", "WINDOW"]

WINDOW = "gpubench.window"
_NO_OP = "host (python)"


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _short(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = re.sub(r"^void ", "", name)
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut]


class Profile:
    """Device and host intervals of one traced window (nanoseconds)."""

    def __init__(self, events):
        win = [e for e in events if e.name() == WINDOW]
        if not win:
            raise RuntimeError("the trace holds no window annotation")
        w = max(win, key=lambda e: e.duration_ns())
        self.t0, self.t1 = w.start_ns(), w.start_ns() + w.duration_ns()
        self.device, self.host = [], []
        for e in events:
            a = max(e.start_ns(), self.t0)
            b = min(e.start_ns() + e.duration_ns(), self.t1)
            if b <= a or e.name() == WINDOW:
                continue
            if str(e.device_type()).endswith("CUDA"):
                self.device.append((e.name(), a, b))
            else:
                self.host.append((e.name(), a, b))
        self._busy = _union([[a, b] for _, a, b in self.device])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._busy) * 1e-9

    def kernel_s(self, pattern: str) -> float:
        """Seconds of device activities whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(b - a for n, a, b in self.device if rx.search(n)) * 1e-9

    def top_ops(self, n: int = 10) -> list:
        by = collections.Counter()
        for name, a, b in self.device:
            by[_short(name)] += (b - a) * 1e-9
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n: int = 10) -> list:
        """Idle device seconds, summed by what the host was doing."""
        gaps = []
        prev = self.t0
        for a, b in self._busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        # a sweep over the gaps' middles: host operations nest, so the
        # innermost one running at a point is the top of a stack
        host = sorted(self.host, key=lambda h: (h[1], -h[2]))
        by = collections.Counter()
        stack, i = [], 0
        for a, b in gaps:
            mid = (a + b) // 2
            while i < len(host) and host[i][1] <= mid:
                while stack and stack[-1][2] <= host[i][1]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][2] <= mid:
                stack.pop()
            by[stack[-1][0] if stack else _NO_OP] += (b - a) * 1e-9
        return [[k, v] for k, v in by.most_common(n)]
