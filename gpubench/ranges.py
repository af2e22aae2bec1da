"""The program's stages on the profiler's timeline: the ``repro_torch.<stage>``
host ranges of a traced window (``Profile.host``), the card's idle time
inside them, and the runtime's kernel launch calls that start inside them.

``repro_torch``'s tracer opens one such range a stage while a profiler
records, whether or not it samples the request; a program without them
has none, and every reader here then finds nothing (``None``).  Requests
are counted as the window's, ``len(run.queries)``.
"""
from __future__ import annotations

import bisect
import re

from gpubench.trace import _union

__all__ = ["LAUNCHES", "PREFIX", "idle_ms", "launches_per_request",
           "stage_ms", "stage_ms_by_name"]

PREFIX = "repro_torch."
#: the CUDA runtime's and driver's kernel launch calls, as kineto names them
LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernel", "cuLaunchKernelEx"})
_KERNEL = re.compile(r"^(?!Memcpy|Memset)")


def _ranges(prof, stage: str) -> list:
    """The union of the window's ranges of ``stage`` (ns), sorted."""
    name = PREFIX + stage
    return _union([[a, b] for n, a, b in prof.host if n == name])


def _idle(prof) -> list:
    """The window's intervals in which no device activity ran (ns): the
    gaps between ``Profile``'s own union of the device's activities."""
    gaps, prev = [], prof.t0
    for a, b in prof._busy:
        if a > prev:
            gaps.append([prev, a])
        prev = max(prev, b)
    if prof.t1 > prev:
        gaps.append([prev, prof.t1])
    return gaps


def _overlap_ns(xs: list, ys: list) -> int:
    """Nanoseconds two sorted lists of disjoint intervals share."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def _requests(run) -> int:
    return len(run.queries) if run.profile is not None else 0


def stage_ms(run, stage: str) -> float | None:
    """Host milliseconds a request inside ``stage``'s ranges; ``None``
    without a profile or such ranges."""
    n = _requests(run)
    spans = _ranges(run.profile, stage) if n else []
    if not spans:
        return None
    return 1e-6 * sum(b - a for a, b in spans) / n


def stage_ms_by_name(run) -> dict:
    """Host milliseconds a request in each stage's ranges, by stage."""
    if not _requests(run):
        return {}
    names = {n[len(PREFIX):] for n, _, _ in run.profile.host
             if n.startswith(PREFIX)}
    return {s: stage_ms(run, s) for s in sorted(names)}


def idle_ms(run, stage: str = "query") -> float | None:
    """Device-idle milliseconds a request that fell inside ``stage``'s
    ranges; ``None`` without a profile, device activities or such ranges.
    Notes the share of the window's idle time they hold."""
    prof = run.profile
    n = _requests(run)
    if not n or not prof.device:
        return None
    spans = _ranges(prof, stage)
    if not spans:
        return None
    gaps = _idle(prof)
    inside = _overlap_ns(gaps, spans)
    idle = sum(b - a for a, b in gaps)
    run.notes[f"idle in {PREFIX}{stage}"] = (
        f"{inside * 1e-9:.6f} s of the window's {idle * 1e-9:.6f} s "
        f"device-idle ({100.0 * inside / max(idle, 1):.2f}%), "
        f"{n} requests")
    return 1e-6 * inside / n


def launches_per_request(run, stage: str = "query") -> float | None:
    """Kernel launch calls (:data:`LAUNCHES`) that start inside ``stage``'s
    ranges, over the requests; ``None`` without a profile, device
    activities or such ranges.  Notes them beside the window's launch
    calls and its kernel activities."""
    prof = run.profile
    n = _requests(run)
    if not n or not prof.device:
        return None
    spans = _ranges(prof, stage)
    if not spans:
        return None
    starts = [a for a, _ in spans]
    calls = [a for name, a, _ in prof.host if name in LAUNCHES]
    inside = 0
    for t in calls:
        i = bisect.bisect_right(starts, t) - 1
        inside += i >= 0 and t < spans[i][1]
    kernels = sum(1 for name, _, _ in prof.device if _KERNEL.match(name))
    run.notes[f"launches in {PREFIX}{stage}"] = (
        f"{inside} launch calls inside, {len(calls)} in the window, "
        f"{kernels} kernel activities in the window, {n} requests")
    return inside / n
