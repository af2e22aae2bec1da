"""Per-request figures from the program's own spans (``repro_torch.obs``)."""
from __future__ import annotations

__all__ = ["mean_span_ms"]


def _total_s(span, name: str) -> float | None:
    found = span.find(name)
    return sum(s.duration_s for s in found) if found else None


def mean_span_ms(run, name: str) -> float | None:
    """Mean over the window's requests of the time in spans ``name``, in
    milliseconds; ``None`` where no request has one."""
    per = [_total_s(root, name) for root in run.spans]
    per = [t for t in per if t is not None]
    return 1e3 * sum(per) / len(per) if per else None
