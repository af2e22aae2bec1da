"""The work a call of the fused retrieval kernel must do, counted from its
inputs (PERF.md's kernel table, row 1): 2k operations a (query, candidate)
pair on the f32 units; each input byte read once (the queries, and the
factors and packed patterns of every live catalog row) and each output
byte written once (kappa scores and rows a query)."""
from __future__ import annotations

__all__ = ["gam_retrieve_work"]

F32 = 4


def gam_retrieve_work(q: int, k: int, p: int, kappa: int, n_rows: int,
                      candidates: int, launches: int) -> tuple[float, float]:
    """(f32 operations, bytes) of one request's launches: ``q`` queries of
    width ``k`` over ``n_rows`` live rows in a ``p``-wide pattern space,
    ``candidates`` (query, row) pairs scored, ``launches`` calls each
    writing its top ``kappa``."""
    words = -(-p // 32)
    ops = 2.0 * k * candidates
    n_bytes = (q * k * F32 + n_rows * (k * F32 + words * F32)
               + launches * q * kappa * 2 * F32)
    return ops, float(n_bytes)
