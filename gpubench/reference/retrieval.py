"""Plain top-kappa maximum-inner-product retrieval over phi's candidates.

The semantics the configurations state: an item is a candidate of a query
when it is live and the non-zero destinations of their phi maps share at
least ``min_overlap`` entries; the answer is the kappa candidates of
highest inner product.  ``answer`` computes it exactly (phi in f32,
overlaps as exact integer products, scores in float64).  With
``precision="low"`` it is the control: phi in bfloat16 and the scores as
float32 products in TF32 (emulated on the CPU by rounding the inputs to
TF32's 10-bit mantissa), one step below what the configurations state.

Work runs in blocks of catalog rows on ``device``; nothing here reads
anything the program under test made.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpubench.reference.phi import parse_tree_dim, phi

__all__ = ["Answer", "Catalog", "answer", "live_catalog"]

_ROWS = 1 << 16           # catalog rows a block


@dataclasses.dataclass
class Catalog:
    """A live catalog with its phi maps: ids sorted ascending."""

    ids: np.ndarray           # (n,) int64
    factors: np.ndarray       # (n, k) f32
    tau: np.ndarray           # (n, k) int64
    mask: np.ndarray          # (n, k) bool

    @classmethod
    def of(cls, ids, factors, threshold: float, precision: str = "f32",
           device="cpu"):
        ids = np.asarray(ids, np.int64)
        order = np.argsort(ids)
        ids, factors = ids[order], np.asarray(factors, np.float32)[order]
        tau, mask = phi(factors, threshold,
                        precision="bf16" if precision == "low" else "f32",
                        device=device)
        return cls(ids, factors, tau, mask)


def live_catalog(ids, factors, mutations) -> tuple[np.ndarray, np.ndarray]:
    """Replay ``mutations`` (``("upsert", ids, factors)`` and ``("delete",
    ids)`` in order; within one upsert the last write of an id wins) onto
    the catalog -> the live (ids, factors), ids ascending."""
    rows = {int(i): f for i, f in zip(np.asarray(ids, np.int64),
                                      np.asarray(factors, np.float32))}
    for op in mutations:
        if op[0] == "upsert":
            for i, f in zip(np.asarray(op[1], np.int64),
                            np.asarray(op[2], np.float32)):
                rows[int(i)] = f
        elif op[0] == "delete":
            for i in np.asarray(op[1], np.int64):
                rows.pop(int(i), None)
        else:
            raise ValueError(f"unknown mutation {op[0]!r}")
    out = np.array(sorted(rows), np.int64)
    k = np.asarray(factors).shape[1]
    fac = (np.stack([rows[int(i)] for i in out]) if out.size
           else np.zeros((0, k), np.float32))
    return out, fac.astype(np.float32)


def _dense(tau: np.ndarray, mask: np.ndarray, p: int, device) -> torch.Tensor:
    """(n, p) f32 0/1 matrix of each row's non-zero destinations."""
    out = torch.zeros((len(tau), p), dtype=torch.float32, device=device)
    t = torch.as_tensor(tau, device=device)
    m = torch.as_tensor(mask, device=device).to(torch.float32)
    return out.scatter_(1, t, m)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10-bit mantissa (nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@dataclasses.dataclass
class Answer:
    """An answer to a block of queries, as the program reports one."""

    ids: np.ndarray           # (Q, kappa) int64, -1 where empty
    scores: np.ndarray        # (Q, kappa) f32 (f64 for the exact reference)
    n_scored: np.ndarray      # (Q,) candidates


def answer(cat: Catalog, users: np.ndarray, *, threshold: float,
           min_overlap: int, kappa: int, device,
           precision: str = "exact") -> Answer:
    """Top-kappa over the candidates of each user, under (score desc, id
    asc).  ``precision="exact"``: float64 scores; ``"low"``: the control
    (``cat`` must then come from ``Catalog.of(..., precision="low")``)."""
    device = torch.device(device)
    users = np.asarray(users, np.float32)
    q, k = users.shape
    p = parse_tree_dim(k)
    low = precision == "low"
    u_tau, u_mask = phi(users, threshold, precision="bf16" if low else "f32",
                        device=device)
    u_dense = _dense(u_tau, u_mask, p, device)
    u = torch.as_tensor(users, device=device)
    u = _tf32(u) if low and device.type == "cpu" else u
    u = u if low else u.to(torch.float64)
    best_s = torch.full((q, kappa), -np.inf, dtype=u.dtype, device=device)
    best_i = torch.full((q, kappa), -1, dtype=torch.int64, device=device)
    counts = torch.zeros(q, dtype=torch.int64, device=device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = low and device.type == "cuda"
    try:
        for lo in range(0, len(cat.ids), _ROWS):
            hi = min(len(cat.ids), lo + _ROWS)
            ov = u_dense @ _dense(cat.tau[lo:hi], cat.mask[lo:hi], p,
                                  device).T
            cand = ov >= min_overlap
            counts += cand.sum(dim=1)
            x = torch.as_tensor(cat.factors[lo:hi], device=device)
            x = _tf32(x) if low and device.type == "cpu" else x
            s = u @ x.to(u.dtype).T
            s = torch.where(cand, s, -np.inf)
            ids = torch.as_tensor(cat.ids[lo:hi], device=device)
            # ties: the lower id first, as the rows are in id order
            cat_s = torch.cat([best_s, s], dim=1)
            cat_i = torch.cat([best_i, ids.expand(q, -1)], dim=1)
            top = torch.argsort(-cat_s, dim=1, stable=True)[:, :kappa]
            best_s = torch.gather(cat_s, 1, top)
            best_i = torch.gather(cat_i, 1, top)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    best_i = torch.where(torch.isinf(best_s), -1, best_i)
    return Answer(best_i.cpu().numpy(), best_s.cpu().numpy(),
                  counts.cpu().numpy())
