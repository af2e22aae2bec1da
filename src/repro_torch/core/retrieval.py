"""The dense masked oracle and the paper's recovery metric, in PyTorch.

Counterpart of ``repro.core.retrieval``:
:func:`masked_topk` scores through the ``gam_score`` kernel (its plain
version on the CPU) and writes out the (score desc, row asc) order itself,
as ``lax.top_k`` gives it; :func:`candidate_topk` gives the same answer for
a flat candidate list (the ``gam`` backend's and the baselines' scoring);
:func:`recovery_accuracy` is the paper's §6 metric.  ``GamRetriever`` and
``BruteForceRetriever`` remain as the reference's deprecation shims: each
warns with the new spelling and delegates everything to its backend.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

# ``ops`` as a module reference, resolved at call time: ``kernels`` imports
# ``core`` while ``core`` is still initialising when ``core`` is imported
# first.  (``kernels`` exports ``ops``' entry points under the names of
# their modules, so a kernel module is reached by its full path.)
import repro_torch.kernels.ops as _ops
from repro_torch.kernels.gam_score import NEG

__all__ = ["BruteForceRetriever", "GamRetriever", "candidate_topk",
           "masked_topk", "recovery_accuracy", "topk_desc"]

# query rows x items of one dense candidate mask (bounds its temporaries)
_MASK_CELLS = 1 << 25


def topk_desc(scores: torch.Tensor, kappa: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(Q, N) scores -> top-kappa (values, column indices int64) under the
    total order (score desc, column asc).

    ``torch.topk`` picks the set; its order on ties is unspecified, so the
    set is re-sorted explicitly, and rows whose kappa-th score is tied with
    an entry outside the set fall back to a stable full sort."""
    kk = min(int(kappa), scores.shape[1])
    vals, idx = torch.topk(scores, kk, dim=1)
    idx, perm = torch.sort(idx, dim=1)
    vals = torch.gather(vals, 1, perm)
    order = torch.argsort(-vals, dim=1, stable=True)
    vals = torch.gather(vals, 1, order)
    idx = torch.gather(idx, 1, order)
    tied = torch.nonzero((scores >= vals[:, -1:]).sum(dim=1) > kk).flatten()
    if tied.numel():
        full = torch.argsort(-scores[tied], dim=1, stable=True)[:, :kk]
        idx[tied] = full
        vals[tied] = torch.gather(scores[tied], 1, full)
    return vals, idx


def masked_topk(users: torch.Tensor, items: torch.Tensor, masks: torch.Tensor,
                kappa: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense masked top-kappa: exact scores where ``masks`` (Q, N) is set,
    NEG elsewhere, then (score desc, row asc).  Returns (vals, ids int32)."""
    vals, ids = topk_desc(_ops.gam_score(users, items, masks), kappa)
    return vals, ids.to(torch.int32)


def candidate_topk(users: torch.Tensor, factors: torch.Tensor,
                   qrow: torch.Tensor, rows: torch.Tensor, kappa: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact top-kappa of each query over its own candidate rows.

    ``qrow``/``rows``: (M,) int64 (query, factor row) pairs, ordered by
    query.  A few queries at a time the pairs become a dense candidate mask
    scored by :func:`masked_topk` (the ``gam_score`` kernel on the card: the
    fused kernel's f32 arithmetic, (score desc, row asc)).  Returns ``vals``
    (Q, kappa) f32 with -inf in empty slots, ``rows`` (Q, kappa) int64 with
    -1 there, and each query's candidate count (Q,) int64."""
    q, n, dev = users.shape[0], factors.shape[0], users.device
    vals = torch.full((q, kappa), -torch.inf, dtype=torch.float32, device=dev)
    out = torch.full((q, kappa), -1, dtype=torch.int64, device=dev)
    step = max(1, _MASK_CELLS // max(n, 1))
    starts = torch.arange(0, q + step, step, device=dev).clamp_(max=q)
    edges = torch.searchsorted(qrow, starts).tolist()
    for i, c0 in enumerate(range(0, q, step)):
        c1, lo, hi = min(q, c0 + step), edges[i], edges[i + 1]
        mask = torch.zeros((c1 - c0, n), dtype=torch.bool, device=dev)
        mask[qrow[lo:hi] - c0, rows[lo:hi]] = True
        v, r = masked_topk(users[c0:c1], factors, mask, kappa)
        empty = v <= NEG / 2
        vals[c0:c1, :v.shape[1]] = torch.where(empty, -torch.inf, v)
        out[c0:c1, :v.shape[1]] = torch.where(empty, -1, r.to(torch.int64))
    return vals, out, torch.bincount(qrow, minlength=q)


def _deprecated(old: str, new: str) -> None:
    warnings.warn(f"{old} is deprecated; use {new} "
                  "(see repro_torch.retriever — removed after one release)",
                  DeprecationWarning, stacklevel=3)


class BruteForceRetriever:
    """DEPRECATED shim — use ``open_retriever(RetrieverSpec(cfg=...,
    backend='brute'))``.  Exact top-kappa by scoring every item, on
    ``device`` (``None``: the card)."""

    def __init__(self, items: np.ndarray, *, device=None):
        _deprecated("core.retrieval.BruteForceRetriever(items)",
                    "repro_torch.retriever.open_retriever(RetrieverSpec("
                    "cfg=GamConfig(k=...), backend='brute'), items=items)")
        from repro_torch.core.mapping import GamConfig
        from repro_torch.retriever import RetrieverSpec, open_retriever
        items = np.asarray(items, np.float32)
        spec = RetrieverSpec(cfg=GamConfig(k=items.shape[1]), backend="brute")
        self._impl = open_retriever(spec, items=items, device=device)

    def __getattr__(self, name):
        if name == "_impl":      # not set yet (e.g. unpickling a bare shell)
            raise AttributeError(name)
        return getattr(self._impl, name)


class GamRetriever:
    """DEPRECATED shim — use ``open_retriever(RetrieverSpec(cfg=cfg,
    backend='gam'|'gam-device', ...))``.  Paper's method: phi-map items
    once, inverted index, candidate-only scoring.  ``device`` keeps its
    legacy meaning (True: ``gam-device``); ``torch_device`` is where the
    backend runs (``None``: the card)."""

    def __init__(self, items: np.ndarray, cfg, min_overlap: int = 1,
                 device: bool = False, bucket: int = 256,
                 whiten: bool = False, *, torch_device=None):
        backend = "gam-device" if device else "gam"
        _deprecated("core.retrieval.GamRetriever(items, cfg, ...)",
                    f"repro_torch.retriever.open_retriever(RetrieverSpec("
                    f"cfg=cfg, backend={backend!r}, min_overlap=..., "
                    f"bucket=..., whiten=...), items=items)")
        from repro_torch.retriever import RetrieverSpec, open_retriever
        spec = RetrieverSpec(cfg=cfg, backend=backend,
                             min_overlap=min_overlap, bucket=bucket,
                             whiten=whiten)
        self._impl = open_retriever(spec, items=items, device=torch_device)

    def __getattr__(self, name):
        if name == "_impl":      # not set yet (e.g. unpickling a bare shell)
            raise AttributeError(name)
        return getattr(self._impl, name)


def recovery_accuracy(retrieved_ids: np.ndarray,
                      true_ids: np.ndarray) -> np.ndarray:
    """Fraction of the true top-kappa recovered, per query (paper §6 metric);
    ``-1`` pads on either side never count."""
    ret = np.asarray(retrieved_ids)
    true = np.asarray(true_ids)
    hit = (true[:, :, None] == ret[:, None, :]) & (true >= 0)[:, :, None]
    hit &= (ret >= 0)[:, None, :]
    inter = hit.any(axis=-1).sum(axis=-1)
    denom = np.maximum((true >= 0).sum(axis=-1), 1)
    return inter / denom
