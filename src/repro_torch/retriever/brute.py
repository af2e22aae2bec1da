"""``brute`` backend: exact top-kappa by scoring every item.

Counterpart of ``repro.retriever.brute``.  Scores are one ``torch.matmul``
on the retriever's device (IEEE f32, TF32 off); the (score desc, id asc)
order is written out by ``core.retrieval.topk_desc``, which falls back to a
stable full sort on rows tied at the kappa boundary, as ``exact_topk`` does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.retrieval import topk_desc
from repro_torch.retriever.api import Retriever, RetrieverSpec
from repro_torch.retriever.snapshot import read_snapshot, write_snapshot
from repro_torch.retriever.types import RetrievalResult, dedupe_last_write

__all__ = ["BruteRetriever", "score_all"]


def score_all(ids: np.ndarray, items: torch.Tensor, users: np.ndarray,
              kappa: int) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-kappa over every item: (Q, kappa) catalog ids (-1 pad) and
    scores (-inf pad) as host arrays.  One matmul on the items' device
    (IEEE f32) and :func:`topk_desc`: ``brute``'s answer, and every other
    backend's ``exact=True``."""
    q, n = users.shape[0], items.shape[0]
    ids_out = np.full((q, kappa), -1, np.int64)
    sc_out = np.full((q, kappa), -np.inf, np.float32)
    if n:
        kk = min(kappa, n)
        u = torch.as_tensor(users, device=items.device)
        vals, cols = topk_desc(torch.matmul(u, items.T), kk)
        ids_out[:, :kk] = ids[cols.cpu().numpy()]
        sc_out[:, :kk] = vals.cpu().numpy()
    return ids_out, sc_out


class BruteRetriever(Retriever):
    def __init__(self, spec: RetrieverSpec, device: torch.device):
        super().__init__(spec, device)
        self._set(np.zeros(0, np.int64), np.zeros((0, spec.cfg.k), np.float32))

    def _set(self, ids: np.ndarray, items: np.ndarray) -> None:
        self.ids, self.items = ids, items
        self._items_dev = torch.as_tensor(items, device=self.device)

    def build(self, items, ids=None) -> "BruteRetriever":
        items = np.asarray(items, np.float32).reshape(-1, self.spec.cfg.k)
        ids = (np.arange(items.shape[0], dtype=np.int64) if ids is None
               else np.asarray(ids, np.int64).ravel())
        if len(np.unique(ids)) != ids.size:
            raise ValueError("item ids must be unique")
        order = np.argsort(ids)
        self._set(ids[order], items[order])
        return self

    def upsert(self, ids, factors) -> None:
        ids = np.asarray(ids, np.int64).ravel()
        factors = np.asarray(factors, np.float32).reshape(
            ids.size, self.spec.cfg.k)
        ids, factors = dedupe_last_write(ids, factors)
        keep = ~np.isin(self.ids, ids)
        self.build(np.concatenate([self.items[keep], factors]),
                   np.concatenate([self.ids[keep], ids]))

    def delete(self, ids) -> None:
        keep = ~np.isin(self.ids, np.asarray(ids, np.int64).ravel())
        self.build(self.items[keep], self.ids[keep])

    def compact(self, async_: bool = False) -> None:
        pass                       # always compact: one flat factor matrix

    def query(self, users, kappa=None, *, exact=False,
              explain=False) -> RetrievalResult:
        kappa = self.spec.kappa if kappa is None else int(kappa)
        users = np.asarray(users, np.float32)
        q, n = users.shape[0], self.items.shape[0]
        ids_out, sc_out = score_all(self.ids, self._items_dev, users, kappa)
        exp = None
        if explain:
            exp = {"backend": "brute",
                   "n_candidates": [n] * q,
                   "shard_candidates": [[n]] * q}
        return RetrievalResult(
            ids=ids_out, scores=sc_out,
            n_scored=np.full(q, n, np.int64),
            discarded_frac=np.zeros(q),
            explain=exp,
        )

    @property
    def n_items(self) -> int:
        return int(self.ids.size)

    def snapshot(self, path: str) -> None:
        write_snapshot(path, self.spec,
                       {"ids": self.ids, "items": self.items})

    def restore(self, path: str) -> "BruteRetriever":
        arrays, _ = read_snapshot(path, self.spec)
        self._set(np.asarray(arrays["ids"], np.int64),
                  np.asarray(arrays["items"], np.float32))
        return self
