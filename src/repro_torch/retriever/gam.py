"""``gam`` and ``gam-device`` backends: the paper's deployment object.

Counterpart of ``repro.retriever.gam``.  Item factors are mapped with phi
once (the ``tess_project`` kernel on the card), the sparsity patterns are
indexed, and ``query`` answers top-kappa MIPS over only the candidates
(pattern overlap >= ``spec.min_overlap``), with exact f32 scores:

* ``gam``: the paper's CSR inverted index (:class:`InvertedIndex`, or
  :class:`CompressedInvertedIndex` under ``compress_postings``) on the
  retriever's device, built on first use.  The posting walk gives a
  request's candidates, which are scored a chunk of queries at a time as a
  dense candidate mask through ``gam_score`` (the fused kernel's
  arithmetic) and ordered (score desc, row asc); there is no bucket and no
  spill.  Under ``quantize="int8"`` it scores exactly in f32 and never
  reads a slab, as the reference's ``gam`` does.
* ``gam-device``: a dense-bucket :class:`DeviceIndex` whose patterns are
  packed into bitsets and block unions, answered by one call of the fused
  ``gam_retrieve`` kernel (zero-candidate blocks skipped).  Under
  ``quantize="int8"`` the int8 kernel scores a per-block-scaled slab and its
  pool of ``kappa * rerank_factor`` rows is re-ranked against the exact f32
  rows; ``compress_postings`` is storage-only there (snapshots hold the
  table as a varint CSR).

Mutations rebuild in O(N), as in the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.inverted_index import (CompressedInvertedIndex,
                                             DeviceIndex, InvertedIndex)
from repro_torch.core.mapping import sparse_map
from repro_torch.core.retrieval import candidate_topk
from repro_torch.kernels.gam_retrieve import (RetrievalMeta,
                                              build_retrieval_meta,
                                              expand_tile_skips)
from repro_torch.kernels.gam_score import NEG
from repro_torch.kernels.ops import gam_retrieve
from repro_torch.retriever.api import Retriever, RetrieverSpec
from repro_torch.retriever.brute import score_all
from repro_torch.retriever.convert import (csr_from_reference,
                                           csr_to_reference,
                                           index_from_reference,
                                           index_to_reference)
from repro_torch.retriever.snapshot import read_snapshot, write_snapshot
from repro_torch.retriever.types import (RetrievalResult, UnsupportedOp,
                                         dedupe_last_write)

__all__ = ["GamIndexRetriever"]


class GamIndexRetriever(Retriever):
    """phi-map + inverted index + exact scores of the candidates."""

    def __init__(self, spec: RetrieverSpec, device: torch.device):
        super().__init__(spec, device)
        self.fused = spec.backend == "gam-device"
        self._empty()

    def _empty(self) -> None:
        k = self.spec.cfg.k
        self.ids = np.zeros(0, np.int64)
        self.items = np.zeros((0, k), np.float32)
        self.item_tau = np.zeros((0, k), np.int32)
        self.item_mask = np.zeros((0, k), bool)
        self._scale: np.ndarray | None = None
        # gam: the mapped catalog the CSR index is built from on first use
        self._tau = (
            torch.zeros((0, k), dtype=torch.int32, device=self.device),
            torch.zeros((0, k), dtype=torch.bool, device=self.device))
        self._csr: InvertedIndex | CompressedInvertedIndex | None = None
        self.device_index: DeviceIndex | None = None
        self._items_dev: torch.Tensor | None = None
        self._retrieve_meta: RetrievalMeta | None = None

    # ------------------------------------------------------------ lifecycle

    def build(self, items, ids=None) -> "GamIndexRetriever":
        spec = self.spec
        items = np.asarray(items, np.float32).reshape(-1, spec.cfg.k)
        ids = (np.arange(items.shape[0], dtype=np.int64) if ids is None
               else np.asarray(ids, np.int64).ravel())
        if len(np.unique(ids)) != ids.size:
            raise ValueError("item ids must be unique")
        if ids.size == 0:
            self._empty()
            return self
        order = np.argsort(ids)
        self.ids, self.items = ids[order], items[order]
        # whiten: the paper's non-uniform tessellation for anisotropic
        # factors; exact scores always use the raw factors
        self._scale = (1.0 / (self.items.std(axis=0) + 1e-9)
                       if spec.whiten else None)
        self._items_dev = torch.as_tensor(self.items, device=self.device)
        mapped = (self._items_dev * torch.as_tensor(self._scale,
                                                    device=self.device)
                  if spec.whiten else self._items_dev)
        tau, vals = sparse_map(mapped, spec.cfg)
        # the index stores only NON-zero coordinates of phi(v)
        self.item_tau = tau.cpu().numpy()
        self.item_mask = (vals != 0.0).cpu().numpy()
        if not self.fused:             # the CSR index is built on first use
            self._tau, self._csr = (tau, vals != 0.0), None
            return self
        n = len(self.items)
        self.device_index = DeviceIndex.build(
            self.item_tau, spec.cfg.p, spec.bucket, mask=self.item_mask,
            device=self.device)
        self._retrieve_meta = build_retrieval_meta(
            tau, vals != 0.0, spec.cfg.p,
            spill_rows=self.device_index.spill.cpu().numpy(),
            bn=spec.bn or min(512, -(-max(n, 1) // 128) * 128),
            factors=self._items_dev if spec.quantize == "int8" else None,
            quantize=spec.quantize, device=self.device)
        return self

    def upsert(self, ids, factors) -> None:
        """O(N + batch) rebuild, as in the reference."""
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
        pass                  # rebuilt-on-mutation: never holds a delta

    # ------------------------------------------------------------ queries

    @property
    def index(self) -> InvertedIndex | CompressedInvertedIndex:
        """``gam``'s posting lists on the retriever's device: the flat CSR,
        or the pattern-factored varint encoding under
        ``spec.compress_postings`` (answers are identical either way)."""
        if self._csr is None:
            tau, mask = self._tau
            idx = InvertedIndex(tau, self.spec.cfg.p, mask,
                                device=self.device)
            self._csr = (idx.compress() if self.spec.compress_postings
                         else idx)
            self._tau = None
        return self._csr

    def _map(self, users: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if self._scale is not None:
            users = users * torch.as_tensor(self._scale, device=self.device)
        tau, vals = sparse_map(users, self.spec.cfg)
        return tau, vals != 0.0

    def map_queries(self, users: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        tau, mask = self._map(torch.as_tensor(np.asarray(users, np.float32),
                                              device=self.device))
        return tau.cpu().numpy(), mask.cpu().numpy()

    def query(self, users, kappa=None, *, exact=False,
              explain=False) -> RetrievalResult:
        kappa = self.spec.kappa if kappa is None else int(kappa)
        users = np.asarray(users, np.float32)
        q = users.shape[0]
        if self.n_items == 0:
            exp = ({"backend": self.spec.backend, "n_candidates": [0] * q}
                   if explain else None)
            return RetrievalResult(np.full((q, kappa), -1, np.int64),
                                   np.full((q, kappa), -np.inf, np.float32),
                                   np.zeros(q, np.int64), np.zeros(q),
                                   explain=exp)
        if not self.fused:
            return self._query_index(users, kappa, exact=exact,
                                     explain=explain)
        n = self.items.shape[0]
        u = torch.as_tensor(users, device=self.device)
        q_tau, q_mask = self._map(u)
        kk = min(kappa, n)
        res = gam_retrieve(u, self._items_dev, q_tau, q_mask,
                           self._retrieve_meta, kk,
                           min_overlap=0 if exact else self.spec.min_overlap,
                           bq=self.spec.bq,
                           rerank_factor=self.spec.rerank_factor)
        vals = res.vals.cpu().numpy()
        rows = res.rows.cpu().numpy().astype(np.int64)
        blk_counts = res.blk_counts.cpu().numpy().astype(np.int64)
        empty = vals <= NEG / 2          # slots no candidate could fill
        ids_out = np.full((q, kappa), -1, np.int64)
        sc_out = np.full((q, kappa), -np.inf, np.float32)
        ids_out[:, :kk] = np.where(empty, -1,
                                   self.ids[np.clip(rows, 0, n - 1)])
        sc_out[:, :kk] = np.where(empty, -np.inf, vals)
        n_scored = blk_counts.sum(axis=1)
        exp = None
        if explain:
            skips = expand_tile_skips(res.skipped.cpu().numpy(), q,
                                      self.spec.bq)
            exp = {"backend": "gam-device",
                   "n_candidates": n_scored.tolist(),
                   "block_candidates": blk_counts.tolist(),
                   "blocks_skipped": skips.sum(axis=1).tolist(),
                   "n_blocks": int(blk_counts.shape[1])}
        return RetrievalResult(ids=ids_out, scores=sc_out, n_scored=n_scored,
                               discarded_frac=1.0 - n_scored / n,
                               explain=exp)

    def _query_index(self, users: np.ndarray, kappa: int, *, exact: bool,
                     explain: bool) -> RetrievalResult:
        """``gam``: the posting walk's candidates, scored exactly in f32
        under (score desc, row asc); ``exact=True`` is ``brute``'s answer."""
        n, q = self.items.shape[0], users.shape[0]
        if exact:
            ids_out, sc_out = score_all(self.ids, self._items_dev, users,
                                        kappa)
            n_scored = np.full(q, n, np.int64)
        else:
            u = torch.as_tensor(users, device=self.device)
            q_tau, q_mask = self._map(u)
            qrow, rows, _ = self.index.candidates(q_tau, self.spec.min_overlap,
                                                  q_mask)
            vals, top, counts = candidate_topk(u, self._items_dev, qrow, rows,
                                               kappa)
            top = top.cpu().numpy()
            ids_out = np.where(top >= 0, self.ids[np.clip(top, 0, n - 1)], -1)
            sc_out = vals.cpu().numpy()
            n_scored = counts.cpu().numpy()
        exp = ({"backend": "gam", "n_candidates": n_scored.tolist()}
               if explain else None)
        return RetrievalResult(ids=ids_out, scores=sc_out, n_scored=n_scored,
                               discarded_frac=1.0 - n_scored / n,
                               explain=exp)

    def candidate_masks(self, users) -> torch.Tensor:
        """(Q, N) bool candidate masks on the retriever's device
        (``gam-device`` only)."""
        if not self.fused:
            raise UnsupportedOp(self.spec.backend, "candidate_masks",
                                "posting lists never materialise dense "
                                "masks; open backend='gam-device'")
        u = torch.as_tensor(users, dtype=torch.float32, device=self.device)
        tau, mask = self._map(u)
        return self.device_index.batch_candidate_mask(
            tau, self.spec.min_overlap, mask)

    # ------------------------------------------------------------ state

    @property
    def n_items(self) -> int:
        return int(self.ids.size)

    def stats(self) -> dict:
        out = super().stats()
        out.update(p=self.spec.cfg.p, device=self.fused,
                   bucket=self.spec.bucket, quantize=self.spec.quantize,
                   compress_postings=self.spec.compress_postings)
        if isinstance(self._csr, CompressedInvertedIndex):
            out["index_bytes"] = self._csr.nbytes
            out["n_patterns"] = self._csr.n_patterns
        if self.device_index is not None:
            out["n_spill"] = int(self.device_index.spill.shape[0])
            meta = self._retrieve_meta
            if meta.quantize == "int8":
                out["factor_bytes"] = (
                    meta.factors_q.numel() * meta.factors_q.element_size()
                    + meta.scales.numel() * meta.scales.element_size())
        return out

    def snapshot(self, path: str) -> None:
        arrays = {"ids": self.ids, "items": self.items,
                  "item_tau": self.item_tau, "item_mask": self.item_mask}
        extra: dict = {}
        if self._scale is not None:
            arrays["scale"] = self._scale
        if not self.fused:
            index_arrays, extra = csr_to_reference(self.index)
            arrays.update(index_arrays)
        elif self.device_index is not None:
            index_arrays, extra = index_to_reference(
                self.device_index, self._retrieve_meta,
                compress_postings=self.spec.compress_postings)
            arrays.update(index_arrays)
        write_snapshot(path, self.spec, arrays, extra)

    def restore(self, path: str) -> "GamIndexRetriever":
        arrays, state = read_snapshot(path, self.spec)
        self._empty()
        if arrays["ids"].size == 0:
            return self
        self.ids = np.asarray(arrays["ids"], np.int64)
        self.items = np.asarray(arrays["items"], np.float32)
        self.item_tau = np.asarray(arrays["item_tau"])
        self.item_mask = np.asarray(arrays["item_mask"], bool)
        self._scale = (np.asarray(arrays["scale"], np.float32)
                       if "scale" in arrays else None)
        self._items_dev = torch.as_tensor(self.items, device=self.device)
        if not self.fused:
            self._csr = csr_from_reference(
                arrays, state, n_items=self.ids.size, p=self.spec.cfg.p,
                k=self.item_tau.shape[1], device=self.device)
            return self
        self.device_index, self._retrieve_meta = index_from_reference(
            arrays, state, self.spec, self.device)
        return self
