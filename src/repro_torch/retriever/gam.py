"""``gam-device`` backend: the paper's deployment object on a torch device.

Counterpart of ``repro.retriever.gam`` for ``gam-device``.  Item factors
are mapped with phi once (the ``tess_project`` kernel on the card), the
patterns are indexed in a dense-bucket :class:`DeviceIndex` and packed into
bitsets and block unions, and ``query`` answers top-kappa MIPS with one call
of the fused ``gam_retrieve`` kernel: candidate overlap from the bitsets,
zero-candidate blocks skipped, exact f32 scores of candidates only.
Mutations rebuild in O(N), as in the reference.

The compressed catalog: ``quantize="int8"`` quantizes the item factors into
a per-block-scaled int8 slab on the retriever's device, which the int8
kernel scores; its pool of ``kappa * rerank_factor`` rows is re-ranked
against the exact f32 rows.  ``compress_postings`` is storage-only here:
snapshots hold the posting table as a delta + group-varint CSR.  The CPU
``gam`` backend comes with a later slice.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.inverted_index import DeviceIndex
from repro_torch.core.mapping import sparse_map
from repro_torch.kernels.gam_retrieve import (RetrievalMeta,
                                              build_retrieval_meta,
                                              expand_tile_skips)
from repro_torch.kernels.gam_score import NEG
from repro_torch.kernels.ops import gam_retrieve
from repro_torch.retriever.api import Retriever, RetrieverSpec
from repro_torch.retriever.convert import (index_from_reference,
                                           index_to_reference)
from repro_torch.retriever.snapshot import read_snapshot, write_snapshot
from repro_torch.retriever.types import (RetrievalResult, UnsupportedOp,
                                         dedupe_last_write)

__all__ = ["GamIndexRetriever"]

class GamIndexRetriever(Retriever):
    """phi-map + dense-bucket index + fused candidate-only scoring."""

    def __init__(self, spec: RetrieverSpec, device: torch.device):
        if spec.backend != "gam-device":
            raise UnsupportedOp(spec.backend, "open_retriever",
                                "this slice of the port serves 'gam-device'")
        super().__init__(spec, device)
        self._empty()

    def _empty(self) -> None:
        k = self.spec.cfg.k
        self.ids = np.zeros(0, np.int64)
        self.items = np.zeros((0, k), np.float32)
        self.item_tau = np.zeros((0, k), np.int32)
        self.item_mask = np.zeros((0, k), bool)
        self._scale: np.ndarray | None = None
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

    def candidate_masks(self, users) -> torch.Tensor:
        """(Q, N) bool candidate masks on the retriever's device."""
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
        out.update(p=self.spec.cfg.p, device=True,
                   bucket=self.spec.bucket, quantize=self.spec.quantize,
                   compress_postings=self.spec.compress_postings)
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
        if self.device_index is not None:
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
        self.device_index, self._retrieve_meta = index_from_reference(
            arrays, state, self.spec, self.device)
        self._items_dev = torch.as_tensor(self.items, device=self.device)
        return self
