"""LSH/tree baseline backends (paper §5.1/§6), build and query only.

Counterpart of ``repro.retriever.baselines``: ``srp-lsh``,
``superbit-lsh``, ``cro`` and ``pca-tree`` wrap the ``core.baselines``
structures behind the retriever contract, on the retriever's device.
``exact=True`` is ``brute``'s answer; ``explain=True``, mutations,
snapshots and candidate masks raise :class:`UnsupportedOp`.  Options ride
in ``spec.options`` and default from the factor dimensionality as in the
reference.

:func:`baseline_from_reference` copies a structure the reference built
(planes or projections and hash tables, or splits and leaves) into the
port's form, so the query path can be held against the reference on
exactly the reference's structure.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.baselines import CroHash, PcaTree, SrpLsh, SuperBitLsh
from repro_torch.device import resolve_device
from repro_torch.retriever.api import Retriever, RetrieverSpec
from repro_torch.retriever.brute import score_all
from repro_torch.retriever.types import RetrievalResult, UnsupportedOp

__all__ = ["BaselineRetriever", "baseline_from_reference"]


def _make(spec: RetrieverSpec, items: torch.Tensor):
    k = items.shape[1]
    opt, dev = spec.opt, items.device
    if spec.backend == "srp-lsh":
        return SrpLsh(items, n_bits=opt("n_bits", max(4, k // 2)),
                      n_tables=opt("n_tables", 4), seed=spec.seed, device=dev)
    if spec.backend == "superbit-lsh":
        return SuperBitLsh(items, n_bits=opt("n_bits", max(4, k // 2)),
                           n_tables=opt("n_tables", 4), seed=spec.seed,
                           device=dev)
    if spec.backend == "cro":
        return CroHash(items, n_proj=opt("n_proj", 2 * k),
                       top_l=opt("top_l", 2), n_tables=opt("n_tables", 4),
                       seed=spec.seed, device=dev)
    if spec.backend == "pca-tree":
        return PcaTree(items, depth=opt(
            "depth", max(3, int(np.log2(max(len(items), 2))) - 4)),
            device=dev)
    raise KeyError(spec.backend)


class BaselineRetriever(Retriever):
    def __init__(self, spec: RetrieverSpec, device: torch.device):
        super().__init__(spec, device)
        self.ids = np.zeros(0, np.int64)
        self.items = np.zeros((0, spec.cfg.k), np.float32)
        self._items_dev = torch.as_tensor(self.items, device=device)
        self._impl = None

    def build(self, items, ids=None) -> "BaselineRetriever":
        items = np.asarray(items, np.float32).reshape(-1, self.spec.cfg.k)
        ids = (np.arange(items.shape[0], dtype=np.int64) if ids is None
               else np.asarray(ids, np.int64).ravel())
        if len(np.unique(ids)) != ids.size:
            raise ValueError("item ids must be unique")
        order = np.argsort(ids)
        self.ids, self.items = ids[order], items[order]
        self._items_dev = torch.as_tensor(self.items, device=self.device)
        self._impl = _make(self.spec, self._items_dev) if ids.size else None
        return self

    def query(self, users, kappa=None, *, exact=False,
              explain=False) -> RetrievalResult:
        if explain:
            raise UnsupportedOp(self.spec.backend, "query",
                                "hash/tree baselines keep no per-shard or "
                                "per-block provenance to explain")
        kappa = self.spec.kappa if kappa is None else int(kappa)
        users = np.asarray(users, np.float32)
        q, n = users.shape[0], self.ids.size
        if n == 0:
            return RetrievalResult(np.full((q, kappa), -1, np.int64),
                                   np.full((q, kappa), -np.inf, np.float32),
                                   np.zeros(q, np.int64), np.zeros(q))
        if exact:
            ids_out, sc_out = score_all(self.ids, self._items_dev, users,
                                        kappa)
            return RetrievalResult(ids_out, sc_out, np.full(q, n, np.int64),
                                   np.zeros(q))
        res = self._impl.query(users, kappa)
        ids = np.where(res.ids >= 0,
                       self.ids[np.clip(res.ids, 0, n - 1)], -1)
        return RetrievalResult(ids=ids, scores=res.scores,
                               n_scored=res.n_scored,
                               discarded_frac=res.discarded_frac)

    @property
    def n_items(self) -> int:
        return int(self.ids.size)


def _hash_codes(tables: list[dict], n: int, pack) -> torch.Tensor:
    """The reference's bucket dicts (code tuple -> item ids) -> item codes
    (n_tables, n) int64, each code packed by ``pack``."""
    codes = np.zeros((len(tables), n), np.int64)
    for t, table in enumerate(tables):
        for code, ids in table.items():
            codes[t, np.asarray(ids, np.int64)] = pack(code)
    return torch.from_numpy(codes)


def baseline_from_reference(impl, *,
                            device: str | torch.device | None = None):
    """A reference ``SrpLsh`` / ``SuperBitLsh`` / ``CroHash`` / ``PcaTree``
    -> the port's structure with the same planes or projections and the same
    hash tables, or the same splits and leaves, on ``device``."""
    dev = resolve_device(device)
    kind = type(impl).__name__
    hashes = {"SrpLsh": SrpLsh, "SuperBitLsh": SuperBitLsh,
              "CroHash": CroHash}
    if kind in hashes:
        out = hashes[kind].__new__(hashes[kind])
        out.device = dev
        out.items = torch.as_tensor(np.asarray(impl.items, np.float32),
                                    device=dev)
        out.n_tables = impl.n_tables
        n = impl.items.shape[0]
        if kind == "CroHash":
            out.n_proj, out.top_l = impl.n_proj, impl.top_l
            out.proj = torch.as_tensor(impl._proj, device=dev)

            def pack(code):
                return sum(int(i) * impl.n_proj ** j
                           for j, i in enumerate(sorted(code)))
        else:
            out.n_bits = impl.n_bits
            out._set_planes(np.asarray(impl._planes, np.float32), dev)

            def pack(code):
                return sum(int(bool(b)) << j for j, b in enumerate(code))
        out._set_tables(_hash_codes(impl.tables, n, pack).to(dev))
        return out
    if kind == "PcaTree":
        return _pca_from_reference(impl, dev)
    raise TypeError(f"not a reference baseline: {kind}")


def _pca_from_reference(impl, dev: torch.device) -> PcaTree:
    """The reference tree's ``_splits`` / ``_leaves`` dicts (keyed by path)
    -> the port's node arrays, nodes numbered level by level."""
    items = np.asarray(impl.items, np.float32)
    k = items.shape[1]
    paths, level, node_of = [()], [()], {(): 0}
    while level:
        nxt = [p + (b,) for p in level if p in impl._splits for b in (0, 1)]
        for p in nxt:
            node_of[p] = len(paths)
            paths.append(p)
        level = nxt
    m = len(paths)
    child = np.full((m, 2), -1, np.int64)
    split_v = np.zeros((m, k), np.float32)
    split_med = np.zeros(m, np.float32)
    leaf_start = np.zeros(m, np.int64)
    leaf_len = np.zeros(m, np.int64)
    leaf_items, n_leaf = [], 0
    for i, p in enumerate(paths):
        if p in impl._splits:
            v, med = impl._splits[p]
            split_v[i], split_med[i] = v, med
            child[i] = node_of[p + (0,)], node_of[p + (1,)]
        else:
            ids = np.asarray(impl._leaves.get(p, ()), np.int64)
            leaf_start[i], leaf_len[i] = n_leaf, ids.size
            leaf_items.append(ids)
            n_leaf += ids.size
    out = PcaTree.__new__(PcaTree)
    out.device = dev
    out.items = torch.as_tensor(items, device=dev)
    out.depth = impl.depth
    out.levels = max(len(p) for p in paths) + 1
    for name, arr in (("child", child), ("split_v", split_v),
                      ("split_med", split_med), ("leaf_start", leaf_start),
                      ("leaf_len", leaf_len),
                      ("leaf_items", np.concatenate(leaf_items))):
        setattr(out, name, torch.as_tensor(arr, device=dev))
    return out
