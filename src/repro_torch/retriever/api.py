"""Spec, protocol and backend registry of the port's retriever API.

Counterpart of ``repro.retriever.api``.  :class:`RetrieverSpec` keeps every
field of the reference, so snapshot headers stay byte-compatible; the device
is an argument of :func:`open_retriever` and of the backend constructors,
not a spec field.  The port serves every single-host backend of the
reference: ``brute``, ``gam`` (the CSR inverted index), ``gam-device`` (the
fused kernel), the ``sharded`` service tier, its multi-host placement
``sharded-multihost`` and the four §5.1 baselines (``srp-lsh``,
``superbit-lsh``, ``cro``, ``pca-tree``).  Third-party backends join
through :func:`register_backend`.
"""
from __future__ import annotations

import abc
import dataclasses
import importlib
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.mapping import GamConfig
from repro_torch.device import resolve_device
from repro_torch.retriever.types import RetrievalResult, UnsupportedOp

__all__ = ["BACKEND_IDS", "Retriever", "RetrieverSpec", "available_backends",
           "open_retriever", "register_backend"]


@dataclasses.dataclass(frozen=True)
class RetrieverSpec:
    """Everything needed to (re)construct a retriever, in one frozen value.

    The same fields as the reference spec; backends read the ones they
    understand (``bn``/``bq`` tile the fused kernel of ``gam-device``)."""

    cfg: GamConfig
    backend: str = "gam"          # key into the backend registry
    min_overlap: int = 1          # candidate = pattern overlap >= this
    kappa: int = 10               # default top-kappa when query() gets None
    bucket: int = 256             # posting-table bucket width
    whiten: bool = False          # per-coordinate 1/std rescale before phi
    n_shards: int = 1             # item-axis shards (sharded backend)
    n_hosts: int = 1              # host processes (sharded-multihost backend)
    replication: int = 1          # replicas per placement slice (multihost)
    delta_bucket: int | None = None   # delta-segment bucket (None = bucket)
    batch_size: int = 8           # microbatch size
    max_delay_s: float = 2e-3     # microbatch deadline trigger
    bn: int | None = None         # fused-kernel item-block width (None=auto)
    bq: int = 32                  # fused-kernel query-block height
    seed: int = 0                 # randomised backends (LSH baselines)
    compress_postings: bool = False   # delta+group-varint posting storage
    quantize: str = "none"        # item-factor slab dtype: "none" | "int8"
    rerank_factor: int = 4        # exact-rerank pool = kappa * this (int8)
    cache_capacity: int = 0       # hot-query result cache rows (0 = off)
    cache_ttl_s: float | None = None  # optional cache entry age-out
    options: tuple[tuple[str, Any], ...] = ()   # backend-specific extras

    def opt(self, name: str, default: Any = None) -> Any:
        for key, val in self.options:
            if key == name:
                return val
        return default


class Retriever(abc.ABC):
    """The lifecycle contract every backend implements; operations a backend
    cannot honour raise :class:`UnsupportedOp`."""

    def __init__(self, spec: RetrieverSpec, device: torch.device):
        self.spec = spec
        self.device = device

    @abc.abstractmethod
    def build(self, items: np.ndarray,
              ids: np.ndarray | None = None) -> "Retriever":
        """(Re)build from an (N, k) factor matrix (+ optional catalog ids)."""

    def upsert(self, ids, factors) -> None:
        raise UnsupportedOp(self.spec.backend, "upsert")

    def delete(self, ids) -> None:
        raise UnsupportedOp(self.spec.backend, "delete")

    def compact(self, async_: bool = False) -> None:
        raise UnsupportedOp(self.spec.backend, "compact")

    @abc.abstractmethod
    def query(self, users: np.ndarray, kappa: int | None = None, *,
              exact: bool = False, explain: bool = False) -> RetrievalResult:
        """(Q, k) user factors -> :class:`RetrievalResult` in catalog-id
        space, under the total order (score desc, id asc)."""

    def candidate_masks(self, users) -> Any:
        raise UnsupportedOp(self.spec.backend, "candidate_masks")

    @property
    @abc.abstractmethod
    def n_items(self) -> int:
        """Live catalog size."""

    def stats(self) -> dict:
        return {"backend": self.spec.backend, "n_items": self.n_items}

    def maintenance_stats(self) -> dict:
        """The serving generation and the in-flight compaction /
        repartition state; backends without background maintenance report
        the quiescent default."""
        return {"backend": self.spec.backend,
                "generation": getattr(self, "generation", 0),
                "compaction": {"active": False},
                "repartition": {"n_repartitions": 0}}

    def snapshot(self, path: str) -> None:
        raise UnsupportedOp(self.spec.backend, "snapshot")

    def restore(self, path: str) -> "Retriever":
        raise UnsupportedOp(self.spec.backend, "restore")


_MODULES: dict[str, tuple[str, str]] = {
    "brute": ("repro_torch.retriever.brute", "BruteRetriever"),
    "gam": ("repro_torch.retriever.gam", "GamIndexRetriever"),
    "gam-device": ("repro_torch.retriever.gam", "GamIndexRetriever"),
    "sharded": ("repro_torch.retriever.sharded", "ShardedRetriever"),
    "sharded-multihost": ("repro_torch.retriever.multihost",
                          "MultiHostShardedRetriever"),
    "srp-lsh": ("repro_torch.retriever.baselines", "BaselineRetriever"),
    "superbit-lsh": ("repro_torch.retriever.baselines", "BaselineRetriever"),
    "cro": ("repro_torch.retriever.baselines", "BaselineRetriever"),
    "pca-tree": ("repro_torch.retriever.baselines", "BaselineRetriever"),
}

BACKEND_IDS = tuple(_MODULES)

_REGISTRY: dict[str, Callable[..., Retriever]] = {}


def register_backend(name: str,
                     factory: Callable[..., Retriever] | None = None):
    """Register a factory ``f(spec, device=..., **kw) -> Retriever`` under
    ``name`` (usable as a decorator)."""
    def _register(f):
        _REGISTRY[name] = f
        return f
    return _register(factory) if factory is not None else _register


def available_backends() -> tuple[str, ...]:
    return tuple(dict.fromkeys((*_MODULES, *_REGISTRY)))


def _resolve(name: str):
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name not in _MODULES:
        raise KeyError(f"unknown retriever backend {name!r}; "
                       f"known: {sorted(available_backends())}")
    module, cls = _MODULES[name]
    return getattr(importlib.import_module(module), cls)


def open_retriever(spec: RetrieverSpec, items: np.ndarray | None = None,
                   ids: np.ndarray | None = None, *,
                   snapshot: str | None = None,
                   device: str | torch.device | None = None,
                   **backend_kw) -> Retriever:
    """Resolve ``spec.backend`` and open a retriever on ``device`` (default
    ``cuda``; raises when no card is present).  With ``items`` the catalog
    is built, with ``snapshot`` restored, with neither left empty.  Extra
    keyword arguments go to the backend (``sharded`` and
    ``sharded-multihost``: ``clock``, ``tracer``, ``qos``, ``faults``, and
    ``mesh``, an ``items`` mesh to place the index over; ``sharded-
    multihost`` checks it and places by host instead).  Inside a
    ``torch.distributed`` process group the card is this process's current
    CUDA device, which
    ``launch.procs.init_process_group`` sets to ``rank % device_count``."""
    if items is not None and snapshot is not None:
        raise ValueError("pass either items or snapshot, not both")
    cls = _resolve(spec.backend)
    retriever = cls(spec, device=resolve_device(device), **backend_kw)
    if snapshot is not None:
        return retriever.restore(snapshot)
    if items is not None:
        return retriever.build(items, ids)
    return retriever
