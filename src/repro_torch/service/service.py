"""GamService: DEPRECATED facade shim over the unified retriever API.

Counterpart of ``repro.service.service``.  The sharded streaming service
is the ``sharded`` backend (``repro_torch.retriever.sharded``);
``GamService`` maps the old ``(item_ids, factors, cfg, ServiceConfig)``
signature onto a :class:`~repro_torch.retriever.api.RetrieverSpec`, keeps
the historical ``query() -> (ids, scores)`` tuple return, and delegates
everything else (``upsert``/``delete``/``compact``/``batcher``/``metrics``/
``catalog``) to the backend.  New code opens the backend directly::

    from repro_torch.retriever import RetrieverSpec, open_retriever
    r = open_retriever(RetrieverSpec(cfg=cfg, backend="sharded",
                                     n_shards=4, min_overlap=2),
                       items=factors, ids=item_ids)
"""
from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np

__all__ = ["GamService", "ServiceConfig"]


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Legacy knob bundle; the same fields now live flat on RetrieverSpec."""
    n_shards: int = 1
    min_overlap: int = 1
    kappa: int = 10
    bucket: int = 256          # main-segment posting bucket width
    # delta-segment bucket width; None = same as ``bucket`` so the delta
    # never spills before the main segment would (spill-induced extra
    # candidates are what can break exact rebuild parity)
    delta_bucket: int | None = None
    batch_size: int = 8        # microbatch size
    max_delay_s: float = 2e-3  # deadline trigger for short batches


class GamService:
    """DEPRECATED shim — use ``open_retriever(RetrieverSpec(cfg=cfg,
    backend='sharded', ...), items=factors, ids=item_ids)``.  ``device``:
    where the backend runs (``None``: the card)."""

    def __init__(self, item_ids: np.ndarray, factors: np.ndarray,
                 cfg, svc: ServiceConfig = ServiceConfig(), *,
                 mesh=None, clock=time.monotonic, device=None):
        warnings.warn(
            "service.GamService(...) is deprecated; use "
            "repro_torch.retriever.open_retriever(RetrieverSpec(cfg=cfg, "
            "backend='sharded', n_shards=..., min_overlap=..., ...), "
            "items=factors, ids=item_ids) "
            "(see repro_torch.retriever — removed after one release)",
            DeprecationWarning, stacklevel=2)
        from repro_torch.retriever import RetrieverSpec, open_retriever
        self.svc = svc
        spec = RetrieverSpec(
            cfg=cfg, backend="sharded", n_shards=svc.n_shards,
            min_overlap=svc.min_overlap, kappa=svc.kappa, bucket=svc.bucket,
            delta_bucket=svc.delta_bucket, batch_size=svc.batch_size,
            max_delay_s=svc.max_delay_s)
        self._impl = open_retriever(spec, items=factors, ids=item_ids,
                                    mesh=mesh, clock=clock, device=device)

    @property
    def cfg(self):
        return self._impl.spec.cfg

    def query(self, users, kappa: int | None = None, *,
              exact: bool = False) -> tuple[np.ndarray, np.ndarray]:
        res = self._impl.query(users, kappa, exact=exact)
        return res.ids, res.scores

    def __getattr__(self, name):
        if name == "_impl":      # not set yet (e.g. unpickling a bare shell)
            raise AttributeError(name)
        return getattr(self._impl, name)
