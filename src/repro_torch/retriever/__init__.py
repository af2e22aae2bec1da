"""The port's retriever API: one spec, one lifecycle, pluggable backends.

Counterpart of ``repro.retriever``.  The port serves ``brute``,
``gam-device`` and ``sharded``; results are :class:`RetrievalResult` in
catalog-id space with the total order (score desc, id asc), and
``open_retriever`` runs on the GPU unless it is given ``device="cpu"``.
"""
from repro_torch.retriever.api import (BACKEND_IDS, Retriever, RetrieverSpec,
                                       open_retriever)
from repro_torch.retriever.types import RetrievalResult, UnsupportedOp

__all__ = ["BACKEND_IDS", "RetrievalResult", "Retriever", "RetrieverSpec",
           "UnsupportedOp", "open_retriever"]
