"""The port's retriever API: one spec, one lifecycle, pluggable backends.

Counterpart of ``repro.retriever``: ``brute`` (every item scored), ``gam``
(the paper's CSR inverted index, flat or pattern-factored and
varint-coded), ``gam-device`` (the fused ``gam_retrieve`` kernel),
``sharded`` (the streaming service tier) and the §5.1 baselines
``srp-lsh`` / ``superbit-lsh`` / ``cro`` / ``pca-tree`` (build and query
only).  Results are :class:`RetrievalResult` in catalog-id space with the
total order (score desc, id asc), and ``open_retriever`` runs on the GPU
unless it is given ``device="cpu"``.  Third-party structures join through
:func:`register_backend`.
"""
from repro_torch.retriever.api import (BACKEND_IDS, Retriever, RetrieverSpec,
                                       available_backends, open_retriever,
                                       register_backend)
from repro_torch.retriever.types import RetrievalResult, UnsupportedOp

__all__ = ["BACKEND_IDS", "RetrievalResult", "Retriever", "RetrieverSpec",
           "UnsupportedOp", "available_backends", "open_retriever",
           "register_backend"]
