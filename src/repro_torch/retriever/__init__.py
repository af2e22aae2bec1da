"""The port's retriever API: one spec, one lifecycle, pluggable backends.

Counterpart of ``repro.retriever``: ``brute`` (every item scored), ``gam``
(the paper's CSR inverted index, flat or pattern-factored and
varint-coded), ``gam-device`` (the fused ``gam_retrieve`` kernel),
``sharded`` (the streaming service tier), ``sharded-multihost`` (that
tier placed over host processes of a ``torch.distributed`` group) and the
§5.1 baselines ``srp-lsh`` / ``superbit-lsh`` / ``cro`` / ``pca-tree``
(build and query only).  Results are :class:`RetrievalResult` in
catalog-id space with the total order (score desc, id asc), and
``open_retriever`` runs on the GPU unless it is given ``device="cpu"``.
Third-party structures join through :func:`register_backend`.
"""
from repro_torch.retriever.api import (BACKEND_IDS, Retriever, RetrieverSpec,
                                       available_backends, open_retriever,
                                       register_backend)
from repro_torch.retriever.types import RetrievalResult, UnsupportedOp

__all__ = ["BACKEND_IDS", "BaselineRetriever", "BruteRetriever",
           "GamIndexRetriever", "MultiHostShardedRetriever",
           "RetrievalResult", "Retriever", "RetrieverSpec",
           "ShardedRetriever", "UnsupportedOp", "available_backends",
           "open_retriever", "register_backend"]

_LAZY_CLASSES = {
    "BruteRetriever": "repro_torch.retriever.brute",
    "GamIndexRetriever": "repro_torch.retriever.gam",
    "ShardedRetriever": "repro_torch.retriever.sharded",
    "MultiHostShardedRetriever": "repro_torch.retriever.multihost",
    "BaselineRetriever": "repro_torch.retriever.baselines",
}


def __getattr__(name: str):
    # backend classes resolve lazily (PEP 562), as the reference's do: the
    # API surface imports no kernel module or service tier
    if name in _LAZY_CLASSES:
        import importlib
        return getattr(importlib.import_module(_LAZY_CLASSES[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
