"""Carry ``gam-device`` index state between the reference and the port.

The reference keeps pattern bitsets as ``uint32``; the port holds the same
bits as ``int32`` tensors (torch has no shifts or popcount on ``uint32`` on
the CPU).  :func:`index_from_reference` turns the reference's index state,
as ``repro``'s ``GamIndexRetriever.snapshot`` writes it, into the port's;
:func:`index_to_reference` is the inverse, so ``repro`` restores the files
the port writes.  Every other array keeps its dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.inverted_index import DeviceIndex
from repro_torch.kernels.gam_retrieve import RetrievalMeta
from repro_torch.retriever.api import RetrieverSpec
from repro_torch.retriever.types import UnsupportedOp

__all__ = ["index_from_reference", "index_to_reference"]

_LATER = "the compressed-catalog slice of the port (ROADMAP queue 1)"


def _bits(arr) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(arr, np.uint32)).view(np.int32)


def index_from_reference(arrays: dict, state: dict, spec: RetrieverSpec,
                         device: str | torch.device
                         ) -> tuple[DeviceIndex, RetrievalMeta]:
    """Reference index arrays + snapshot state -> the port's
    (:class:`DeviceIndex`, :class:`RetrievalMeta`) on ``device``."""
    if "table_data" in arrays:
        raise UnsupportedOp(spec.backend, "restore",
                            f"varint-compressed posting tables come with {_LATER}")
    meta = state["meta"]
    if meta.get("quantize", "none") != "none":
        raise UnsupportedOp(spec.backend, "restore",
                            f"int8 factor slabs come with {_LATER}")

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    n_items = int(np.asarray(arrays["ids"]).size)
    index = DeviceIndex(table=dev(np.asarray(arrays["table"], np.int32)),
                        counts=dev(np.asarray(arrays["counts"], np.int32)),
                        spill=dev(np.asarray(arrays["spill"], np.int32)),
                        n_items=n_items, p=spec.cfg.p)
    rmeta = RetrievalMeta(
        item_bits_t=dev(_bits(arrays["item_bits_t"])),
        block_union=dev(_bits(arrays["block_union"])),
        block_spill=dev(np.asarray(arrays["block_spill"], bool)),
        spill8=dev(np.asarray(arrays["spill8"], np.int8)),
        p=spec.cfg.p, words=int(meta["words"]), bn=int(meta["bn"]),
        n_rows=int(meta["n_rows"]), n_pad=int(meta["n_pad"]))
    return index, rmeta


def index_to_reference(index: DeviceIndex, meta: RetrievalMeta
                       ) -> tuple[dict[str, np.ndarray], dict]:
    """The port's index -> (arrays, state) in the reference's layout."""
    def host(t):
        return t.detach().cpu().numpy()

    arrays = {
        "table": host(index.table), "counts": host(index.counts),
        "spill": host(index.spill),
        "item_bits_t": host(meta.item_bits_t).view(np.uint32),
        "block_union": host(meta.block_union).view(np.uint32),
        "block_spill": host(meta.block_spill),
        "spill8": host(meta.spill8),
    }
    state = {"meta": {"bn": meta.bn, "words": meta.words,
                      "n_rows": meta.n_rows, "n_pad": meta.n_pad,
                      "quantize": "none"}}
    return arrays, state
