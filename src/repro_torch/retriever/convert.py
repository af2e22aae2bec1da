"""Carry index state between the reference and the port, both ways.

``gam``: :func:`csr_from_reference` / :func:`csr_to_reference` turn the
reference's snapshot arrays of the CSR inverted index into the port's
index on a device and back: a flat index is ``postings`` (int32) and
``offsets`` (int64); a compressed one is the two varint streams
``sp_data``/``sp_counts`` (slot -> patterns) and ``pi_data``/``pi_counts``
(pattern -> items) with their value counts in the ``codec`` state entry.

``gam-device``: the reference keeps pattern bitsets as ``uint32``; the port
holds the same bits as ``int32`` tensors (torch has no shifts or popcount
on ``uint32`` on the CPU). :func:`index_from_reference` turns the
reference's index state, as ``repro``'s ``GamIndexRetriever.snapshot``
writes it, into the port's; :func:`index_to_reference` is the inverse, so
``repro`` restores the files the port writes. Every other array keeps its
dtype.

Compressed catalogs: a posting table stored as a delta + group-varint CSR
(``table_data``/``table_counts`` with a ``codec`` state entry) is
re-densified bit-identically; an int8 slab (``factors_q``/``scales``) is
loaded as written, and a file whose meta says int8 but holds no slab is
re-quantized from its ``items``, as the reference does.

``sharded`` and ``sharded-multihost``: both packages write the same
snapshot file, so a file crosses as it is.  A multi-host file (format v3
and later) also carries its placement in the ``placement`` state entry
(``HostPlacement.describe()``), which :func:`placement_from_state` reads.
It records where the writer served each slice; it is not an input: a
restore re-derives the placement from the opening spec and the restored
partition, as the reference does, so a file rehosts onto any host count
and a ``sharded`` file scales out.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.compress.postings import (CompressedPostings,
                                           decode_postings, encode_postings)
from repro_torch.core.inverted_index import (CompressedInvertedIndex,
                                             DeviceIndex, InvertedIndex,
                                             csr_to_table, table_to_csr)
from repro_torch.kernels.gam_retrieve import RetrievalMeta, quantize_meta
from repro_torch.retriever.api import RetrieverSpec
from repro_torch.service.collective import HostPlacement

__all__ = ["csr_from_reference", "csr_to_reference", "index_from_reference",
           "index_to_reference", "placement_from_state"]


def csr_from_reference(arrays: dict, state: dict, *, n_items: int, p: int,
                       k: int, device: str | torch.device
                       ) -> InvertedIndex | CompressedInvertedIndex:
    """The reference's ``gam`` index arrays + snapshot state -> the port's
    flat or compressed index on ``device``."""
    if "sp_data" in arrays:
        codec = state["codec"]

        def stream(name):
            return CompressedPostings(
                np.asarray(arrays[f"{name}_data"], np.uint8),
                np.asarray(arrays[f"{name}_counts"], np.int32),
                int(codec[f"{name}_n"]))

        return CompressedInvertedIndex(stream("sp"), stream("pi"),
                                       n_items=n_items, p=p, k=k,
                                       device=device)
    return InvertedIndex.from_csr(np.asarray(arrays["postings"], np.int32),
                                  np.asarray(arrays["offsets"], np.int64),
                                  n_items=n_items, p=p, k=k, device=device)


def csr_to_reference(index: InvertedIndex | CompressedInvertedIndex
                     ) -> tuple[dict[str, np.ndarray], dict]:
    """The port's ``gam`` index -> (arrays, state) in the reference's
    snapshot layout."""
    if isinstance(index, CompressedInvertedIndex):
        sp, pi = index.slot_patterns, index.pattern_items
        return ({"sp_data": sp.data, "sp_counts": sp.counts,
                 "pi_data": pi.data, "pi_counts": pi.counts},
                {"codec": {"sp_n": int(sp.n_values),
                           "pi_n": int(pi.n_values)}})
    return ({"postings": index.postings.cpu().numpy(),
             "offsets": index.offsets.cpu().numpy()}, {})


def _bits(arr) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(arr, np.uint32)).view(np.int32)


def index_from_reference(arrays: dict, state: dict, spec: RetrieverSpec,
                         device: str | torch.device
                         ) -> tuple[DeviceIndex, RetrievalMeta]:
    """Reference index arrays + snapshot state -> the port's
    (:class:`DeviceIndex`, :class:`RetrievalMeta`) on ``device``."""
    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    n_items = int(np.asarray(arrays["ids"]).size)
    if "table_data" in arrays:
        codec = state["codec"]
        cp = CompressedPostings(np.asarray(arrays["table_data"], np.uint8),
                                np.asarray(arrays["table_counts"], np.int32),
                                int(codec["table_n"]))
        table, counts = csr_to_table(*decode_postings(cp),
                                     int(codec["bucket"]), sentinel=n_items)
    else:
        table, counts = arrays["table"], arrays["counts"]
    index = DeviceIndex(table=dev(np.asarray(table, np.int32)),
                        counts=dev(np.asarray(counts, np.int32)),
                        spill=dev(np.asarray(arrays["spill"], np.int32)),
                        n_items=n_items, p=spec.cfg.p)
    meta = state["meta"]
    rmeta = RetrievalMeta(
        item_bits_t=dev(_bits(arrays["item_bits_t"])),
        block_union=dev(_bits(arrays["block_union"])),
        block_spill=dev(np.asarray(arrays["block_spill"], bool)),
        spill8=dev(np.asarray(arrays["spill8"], np.int8)),
        p=spec.cfg.p, words=int(meta["words"]), bn=int(meta["bn"]),
        n_rows=int(meta["n_rows"]), n_pad=int(meta["n_pad"]))
    if meta.get("quantize", "none") == "int8":
        if "factors_q" in arrays:
            rmeta = dataclasses.replace(
                rmeta, quantize="int8",
                factors_q=dev(np.asarray(arrays["factors_q"], np.int8)),
                scales=dev(np.asarray(arrays["scales"], np.float32)))
        else:       # a file written before slabs were persisted
            rmeta = quantize_meta(rmeta, np.asarray(arrays["items"],
                                                    np.float32))
    return index, rmeta


def index_to_reference(index: DeviceIndex, meta: RetrievalMeta, *,
                       compress_postings: bool = False
                       ) -> tuple[dict[str, np.ndarray], dict]:
    """The port's index -> (arrays, state) in the reference's layout; with
    ``compress_postings`` the table is written as a varint CSR."""
    def host(t):
        return t.detach().cpu().numpy()

    arrays: dict[str, np.ndarray] = {}
    state: dict = {}
    table, counts = host(index.table), host(index.counts)
    if compress_postings:
        cp = encode_postings(*table_to_csr(table, counts))
        arrays.update(table_data=cp.data, table_counts=cp.counts)
        state["codec"] = {"table_n": int(cp.n_values),
                          "bucket": int(table.shape[1])}
    else:
        arrays.update(table=table, counts=counts)
    arrays.update(
        spill=host(index.spill),
        item_bits_t=host(meta.item_bits_t).view(np.uint32),
        block_union=host(meta.block_union).view(np.uint32),
        block_spill=host(meta.block_spill),
        spill8=host(meta.spill8))
    if meta.quantize == "int8":
        arrays.update(factors_q=host(meta.factors_q),
                      scales=host(meta.scales))
    state["meta"] = {"bn": meta.bn, "words": meta.words,
                     "n_rows": meta.n_rows, "n_pad": meta.n_pad,
                     "quantize": meta.quantize}
    return arrays, state


def placement_from_state(state: dict) -> HostPlacement | None:
    """The placement a multi-host snapshot's writer served (None for a file
    written by a single-host backend)."""
    d = state.get("placement")
    if d is None:
        return None
    return HostPlacement(int(d["n_hosts"]), int(d["replication"]),
                         tuple(tuple(int(x) for x in s) for s in d["slices"]),
                         tuple(tuple(int(x) for x in r)
                               for r in d["replicas"]))
