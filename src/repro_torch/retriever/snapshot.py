"""Snapshot plumbing of the port's retriever backends.

Counterpart of ``repro.retriever.snapshot``, at the same format (v4) and
reading v2, v3 and v4 exactly as the reference does: one
``checkpoint.save_arrays`` file whose JSON header pins the format, the
mapping schema and the spec's result-bearing fields.  A file written under
another backend or schema is refused loudly.
"""
from __future__ import annotations

import numpy as np

from repro_torch.checkpoint import load_arrays, save_arrays
from repro_torch.core.mapping import GamConfig
from repro_torch.retriever.api import RetrieverSpec

__all__ = ["SNAPSHOT_FORMAT", "read_snapshot", "write_snapshot"]

SNAPSHOT_FORMAT = "repro.retriever/v4"
_READ_COMPAT = (SNAPSHOT_FORMAT, "repro.retriever/v3", "repro.retriever/v2")

# spec fields that change query RESULTS; compress_postings is storage-only
_RESULT_FIELDS = ("backend", "min_overlap", "bucket", "whiten",
                  "delta_bucket", "quantize", "rerank_factor")

# defaults filled when reading pre-v4 headers that predate a result field
_FIELD_DEFAULTS = {"quantize": "none", "rerank_factor": 4}

# a ``sharded`` file may scale out into ``sharded-multihost``
_BACKEND_UPGRADES = {"sharded-multihost": ("sharded",)}


def _cfg_meta(cfg: GamConfig) -> dict:
    return {"k": cfg.k, "scheme": cfg.scheme, "d": cfg.d,
            "threshold": cfg.threshold}


def write_snapshot(path: str, spec: RetrieverSpec,
                   arrays: dict[str, np.ndarray],
                   extra: dict | None = None) -> None:
    header = {
        "format": SNAPSHOT_FORMAT,
        "cfg": _cfg_meta(spec.cfg),
        "spec": {f: getattr(spec, f) for f in _RESULT_FIELDS},
        "state": extra or {},
    }
    save_arrays(path, arrays, header)


def read_snapshot(path: str, spec: RetrieverSpec
                  ) -> tuple[dict[str, np.ndarray], dict]:
    """Load + validate a snapshot against the opening spec -> (arrays,
    backend state dict)."""
    arrays, header = load_arrays(path)
    if header.get("format") not in _READ_COMPAT:
        raise ValueError(f"{path}: not a readable retriever snapshot "
                         f"(format={header.get('format')!r}, "
                         f"readers accept {list(_READ_COMPAT)})")
    if header["cfg"] != _cfg_meta(spec.cfg):
        raise ValueError(
            f"{path}: snapshot mapping schema {header['cfg']} does not match "
            f"spec cfg {_cfg_meta(spec.cfg)}")
    saved = dict(header["spec"])
    for field, default in _FIELD_DEFAULTS.items():
        saved.setdefault(field, default)      # pre-v4 headers
    mine = {f: getattr(spec, f) for f in _RESULT_FIELDS}
    if saved["backend"] in _BACKEND_UPGRADES.get(spec.backend, ()):
        saved["backend"] = spec.backend
    if saved != mine:
        diff = {f: (saved[f], mine[f]) for f in _RESULT_FIELDS
                if saved[f] != mine[f]}
        raise ValueError(f"{path}: snapshot/spec mismatch (saved, spec): "
                         f"{diff}")
    return arrays, header.get("state", {})
