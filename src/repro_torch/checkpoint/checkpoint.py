"""Flat array snapshots: ``np.savez`` files with a JSON ``__meta__`` header.

Counterpart of ``save_arrays``/``load_arrays`` in
``repro.checkpoint.checkpoint``, with the same layout, so each package reads
the other's files: arrays are stored as ``a0, a1, ...`` and the header holds
their names, dtypes and the caller's ``extra`` dict.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

__all__ = ["load_arrays", "save_arrays"]


def _host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_arrays(path: str, arrays: dict, extra: dict | None = None) -> None:
    """Write ``arrays`` (name -> numpy array or tensor) and ``extra`` (JSON)
    atomically to ``path``."""
    out = {}
    meta: dict = {"keys": [], "dtypes": [], "extra": extra or {}}
    for i, (name, leaf) in enumerate(arrays.items()):
        arr = _host(leaf)
        meta["keys"].append(name)
        meta["dtypes"].append(str(arr.dtype))
        out[f"a{i}"] = arr
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=np.frombuffer(json.dumps(meta).encode(),
                                           dtype=np.uint8), **out)
    os.replace(tmp, path)


def load_arrays(path: str) -> tuple[dict[str, np.ndarray], dict]:
    """Read a :func:`save_arrays` file -> (name -> numpy array, extra)."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        arrays = {}
        for i, (name, dt) in enumerate(zip(meta["keys"], meta["dtypes"])):
            if dt == "bfloat16":
                raise ValueError(f"{path}: array {name!r} is bfloat16, which "
                                 "retriever snapshots never hold")
            arrays[name] = data[f"a{i}"]
    return arrays, meta.get("extra", {})
