"""Checkpoints: ``np.savez`` files with a JSON ``__meta__`` header.

Counterpart of ``repro.checkpoint.checkpoint``, with the same layout, so each
package reads the other's files: arrays are stored as ``a0, a1, ...`` and the
header holds their keys and dtypes.

* ``save_checkpoint`` / ``restore_checkpoint`` / ``tree_paths``: a tree of
  tensors (nested dicts, lists, tuples and NamedTuples such as
  ``AdamWState``) flattened as ``jax.tree_util.tree_flatten_with_path``
  flattens it: dict keys sorted, ``None`` no leaf.  A leaf's key is its
  ``keystr``: ``['blocks']['attn']['wq']``, ``.mu`` for a NamedTuple field,
  ``[0]`` for a sequence index.  bf16 leaves are stored as their ``uint16``
  bits with ``"bfloat16"`` in the header's dtypes; the header also holds
  ``step``.  Restore takes a donor tree, refuses any other key list, and
  gives each leaf the donor leaf's dtype and device (and a DTensor donor's
  placements).  A tree of DTensors saves to the file its whole tree gives.
* ``save_arrays`` / ``load_arrays``: flat name -> array snapshots (the
  retriever's catalog), with the caller's ``extra`` dict in the header.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

__all__ = ["load_arrays", "restore_checkpoint", "save_arrays",
           "save_checkpoint", "tree_flatten_with_path", "tree_paths",
           "tree_unflatten"]


def _whole(leaf):
    """A DTensor leaf as its whole tensor (a collective: every rank calls
    it); any other leaf as it is."""
    if hasattr(leaf, "full_tensor"):
        return leaf.full_tensor()
    return leaf


def _host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def tree_flatten_with_path(tree, path: str = "", is_leaf=None) -> list:
    """(keystr, leaf) pairs in ``jax.tree_util``'s order; ``is_leaf(x)``
    true stops the descent at ``x``."""
    if tree is None:
        return []
    if is_leaf is not None and is_leaf(tree):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in tree_flatten_with_path(
            tree[k], f"{path}[{k!r}]", is_leaf)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for name in tree._fields for kv in tree_flatten_with_path(
            getattr(tree, name), f"{path}.{name}", is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in tree_flatten_with_path(v, f"{path}[{i}]", is_leaf)]
    return [(path, tree)]


def tree_unflatten(like, leaves):
    """``like``'s structure with its leaves taken in turn from the iterator
    ``leaves`` (in :func:`tree_flatten_with_path`'s order)."""
    if like is None:
        return None
    if isinstance(like, dict):
        built = {k: tree_unflatten(like[k], leaves) for k in sorted(like)}
        return {k: built[k] for k in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(tree_unflatten(getattr(like, n), leaves)
                            for n in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(tree_unflatten(v, leaves) for v in like)
    return next(leaves)


def tree_paths(tree) -> list[str]:
    """The ``keystr`` of every leaf, in ``jax.tree_util``'s order."""
    return [path for path, _ in tree_flatten_with_path(tree)]


def _savez(path: str, meta: dict, arrays: dict) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, __meta__=np.frombuffer(json.dumps(meta).encode(),
                                           dtype=np.uint8), **arrays)
    os.replace(tmp, path)


def save_checkpoint(path: str, tree, step: int | None = None) -> None:
    """Write every leaf of ``tree`` (tensors, arrays or numbers) and
    ``step`` atomically to ``path``.  DTensor leaves (a tree placed on a
    device mesh) are gathered one at a time into the same file the whole
    tree gives; every rank calls it, rank 0 writes and the others wait."""
    arrays = {}
    meta: dict = {"keys": [], "step": None if step is None else int(step),
                  "dtypes": []}
    placed = False
    for i, (key, leaf) in enumerate(tree_flatten_with_path(tree)):
        placed |= hasattr(leaf, "full_tensor")
        leaf = _whole(leaf)
        if torch.is_tensor(leaf) and leaf.dtype == torch.bfloat16:
            arr, dt = _host(leaf.view(torch.int16)).view(np.uint16), \
                "bfloat16"
        else:
            arr = _host(leaf)
            dt = str(arr.dtype)
        meta["keys"].append(key)
        meta["dtypes"].append(dt)
        arrays[f"a{i}"] = arr
    if not placed:
        _savez(path, meta, arrays)
        return
    import torch.distributed as dist
    if dist.get_rank() == 0:
        _savez(path, meta, arrays)
    dist.barrier()


def restore_checkpoint(path: str, like) -> tuple:
    """Restore into the structure of ``like`` (a tree of tensors) -> (tree,
    step).  Each leaf takes the dtype and device of ``like``'s leaf at its
    key, and a DTensor donor leaf's mesh and placements (each rank keeps
    its own block of the file's array); raises ``ValueError`` when the
    saved keys are not ``like``'s."""
    flat_like = tree_flatten_with_path(like)
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        like_keys = [key for key, _ in flat_like]
        if meta["keys"] != like_keys:
            raise ValueError(
                f"checkpoint structure mismatch:\n saved={meta['keys'][:5]}"
                f"...\n expected={like_keys[:5]}...")
        leaves = []
        for i, (_, ref) in enumerate(flat_like):
            arr = data[f"a{i}"]
            if meta["dtypes"][i] == "bfloat16":
                leaf = torch.from_numpy(arr.view(np.int16)).view(
                    torch.bfloat16)
            else:
                leaf = torch.from_numpy(np.array(arr))
            leaves.append(_like(leaf, ref))
    return tree_unflatten(like, iter(leaves)), meta.get("step")


def _like(leaf: torch.Tensor, ref) -> torch.Tensor:
    """``leaf`` (whole, on the host) with ``ref``'s dtype and device, and
    for a DTensor ``ref`` its placements: this rank's block of ``leaf``."""
    if not hasattr(ref, "device_mesh"):
        return leaf.to(device=ref.device, dtype=ref.dtype)
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.specs import local_block
    mesh, pl = ref.device_mesh, ref.placements
    block = local_block(leaf, mesh, pl).to(
        device=ref.to_local().device, dtype=ref.dtype)
    return DTensor.from_local(block, mesh, pl, run_check=False)


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
    _savez(path, meta, out)


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
