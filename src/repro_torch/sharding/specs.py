"""Path-regex -> partition specs for parameters, optimizer states, batches,
KV caches and the retrieval index; specs -> DTensor placements.

Counterpart of ``repro.sharding.specs`` (megatron-style 2D: data x model,
plus pod for multi-pod):

  * attention head / FFN hidden / expert / vocab dims shard on ``model``;
  * batch shards on ("pod", "data");
  * batch-1 long-context decode shards the cache sequence dim on ``data``
    (sequence parallelism) instead of the batch dim.

A *spec* is a tuple with one entry per tensor dim: ``None``, an axis name,
or a tuple of axis names (the counterpart of ``PartitionSpec``).  Trees are
the port's nested dicts, flattened as ``checkpoint.tree_paths`` flattens
them, so the rules match the same ``keystr`` paths (``['blocks']['wq']``)
the reference's do.  The spec functions read only a mesh's axis names and
sizes, so they take a ``DeviceMesh`` or a shape-only
:class:`~repro_torch.launch.mesh.MeshShape`.

:func:`named` turns specs into :class:`NamedSharding` leaves, sanitized
against the shapes as the reference's are: an axis that does not divide its
dim is dropped (that dim replicates).  A sharding's ``placements`` hold one
DTensor placement per MESH dim: ``Shard(d)`` for the mesh axis that names
tensor dim ``d``, else ``Replicate()``.  A dim named by two axes, as in
``("pod", "data")``, splits major-to-minor in mesh order, as JAX lays it
out.  :func:`place` puts a tree that every rank holds whole onto the mesh:
each rank keeps its own block (``DTensor.from_local``), with no
communication.
"""
from __future__ import annotations

import dataclasses
import re

import torch

from repro_torch.checkpoint.checkpoint import (tree_flatten_with_path,
                                               tree_unflatten)
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import data_axes, mesh_axes

__all__ = ["param_specs", "param_shardings", "batch_specs", "cache_specs",
           "named", "index_shardings", "fsdp_specs", "NamedSharding",
           "local_block", "place"]


def _rep(nd: int) -> tuple:
    return (None,) * nd


# (path regex, spec builder taking ndim) — first match wins.
_RULES: list[tuple[str, object]] = [
    # embeddings / unembedding
    (r"\['embed'\]$", lambda nd: ("model", None)),
    (r"\['lm_head'\]$", lambda nd: (None, "model")),
    (r"\['img_proj'\]$", lambda nd: (None, "model")),
    (r"\['frontend_proj'\]$", lambda nd: (None, None)),
    # attention projections (stacked: leading L axis)
    (r"\['w[qkv]'\]$", lambda nd: _rep(nd - 1) + ("model",)),
    (r"\['b[qkv]'\]$", lambda nd: _rep(nd - 1) + ("model",)),
    (r"\['wo'\]$", lambda nd: _rep(nd - 2) + ("model", None)),
    # MLA
    (r"\['wq_a'\]$", lambda nd: _rep(nd)),
    (r"\['wq_b'\]$", lambda nd: _rep(nd - 1) + ("model",)),
    (r"\['wkv_a'\]$", lambda nd: _rep(nd)),
    (r"\['wk_b'\]$", lambda nd: _rep(nd - 1) + ("model",)),
    (r"\['wv_b'\]$", lambda nd: _rep(nd - 1) + ("model",)),
    # MoE: experts across the model axis (expert parallelism)
    (r"\['router'\]$", lambda nd: _rep(nd)),
    (r"\['moe'\]\['(gate|up|down)'\]$",
     lambda nd: _rep(nd - 3) + ("model", None, None)),
    (r"\['shared'\]\['(gate|up)'\]$", lambda nd: _rep(nd - 1) + ("model",)),
    (r"\['shared'\]\['down'\]$", lambda nd: _rep(nd - 2) + ("model", None)),
    # dense MLP
    (r"\['mlp'\]\['(gate|up)'\]$", lambda nd: _rep(nd - 1) + ("model",)),
    (r"\['mlp'\]\['down'\]$", lambda nd: _rep(nd - 2) + ("model", None)),
    # SSM
    (r"\['in_proj'\]$", lambda nd: _rep(nd - 1) + ("model",)),
    (r"\['out_proj'\]$", lambda nd: _rep(nd - 2) + ("model", None)),
    # RG-LRU
    (r"\['in_(x|gate)'\]$", lambda nd: _rep(nd - 1) + ("model",)),
    (r"\['w_[ai]'\]$", lambda nd: _rep(nd - 1) + ("model",)),
    (r"\['b_[ai]'\]$", lambda nd: _rep(nd - 1) + ("model",)),
    (r"\['lam'\]$", lambda nd: _rep(nd - 1) + ("model",)),
    (r"\['rec'\]\['out'\]$", lambda nd: _rep(nd - 2) + ("model", None)),
    (r"\['conv_[wb]'\]$", lambda nd: _rep(nd - 1) + ("model",)),
]


def _map_paths(fn, tree):
    """``fn(keystr, leaf)`` over every leaf, keeping ``tree``'s structure."""
    return tree_unflatten(tree, iter([fn(path, leaf) for path, leaf
                                      in tree_flatten_with_path(tree)]))


def _spec_for(path: str, ndim: int, overrides=()) -> tuple:
    for pat, action in overrides:
        if re.search(pat, path):
            if action == "replicate":
                return _rep(ndim)
            raise ValueError(f"unknown override action {action!r}")
    for pat, fn in _RULES:
        if re.search(pat, path):
            return fn(ndim)
    return _rep(ndim)              # replicate (norms, scalars, biases)


def param_specs(params, overrides=()):
    """Tree of specs matching ``params`` (works on meta trees)."""
    return _map_paths(lambda path, x: _spec_for(path, len(x.shape),
                                                overrides), params)


def _entry(axes: tuple):
    """A spec entry for ``axes``: one axis by its name (``PartitionSpec``
    stores ``("data",)`` as ``"data"``), several as their tuple."""
    return axes[0] if len(axes) == 1 else axes


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _sanitize(spec: tuple, shape, mesh) -> tuple:
    """Drop axis assignments that don't divide the dim."""
    sizes = mesh_axes(mesh)
    out = []
    for dim, ax in zip(shape, tuple(spec) + _rep(len(shape) - len(spec))):
        size = 1
        for a in _axes(ax):
            size *= sizes[a]
        out.append(ax if ax is not None and dim % size == 0 else None)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A sanitized spec on a mesh (``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> tuple:
        """One DTensor placement per mesh dim (a mesh axis of size 1 splits
        nothing: it replicates)."""
        from torch.distributed.tensor import Replicate, Shard

        names = tuple(self.mesh.mesh_dim_names)
        sizes = mesh_axes(self.mesh)
        owner = {}
        for d, entry in enumerate(self.spec):
            axes = _axes(entry)
            order = [names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(f"spec {self.spec}: axes {axes} of dim {d} "
                                 f"are not in mesh order {names}")
            owner.update({a: d for a in axes})
        return tuple(Shard(owner[a]) if a in owner and sizes[a] > 1
                     else Replicate() for a in names)


def named(mesh, tree_specs, tree):
    """Spec tree -> :class:`NamedSharding` tree, sanitized against shapes."""
    specs = iter([s for _, s in tree_flatten_with_path(
        tree_specs, is_leaf=lambda s: isinstance(s, tuple))])
    return _map_paths(lambda _, x: NamedSharding(
        mesh, _sanitize(next(specs), x.shape, mesh)), tree)


def fsdp_specs(params, mesh, overrides=()):
    """Param specs + ZeRO/FSDP data-axis sharding: the first dim not already
    sharded whose size divides the data-parallel axis product gets "data"
    (and "pod" too when divisible) — params and optimizer states then scale
    with the full rank count, the production default for >=1B models."""
    sizes = mesh_axes(mesh)
    dp = _entry(data_axes(mesh))
    dp_all = 1
    for a in _axes(dp):
        dp_all *= sizes[a]
    dp_one = sizes["data"]

    def spec(path, leaf):
        shape = tuple(leaf.shape)
        if any(re.search(pat, path) and act == "replicate"
               for pat, act in overrides):
            return _rep(len(shape))
        base = _spec_for(path, len(shape), overrides)
        dims = list(base + _rep(len(shape) - len(base)))
        # choose the largest eligible dim for the data shard
        cand = sorted((i for i, (d, ax) in enumerate(zip(shape, dims))
                       if ax is None and d >= dp_one),
                      key=lambda i: -shape[i])
        for i in cand:
            if shape[i] % dp_all == 0:
                dims[i] = dp
                break
            if shape[i] % dp_one == 0:
                dims[i] = "data"
                break
        return tuple(dims)

    return _map_paths(spec, params)


def param_shardings(mesh, params, *, fsdp: bool = True, overrides=()):
    specs = (fsdp_specs(params, mesh, overrides) if fsdp
             else param_specs(params, overrides))
    return named(mesh, specs, params)


def index_shardings(mesh, tree, axis: str = "items"):
    """Item-axis shardings for the retrieval service's index arrays.

    Every leaf gets its LEADING dim partitioned on ``axis`` (posting tables
    are stacked shard-major, factor/alive arrays are flat item-major — both
    partition on their first dim).  Non-divisible dims fall back to
    replication via the same sanitizer the model params use."""
    return _map_paths(lambda _, x: NamedSharding(mesh, _sanitize(
        (axis,) + _rep(len(x.shape) - 1), x.shape, mesh)), tree)


def batch_specs(cfg: ModelConfig, mesh, batch):
    """Input-batch sharding: batch dim over ("pod","data") when divisible."""
    dp = _entry(data_axes(mesh))
    return _map_paths(lambda _, x: NamedSharding(mesh, _sanitize(
        (dp,) + _rep(len(x.shape) - 1), x.shape, mesh)), batch)


def cache_specs(cfg: ModelConfig, mesh, cache, *, seq_shard: bool):
    """KV/state-cache sharding.

    Layout per leaf: (L, B, S, ...) for kv-like, (L, B, ...) for states.
    ``seq_shard=True`` (batch-1 long-context) shards S on "data" instead of B.
    """
    dp = _entry(data_axes(mesh))

    def spec(name, x):
        nd = len(x.shape)
        if nd == 0 or "len" in name:
            return NamedSharding(mesh, ())
        dims: list = [None] * nd
        seq_axis = None
        if any(k in name for k in ("'k'", "'v'", "cross_k", "cross_v")):
            seq_axis = 2
        elif any(k in name for k in ("c_kv", "k_rope")):
            seq_axis = 2
        if seq_shard:
            if seq_axis is not None:
                dims[seq_axis] = "data"
            # state caches (ssm/rec/conv): shard widest model dim on "model"
            elif "'ssm'" in name and nd >= 3:
                dims[2] = "model"      # heads
        elif nd >= 2:
            dims[1] = dp               # batch over (pod, data)
        return NamedSharding(mesh, _sanitize(tuple(dims), x.shape, mesh))

    return _map_paths(spec, cache)


# ------------------------------------------------------------- placement


def local_block(x: torch.Tensor, mesh, placements,
                coords=None) -> torch.Tensor:
    """The block of ``x`` that the mesh position ``coords`` (one index per
    mesh dim; default this rank's) holds under DTensor ``placements``: each
    sharded dim is cut into equal parts, major mesh dim first."""
    if coords is None:
        coords = mesh.get_coordinate()
    for c, n, p in zip(coords, tuple(mesh.shape), placements):
        if p.is_shard():
            x = x.chunk(n, dim=p.dim)[c]
    return x


def place(tree, shardings):
    """Every tensor leaf of ``tree`` (which each rank holds whole, as from
    a seeded init or a file) as a DTensor under its sharding: each rank
    keeps only its own block, cloned so the whole tensor can be freed."""
    from torch.distributed.tensor import DTensor

    flat = iter([s for _, s in tree_flatten_with_path(
        shardings, is_leaf=lambda s: isinstance(s, NamedSharding))])

    def one(_, x):
        s = next(flat)
        pl = s.placements
        return DTensor.from_local(local_block(x, s.mesh, pl).clone(), s.mesh,
                                  pl, run_check=False)

    return _map_paths(one, tree)
