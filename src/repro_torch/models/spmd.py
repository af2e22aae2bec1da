"""The model on a device mesh: parameters, batches and caches as DTensors.

The model's code is written once, for plain tensors, and runs unchanged on
DTensor leaves placed by ``sharding.specs``: each op's sharding rule drives
the collectives (the counterpart of GSPMD).  This module holds what that
leaves out:

* :func:`replicated_constants` — the tensors the model makes itself
  (positions, masks, the aux-loss zero) are plain; under a mesh they read
  as replicated.
* :func:`heads_on_mesh` — attention over the sequence, per rank on its
  sequences and heads.
* :func:`embed_on_mesh` and :func:`picked` — the token embedding's
  gather (vocab-parallel) and the loss's pick of each label's
  log-probability.
* :func:`whole_dim` — decode's logits whole on the vocab.
* :func:`decode_on_mesh` — one decode step's attention over a DTensor
  cache.  DTensor has no rule for the in-place slot write, and its einsum
  rule mislays the grouped heads, so the step is written per rank: on a
  cache sharded on batch each rank attends over its own sequences with the
  single-device code (the ``decode_attention`` kernel on the card); on a
  cache sharded on slots (batch-1 long context) each rank scores its own
  slots, the scores are gathered for the softmax, and the rank's partial
  products are summed.
* :func:`moe_on_mesh` — the MoE layer.  Routing ranks every (token, slot)
  pair of the GLOBAL batch against an expert's capacity, and its
  ``bincount`` and sort have no sharding rule, so the tokens are gathered
  and routed alike on every rank; each rank then runs only the experts the
  ``model`` axis gives it (expert parallelism) and the expert outputs are
  gathered.  The same pairs are kept and dropped as on one device.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["is_dtensor", "replicated_constants", "heads_on_mesh",
           "embed_on_mesh", "picked", "whole_dim", "whole_heads",
           "decode_on_mesh", "moe_on_mesh"]


def is_dtensor(x) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


_depth = 0       # replicated_constants contexts entered and not yet left


@contextlib.contextmanager
def replicated_constants(on_mesh: bool):
    """Context in which plain tensors meeting DTensors count as replicated
    (``implicit_replication``) when ``on_mesh``.  Nests: only the outermost
    context enters and leaves ``implicit_replication``, which does not
    restore an enclosing one's setting on exit."""
    global _depth
    if not on_mesh or _depth:
        _depth += on_mesh
        try:
            yield
        finally:
            _depth -= on_mesh
        return
    from torch.distributed.tensor.experimental import implicit_replication
    _depth = 1
    try:
        with implicit_replication():
            yield
    finally:
        _depth = 0


def _replicated(x):
    """A DTensor as the whole plain tensor on every rank (differentiable)."""
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    return x.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()


def _local(x, placements):
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        raise TypeError("a DTensor cache needs DTensor parameters")
    return x.redistribute(x.device_mesh, placements).to_local()


def heads_on_mesh(fn, q, k, v):
    """``fn(q, k, v)`` (attention on plain tensors: q (B, S, H, hd), k/v
    (B, S_kv, Hkv, *) -> (B, S, H, *)) on each rank's block of sequences
    and heads, which attention keeps apart: the batch stays sharded where
    it is, the ``model`` axis shards the heads (when it divides Hkv), and
    the output comes back as a DTensor in those placements.  DTensor's own
    einsum rules cannot flatten a sharded head dim (torch 2.11)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = q.device_mesh
    hkv = k.shape[2]
    pl = []
    for i, (name, p) in enumerate(zip(mesh.mesh_dim_names, q.placements)):
        if p.is_shard(0):
            pl.append(Shard(0))
        elif name == "model" and hkv % mesh.size(i) == 0:
            pl.append(Shard(2))
        else:
            pl.append(Replicate())
    out = fn(*(_local(t, pl) for t in (q, k, v)))
    return DTensor.from_local(out, mesh, pl, run_check=False)


def embed_on_mesh(table, tokens):
    """``table[tokens]`` on a mesh, vocab-parallel (Megatron's layout): the
    table is gathered on its feature dim and kept in its vocab blocks, each
    rank gathers the rows of its block for the tokens that fall in it
    (zeros for the others), and the result is a partial sum over the ranks
    that split the vocab, which DTensor reduces where the next op needs it
    (one row plus zeros: the table's row exactly).  The tokens keep their
    batch placement; the backward is each rank's gather backward into its
    block (an ``index_add``), summed over the ranks that split the batch.
    DTensor's own rule for the gather's backward (``index_put``) fails on a
    sharded table (torch 2.11), as the reference's gather fails under GSPMD
    (ROADMAP queue 3)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    vocab = [p.is_shard(0) for p in table.placements]
    w = table.redistribute(mesh, [Shard(0) if v else Replicate()
                                  for v in vocab])
    if isinstance(tokens, DTensor):
        tok = tokens.redistribute(mesh, [
            Shard(0) if p.is_shard(0) and not v else Replicate()
            for p, v in zip(tokens.placements, vocab)])
    else:
        tok = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    batch = [p.is_shard(0) for p in tok.placements]
    wl = w.to_local(grad_placements=[
        Shard(0) if v else Partial() if b else Replicate()
        for v, b in zip(vocab, batch)])
    lo, span, coords = 0, table.shape[0], mesh.get_coordinate()
    for i, v in enumerate(vocab):
        if v:
            span //= mesh.size(i)
            lo += coords[i] * span
    idx = tok.to_local() - lo
    inside = (idx >= 0) & (idx < wl.shape[0])
    rows = torch.where(inside[..., None],
                       wl[idx.clamp(0, wl.shape[0] - 1)], 0)
    return DTensor.from_local(rows, mesh, [
        Partial() if v else Shard(0) if b else Replicate()
        for v, b in zip(vocab, batch)], run_check=False)


def picked(logp, labels):
    """``logp[..., labels]`` (B, S) of log-probabilities (B, S, V): a gather
    on one device; on a mesh an elementwise select and a sum over the vocab
    (the same values: one term is not zero), which DTensor places by its
    elementwise rules whatever the batch's placement."""
    if not is_dtensor(logp):
        return torch.gather(logp, -1, labels[..., None])[..., 0]
    vocab = torch.arange(logp.shape[-1], device=labels.device)
    return torch.where(labels[..., None] == vocab, logp, 0.0).sum(-1)


def whole_dim(x, dim: int):
    """A DTensor with ``dim`` gathered (its other placements kept); a plain
    tensor as it is.  Decode's logits come out whole on the vocab, so a
    rank's argmax needs no cross-rank reduction (DTensor's argmax over a
    sharded dim mis-shapes its gather at batch 1, torch 2.13)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dim %= x.ndim
    pl = [Replicate() if p.is_shard(dim) else p for p in x.placements]
    return x.redistribute(x.device_mesh, pl)


def whole_heads(x, n_heads: int):
    """A DTensor projection (..., n_heads * hd) with its last dim gathered
    where a mesh axis that splits it does not divide ``n_heads`` (the
    heads' reshape cannot cut a head in two); anything else as it is.
    tinyllama's 4 K/V heads on the production mesh's 16-way ``model``
    axis."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    mesh, last = x.device_mesh, x.ndim - 1
    pl = [Replicate() if p.is_shard(last) and n_heads % mesh.size(i) else p
          for i, p in enumerate(x.placements)]
    return x if pl == list(x.placements) else x.redistribute(mesh, pl)


def decode_on_mesh(core, q, k, v, kc, vc, cur, *, ring: bool, window):
    """Attention of one decode step over the DTensor cache ``kc``/``vc``
    (B, S, Hkv, hd), written in place.  ``core(q, k, v, kc, vc, cur)`` is
    the single-device step on plain tensors.  Returns the attention output
    (B, 1, H hd) as a DTensor."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh, pl = kc.device_mesh, tuple(kc.placements)
    cur_l = cur.to_local() if isinstance(cur, DTensor) else cur
    if not any(p.is_shard(1) for p in pl):
        if any(p.is_shard() and not p.is_shard(0) for p in pl):
            raise ValueError(f"decode over a cache placed {pl}: only the "
                             "batch or the slot dim may be sharded")
        out = core(*(_local(t, pl) for t in (q, k, v)), kc.to_local(),
                   vc.to_local(), cur_l)
        return DTensor.from_local(out, mesh, pl, run_check=False)
    if any(p.is_shard() and not p.is_shard(1) for p in pl):
        raise ValueError(f"decode over a cache placed {pl}: only the "
                         "batch or the slot dim may be sharded")
    rep = [Replicate()] * mesh.ndim
    out = _decode_slots(*(_local(t, rep) for t in (q, k, v)),
                        kc, vc, cur_l, ring=ring, window=window)
    return DTensor.from_local(out, mesh, rep, run_check=False)


def _slot_offset(x) -> int:
    """First global slot of this rank's block of a DTensor cache whose dim
    1 is sharded (major mesh dim first, as the placements cut it)."""
    mesh, off, span = x.device_mesh, 0, x.shape[1]
    coords = mesh.get_coordinate()
    for i, p in enumerate(x.placements):
        if p.is_shard(1):
            span //= mesh.size(i)
            off += coords[i] * span
    return off


def _decode_slots(q, k, v, kc, vc, cur, *, ring: bool, window):
    """Sequence-parallel decode attention: this rank holds the slots
    ``[lo, lo + S_local)`` of every sequence.  The new row is written by
    the rank that holds its slot (with no host sync: the other ranks
    rewrite a row with itself); the (B, 1, Hkv, G, S) scores are gathered
    for the softmax, and the partial products over each rank's slots are
    summed.  Plain q/k/v (replicated), DTensor caches."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh, pl = kc.device_mesh, tuple(kc.placements)
    kl, vl = kc.to_local(), vc.to_local()
    b, _, h, hd = q.shape
    hkv, capacity, span = kl.shape[2], kc.shape[1], kl.shape[1]
    lo = _slot_offset(kc)
    wp = cur % capacity if ring else torch.clamp(cur, max=capacity - 1)
    local = wp - lo
    mine = (local >= 0) & (local < span)
    slot = torch.clamp(local, 0, span - 1).reshape(1).long()
    for cache, new in ((kl, k), (vl, v)):
        cache.index_copy_(1, slot, torch.where(
            mine, new.to(cache.dtype), cache.index_select(1, slot)))
    g = h // hkv
    qg = q.reshape(b, 1, hkv, g, hd)
    scores = torch.einsum("bqkgd,bskd->bqkgs", qg.float(),
                          kl.float()) * hd ** -0.5
    slots = lo + torch.arange(span, device=q.device)
    if ring:
        kv_positions = cur - torch.remainder(cur - slots, capacity)
        mask = (kv_positions >= 0) & (kv_positions <= cur)
    else:
        kv_positions = slots
        mask = kv_positions <= wp
    if window is not None:
        mask &= kv_positions > cur - window
    scores = torch.where(mask[None, None, None, None, :], scores, -1e30)
    seq = [Shard(4) if p.is_shard(1) else Replicate() for p in pl]
    full = DTensor.from_local(scores, mesh, seq,
                              run_check=False).full_tensor()
    probs = torch.softmax(full, dim=-1)[..., lo:lo + span]
    part = torch.einsum("bqkgs,bskd->bqkgd", probs, vl.float())
    summed = [Partial() if p.is_shard(1) else Replicate() for p in pl]
    out = DTensor.from_local(part, mesh, summed,
                             run_check=False).full_tensor()
    return out.to(q.dtype).reshape(b, 1, h * hd)


def moe_on_mesh(tokens_fn, experts_fn, params, x, cfg):
    """The MoE layer on DTensor ``x`` (B, S, d) and parameters.
    ``tokens_fn(params, xt, cfg, experts)`` is the single-device layer on
    the (T, d) tokens with the expert step ``experts(params, dispatch)``
    swapped in; ``experts_fn`` is that step on plain tensors.  Returns (out
    in ``x``'s placements, aux loss replicated)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    rep = [Replicate()] * mesh.ndim
    e = cfg.n_experts
    ep = "model" in names and e % mesh.size(names.index("model")) == 0
    by_expert = [Shard(0) if ep and n == "model" else Replicate()
                 for n in names]
    local = {name: (_local(w, by_expert) if name in ("gate", "up", "down")
                    else {k: _replicated(t) for k, t in w.items()}
                    if isinstance(w, dict) else _replicated(w))
             for name, w in params.items()}

    def experts(p, dispatch):
        # the tile's rows of this rank's experts, through DTensor so that
        # the backward gathers every rank's part of the tile's gradient
        mine = DTensor.from_local(dispatch, mesh, rep, run_check=False
                                  ).redistribute(mesh, by_expert).to_local()
        ho = experts_fn(p, mine)
        return DTensor.from_local(ho, mesh, by_expert,
                                  run_check=False).full_tensor()

    b, s, d = x.shape
    out, aux = tokens_fn(local, _replicated(x).reshape(b * s, d), cfg,
                         experts)
    out = DTensor.from_local(out.reshape(b, s, d), mesh, rep,
                             run_check=False)
    back = [Replicate() if p.is_partial() else p for p in x.placements]
    return (out.redistribute(mesh, back),
            DTensor.from_local(aux, mesh, rep, run_check=False))
