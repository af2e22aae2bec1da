"""Device-mesh contract runner of the port: real ranks, real collectives.

Spawns N worker processes (default 4) joined in one ``torch.distributed``
gloo group (``repro_torch.launch.procs``); each runs the same checks of one
suite on device meshes over the group, and every check's result (and the
data a test compares) is written to ``--out`` as JSON by rank 0:
``{check: {"ok": bool, "detail": str, "data": ...}}``, ok only where every
rank passed.  ``tests/test_torch_sharding.py``,
``tests/test_torch_mesh_index.py`` and ``tests/test_torch_remat.py`` run it
once each and read the file.

``--suite sharding`` (a ``(2, 2)`` ``("data", "model")`` mesh): each rank's
block of a placed tensor, ``shard_batch``, sharded train steps of four
families and sharded serve steps (batch-sharded and a seq-sharded batch-1
sliding-window decode) against the single-device port, the resident bytes
the specs give, a checkpoint of a DTensor tree, and the host-staged
collectives.  ``--suite remat`` (the same mesh): sharded train steps with
the blocks rematerialised (``cfg.remat`` full or dots) against one
device's step without.  ``--suite index`` (a 2-rank ``items`` mesh twice
over and a 4-rank one): the mesh-placed ``sharded`` index against
single-device ``sharded`` bit for bit through build, queries, mutations,
compaction, int8, snapshots, an uneven split and a heterogeneous
partition, and ``brute`` on exact queries.

Usage:

    PYTHONPATH=src python tests/multihost/run_mesh_torch.py \\
        --suite sharding --device cpu --processes 4 --out /tmp/mesh.json

Exit code 0 iff every worker ran to its end (a failed check is recorded,
not raised); a worker that hangs past ``--timeout`` is killed (124).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import traceback
import warnings

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                   "src")

# a train step on a mesh against one device (as tests/test_torch_training.py
# holds the port to the reference): loss within 1e-5 relative, moments
# within 2e-5 of the leaf's largest, params within 1e-5 except where
# AdamW's denominator is eps-dominated (sqrt(v_hat) < 100 eps), counted
LOSS_TOL, MOMENT_TOL, PARAM_TOL, EPS_DOMINATED = 1e-5, 2e-5, 1e-5, 100.0
CACHE_TOL = 1e-5
TRAIN_ARCHS = ("tinyllama-1.1b", "olmoe-1b-7b", "mamba2-780m",
               "recurrentgemma-9b")
SERVE_ARCHS = ("tinyllama-1.1b", "mamba2-780m")
# tensors whose blocks are compared with the reference's layout: (shape,
# mesh shape, mesh axes, spec)
BLOCK_CASES = {
    "data-model": ((8, 4, 6), (2, 2), ("data", "model"),
                   ("data", "model", None)),
    "model-last": ((3, 8, 4), (2, 2), ("data", "model"),
                   (None, "data", "model")),
    "data-model-one-dim": ((8, 6), (2, 2), ("data", "model"),
                           (("data", "model"), None)),
    "pod-data": ((8, 6), (2, 2, 1), ("pod", "data", "model"),
                 (("pod", "data"), "model")),
    "pod-data-inner": ((3, 8, 5), (2, 2, 1), ("pod", "data", "model"),
                       (None, ("pod", "data"), None)),
}


# ------------------------------------------------------------- helpers


def _tree_leaves(tree):
    from repro_torch.checkpoint.checkpoint import tree_flatten_with_path
    return tree_flatten_with_path(tree)


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _local_bytes(tree) -> int:
    return sum((t.to_local() if hasattr(t, "to_local") else t).numel()
               * t.element_size() for _, t in _tree_leaves(tree))


def _mesh_2x2(device):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((2, 2), ("data", "model"), device)


# ------------------------------------------------------- suite: sharding


def check_local_blocks(ctx):
    """Each rank's block of a placed arange under each BLOCK_CASES spec
    (the test holds it to the reference's ``devices_indices_map``)."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding.specs import NamedSharding, place
    out = {}
    for name, (shape, mshape, axes, spec) in BLOCK_CASES.items():
        mesh = make_mesh(mshape, axes, ctx.device)
        n = 1
        for d in shape:
            n *= d
        x = torch.arange(n, dtype=torch.float32).reshape(shape)
        d = place(x, NamedSharding(mesh, spec))
        assert torch.equal(d.full_tensor(), x), name
        out[name] = {"coords": list(mesh.get_coordinate()),
                     "block": d.to_local().tolist()}
    return out


def check_shard_batch(ctx):
    import numpy as np
    import torch
    from repro_torch.data import shard_batch
    mesh = ctx.mesh
    batch = np.arange(8 * 5, dtype=np.int32).reshape(8, 5)
    d = shard_batch(batch, mesh)
    c = mesh.get_local_rank("data")
    assert d.to_local().shape == (4, 5)
    assert np.array_equal(d.to_local().numpy(), batch[4 * c:4 * c + 4])
    assert torch.equal(d.full_tensor(), torch.as_tensor(batch))
    try:
        shard_batch(batch[:3], mesh)
    except ValueError:
        return None
    raise AssertionError("a batch that does not split must raise")


def _train_case(ctx, arch, remat="none"):
    """One train step of ``arch`` (reduced, f32, vocab 512) on the mesh,
    its blocks under ``remat``, against one device without
    rematerialisation, from the same seeded params and batch."""
    import numpy as np
    import torch
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model
    from repro_torch.sharding.specs import (NamedSharding, batch_specs,
                                            param_shardings, place)
    from repro_torch.training import AdamWConfig, adamw_init
    cfg = get_reduced_config(arch).with_(vocab=512)
    model = Model(cfg, device="cpu")
    params = model.init(0)
    opt_cfg = AdamWConfig(lr=2e-3, warmup_steps=1, total_steps=3)
    step = make_train_step(model, opt_cfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (4, 33))
    batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int32)}
    want_p, want_o, want_m = step(params, adamw_init(params), batch)
    if remat != cfg.remat:
        step = make_train_step(Model(cfg.with_(remat=remat), device="cpu"),
                               opt_cfg)
    mesh = ctx.mesh
    shard = param_shardings(mesh, params)
    dp = place(params, shard)
    opt = adamw_init(dp)
    assert opt.step.placements == tuple(NamedSharding(mesh, ()).placements)
    placements = [t.placements for _, t in _tree_leaves(dp)]
    assert [t.placements for _, t in _tree_leaves(opt.mu)] == placements
    before = _local_bytes(dp), _local_bytes(opt.mu) + _local_bytes(opt.nu)
    got_p, got_o, got_m = step(dp, opt, place(batch, batch_specs(
        cfg, mesh, batch)))
    for k, v in want_m.items():
        g = float(got_m[k])
        assert abs(g - float(v)) <= LOSS_TOL * max(abs(float(v)), 1e-6), \
            (k, g, float(v))
    after = _local_bytes(got_p), (_local_bytes(got_o.mu)
                                  + _local_bytes(got_o.nu))
    assert after == before, (before, after)
    assert [t.placements for _, t in _tree_leaves(got_p)] == placements
    b2c = 1 - opt_cfg.b2
    n, dominated = 0, 0
    want = {p: t for p, t in _tree_leaves(want_p)}
    wmu = dict(_tree_leaves(want_o.mu))
    wnu = dict(_tree_leaves(want_o.nu))
    for tree, ref in ((got_o.mu, wmu), (got_o.nu, wnu)):
        for path, t in _tree_leaves(tree):
            w = ref[path]
            assert float((_full(t) - w).abs().max()) <= \
                MOMENT_TOL * float(w.abs().max()), path
    for path, t in _tree_leaves(got_p):
        off = (_full(t) - want[path]).abs() > PARAM_TOL
        vhat = (wnu[path][off] / b2c).sqrt()
        assert bool((vhat < EPS_DOMINATED * opt_cfg.eps).all()), path
        dominated += int(off.sum())
        n += t.numel()
    assert dominated <= 1e-4 * n, (dominated, n)
    assert isinstance(got_p["embed"], type(dp["embed"]))
    return {"loss": float(got_m["loss"]), "eps_dominated": dominated}


def _serve_case(ctx, arch, *, seq_shard=False):
    """Prefill (batch-sharded) or an empty seq-sharded cache, then decode
    steps through ``make_serve_step`` on the mesh against one device."""
    import numpy as np
    import torch
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import Model
    from repro_torch.sharding.specs import (batch_specs, cache_specs,
                                            param_shardings, place)
    cfg = get_reduced_config(arch).with_(vocab=512)
    if seq_shard:
        cfg = cfg.with_(attn_kind="sliding", window=8)
    model = Model(cfg, device="cpu")
    params = model.init(0)
    mesh = ctx.mesh
    dp = place(params, param_shardings(mesh, params))
    serve = make_serve_step(model)
    capacity, steps = 64, 6
    if seq_shard:
        b = 1
        cache = model.init_cache(b, capacity)
        want_c = {k: v.clone() for k, v in cache.items()}
        got_c = place(cache, cache_specs(cfg, mesh, cache, seq_shard=True))
        assert got_c["k"].placements[0].is_shard(2), got_c["k"].placements
        want_t = got_t = torch.zeros((b, 1), dtype=torch.int32)
        steps = 12
    else:
        b = 4
        prompts = torch.as_tensor(np.random.default_rng(1).integers(
            0, cfg.vocab, (b, 8)), dtype=torch.int32)
        prefill = make_prefill_step(model, capacity)
        lw, want_c = prefill(params, {"tokens": prompts})
        batch = {"tokens": prompts}
        lg, got_c = prefill(dp, place(batch, batch_specs(cfg, mesh, batch)))
        assert float((_full(lg) - lw).abs().max()) <= CACHE_TOL
        want_t = torch.argmax(lw, dim=-1).to(torch.int32)
        got_t = torch.argmax(lg, dim=-1).to(torch.int32)
    tokens_w, tokens_g = [], []
    for _ in range(steps):
        want_t, want_c = serve(params, want_c, want_t)
        got_t, got_c = serve(dp, got_c, got_t)
        tokens_w.append(want_t)
        tokens_g.append(_full(got_t))
    assert torch.equal(torch.cat(tokens_g, 1), torch.cat(tokens_w, 1))
    worst = 0.0
    want_leaves = dict(_tree_leaves(want_c))
    for path, t in _tree_leaves(got_c):
        d = float((_full(t).float() - want_leaves[path].float()).abs().max())
        worst = max(worst, d)
        assert d <= CACHE_TOL, (path, d)
    return {"cache_max_abs": worst, "steps": steps}


def check_resident_bytes(ctx):
    """Each rank holds the specs' share of every leaf: total / (the product
    of the mesh axes that shard it) — about total / (data x model) for an
    FSDP + TP leaf — for params and AdamW moments alike."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch.mesh import mesh_axes
    from repro_torch.models import Model
    from repro_torch.sharding.specs import param_shardings, place
    from repro_torch.training import adamw_init
    cfg = get_reduced_config("tinyllama-1.1b").with_(vocab=512)
    params = Model(cfg, device="cpu").init(0)
    mesh = ctx.mesh
    shard = param_shardings(mesh, params)
    dp = place(params, shard)
    opt = adamw_init(dp)
    sizes = mesh_axes(mesh)
    want = got = 0
    total = 0
    for (path, t), (_, s), (_, m) in zip(_tree_leaves(params),
                                         _tree_leaves(shard),
                                         _tree_leaves(opt.mu)):
        share = 1
        for e in s.spec:
            for a in (e if isinstance(e, tuple) else (e,) if e else ()):
                share *= sizes[a]
        local = dict(_tree_leaves(dp))[path].to_local()
        assert local.numel() * share == t.numel(), (path, s.spec)
        assert m.to_local().numel() * share == t.numel(), path
        if path.endswith("['wq']"):
            assert share == sizes["data"] * sizes["model"], (path, s.spec)
        want += t.numel() * t.element_size() // share
        got += local.numel() * local.element_size()
        total += t.numel() * t.element_size()
    assert got == want == _local_bytes(dp)
    assert got < total / 2, (got, total)
    return {"rank_bytes": got, "total_bytes": total}


def check_checkpoint(ctx):
    """A DTensor tree (params and AdamW state) saves to the file its whole
    tree gives, byte for byte, and restores onto a DTensor donor with the
    donor's placements."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import Model
    from repro_torch.sharding.specs import param_shardings, place
    from repro_torch.training import AdamWState, adamw_init
    cfg = get_reduced_config("tinyllama-1.1b").with_(vocab=512,
                                                     dtype="bfloat16")
    params = Model(cfg, device="cpu").init(0)
    mesh = ctx.mesh
    dp = place(params, param_shardings(mesh, params))
    tree = {"params": dp, "opt": adamw_init(dp)}
    whole = {"params": params, "opt": adamw_init(params)}
    a = os.path.join(ctx.tmp, "placed.npz")
    b = os.path.join(ctx.tmp, f"whole{dist.get_rank()}.npz")
    save_checkpoint(a, tree, step=3)
    save_checkpoint(b, whole, step=3)
    with np.load(a) as fa, np.load(b) as fb:
        assert sorted(fa.files) == sorted(fb.files)
        for k in fa.files:
            assert fa[k].dtype == fb[k].dtype and np.array_equal(fa[k],
                                                                 fb[k]), k
    donor = {"params": place(params, param_shardings(mesh, params)),
             "opt": adamw_init(dp)}
    got, step = restore_checkpoint(a, donor)
    assert step == 3
    for (path, g), (_, d), (_, w) in zip(_tree_leaves(got),
                                         _tree_leaves(donor),
                                         _tree_leaves(whole)):
        assert g.placements == d.placements, path
        assert g.dtype == w.dtype and torch.equal(_full(g), w), path
    assert isinstance(got["opt"], AdamWState)
    return None


def check_staged_collectives(ctx):
    """``launch.mesh.stage_collectives`` (what a cuda mesh over gloo does):
    DTensor's all-gather and reduce-scatter run through host memory,
    counted, with the same results: redistributions, then a whole train
    step against one device."""
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.mesh import STAGED, stage_collectives
    from repro_torch.sharding.specs import NamedSharding, place
    mesh = ctx.mesh
    x = torch.arange(8 * 6, dtype=torch.bfloat16).reshape(8, 6)
    d = place(x, NamedSharding(mesh, ("data", "model")))
    stage_collectives("cpu")
    full = d.redistribute(mesh, [Replicate(), Replicate()]).to_local()
    assert torch.equal(full, x)
    assert STAGED["all_gather_into_tensor"]["bytes"] >= x.numel() * 2
    assert d.redistribute(mesh, [Shard(1), Shard(0)]).full_tensor().equal(x)
    _train_case(ctx, "tinyllama-1.1b")
    for name in ("all_gather_into_tensor", "reduce_scatter_tensor"):
        assert STAGED.get(name, {}).get("calls", 0) > 0, (name, STAGED)
    return {k: dict(v) for k, v in STAGED.items()}


SHARDING_CHECKS = [("local_blocks", check_local_blocks),
                   ("shard_batch", check_shard_batch)]
SHARDING_CHECKS += [(f"train[{a}]", lambda ctx, a=a: _train_case(ctx, a))
                    for a in TRAIN_ARCHS]
SHARDING_CHECKS += [(f"serve[{a}]", lambda ctx, a=a: _serve_case(ctx, a))
                    for a in SERVE_ARCHS]
SHARDING_CHECKS += [
    ("serve[seq-sharded-sliding]",
     lambda ctx: _serve_case(ctx, "tinyllama-1.1b", seq_shard=True)),
    ("resident_bytes", check_resident_bytes),
    ("checkpoint", check_checkpoint),
    # last: it stages every later collective of this process
    ("staged_collectives", check_staged_collectives)]


# ---------------------------------------------------------- suite: remat

# (arch, remat mode) of the sharded train steps held to one device's step
# without rematerialisation
REMAT_CASES = (("tinyllama-1.1b", "full"), ("olmoe-1b-7b", "full"),
               ("recurrentgemma-9b", "full"), ("tinyllama-1.1b", "dots"))
REMAT_CHECKS = [(f"train[{a}-{m}]",
                 lambda ctx, a=a, m=m: _train_case(ctx, a, remat=m))
                for a, m in REMAT_CASES]


# ---------------------------------------------------------- suite: index


def _catalog(n, k, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, k)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _same(a, b, tag):
    import numpy as np
    for f in ("ids", "scores", "n_scored", "discarded_frac"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), (tag, f)


def _index_case(ctx, mesh, *, quantize="none", n_shards=4, placed=True):
    """The mesh-placed ``sharded`` index against single-device ``sharded``
    (and ``brute`` on exact queries) through its lifecycle."""
    import numpy as np
    from repro_torch.core.mapping import GamConfig
    from repro_torch.retriever import RetrieverSpec, open_retriever
    cfg = GamConfig(k=16, scheme="parse_tree", threshold=0.2)
    items = _catalog(900, 16, 0)
    users = _catalog(24, 16, 1)
    spec = RetrieverSpec(cfg=cfg, backend="sharded", n_shards=n_shards,
                         min_overlap=2, quantize=quantize, rerank_factor=2,
                         bucket=512)
    a = open_retriever(spec, items=items, device="cpu", mesh=mesh)
    b = open_retriever(spec, items=items, device="cpu")
    brute = open_retriever(RetrieverSpec(cfg=cfg, backend="brute"),
                           items=items, device="cpu")
    assert a.base.placed == placed, (a.base.placed, placed)
    ranks = mesh.size(mesh.mesh_dim_names.index("items"))
    out = {"bytes": sum(a.base.device_bytes().values()),
           "bytes_single": sum(b.base.device_bytes().values())}
    if placed:
        assert a.base.tables.shape[0] * ranks == b.base.tables.shape[0]
        assert a.base.factors_g[0].shape[0] * ranks == \
            b.base.factors_g[0].shape[0]
    for exact in (False, True):
        _same(a.query(users, exact=exact), b.query(users, exact=exact),
              f"build exact={exact}")
    assert np.array_equal(a.query(users, exact=True).ids,
                          brute.query(users).ids)
    ids = np.arange(0, 60)
    a.upsert(ids, items[ids] * 0.5)
    b.upsert(ids, items[ids] * 0.5)
    a.delete(np.arange(200, 260))
    b.delete(np.arange(200, 260))
    _same(a.query(users), b.query(users), "mutated")
    ra, rb = (r.base.query_dense_reference(
        *_mapped(r, users), 10) for r in (a, b))
    assert np.array_equal(ra.rows, rb.rows) and np.array_equal(
        ra.scores, rb.scores) and np.array_equal(ra.shard_candidates,
                                                 rb.shard_candidates)
    a.compact()
    b.compact()
    assert a.base.placed == placed
    _same(a.query(users), b.query(users), "compacted")
    a.upsert(np.arange(300, 320), items[300:320] * 0.25)
    b.upsert(np.arange(300, 320), items[300:320] * 0.25)
    a.compact(async_=True)
    b.compact(async_=True)
    while a._planner is not None:      # a query also advances it a slice
        assert a.compaction_step() == b.compaction_step()
        _same(a.query(users), b.query(users), "mid-compaction")
    _same(a.query(users), b.query(users), "background compaction")
    _same(a.query(users, explain=True), b.query(users, explain=True),
          "explain")
    assert a.stats()["posting_load"] == b.stats()["posting_load"]
    path = os.path.join(ctx.tmp, f"snap-{ctx.rank_tag(mesh)}-{quantize}"
                        f"-{n_shards}.npz")
    a.snapshot(path)
    c = open_retriever(spec, snapshot=path, device="cpu")
    assert not c.base.placed
    _same(c.query(users), b.query(users), "restored")
    return out


def _mapped(r, users):
    import torch
    from repro_torch.core.mapping import sparse_map
    u = torch.as_tensor(users)
    tau, vals = sparse_map(u, r.spec.cfg)
    return u, tau, vals != 0


def _two_rank_mesh(device):
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device, torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("replica", "items"))


def check_heterogeneous(ctx):
    """A repartition to several bn-groups on a mesh warns and serves from
    the whole index on every rank; answers stay single-device's."""
    import numpy as np
    from repro_torch.core.mapping import GamConfig
    from repro_torch.retriever import RetrieverSpec, open_retriever
    from repro_torch.service.repartition import Partition
    from repro_torch.service.sharded_index import ShardedGamIndex
    cfg = GamConfig(k=16, scheme="parse_tree", threshold=0.2)
    items = _catalog(600, 16, 2)
    users = _catalog(16, 16, 3)
    part = Partition.from_lengths((200, 100, 300), (16, 8, 32))
    mesh = ctx.index_meshes[1]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        idx = ShardedGamIndex.build(items, cfg, partition=part,
                                    min_overlap=2, bucket=512, mesh=mesh,
                                    device="cpu")
    assert any(issubclass(w.category, RuntimeWarning)
               and "heterogeneous" in str(w.message) for w in caught)
    assert not idx.placed
    spec = RetrieverSpec(cfg=cfg, backend="sharded", n_shards=3,
                         min_overlap=2, bucket=512)
    a = open_retriever(spec, items=items, device="cpu", mesh=mesh)
    b = open_retriever(spec, items=items, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for r in (a, b):
            r.start_compaction(partition=part)
            while not r.compaction_step():
                pass
    assert len(a.base.partition.groups) == 3 and not a.base.placed
    _same(a.query(users), b.query(users), "heterogeneous")
    return None


def check_multihost_mesh(ctx):
    """``sharded-multihost`` with ``mesh=`` checks it and places by host
    (the reference's host slices carve from the mesh-placed arrays, which
    changes no answer): the base is built unplaced and answers as
    single-device ``sharded``."""
    from repro_torch.core.mapping import GamConfig
    from repro_torch.retriever import RetrieverSpec, open_retriever
    cfg = GamConfig(k=16, scheme="parse_tree", threshold=0.2)
    items = _catalog(800, 16, 4)
    users = _catalog(16, 16, 5)
    kw = dict(cfg=cfg, n_shards=4, min_overlap=2, bucket=512)
    a = open_retriever(RetrieverSpec(backend="sharded-multihost", n_hosts=4,
                                     replication=1, **kw), items=items,
                       device="cpu", mesh=ctx.index_meshes[2])
    b = open_retriever(RetrieverSpec(backend="sharded", **kw), items=items,
                       device="cpu")
    assert a.mesh is None
    _same(a.query(users), b.query(users), "multihost on a mesh")
    return None


def check_uneven_caps(ctx):
    """One bn-group whose shards differ in rows (as a skew-aware
    repartition makes them) on a 2-rank mesh: placed when both ranks' runs
    of shards hold as many rows, replicated when not.  int8 and exact
    answers and a restored snapshot equal single-device ``sharded``."""
    import numpy as np
    from repro_torch.core.mapping import GamConfig
    from repro_torch.retriever import RetrieverSpec, open_retriever
    from repro_torch.service.repartition import Partition
    cfg = GamConfig(k=16, scheme="parse_tree", threshold=0.2)
    items = _catalog(1000, 16, 6)
    users = _catalog(16, 16, 7)
    spec = RetrieverSpec(cfg=cfg, backend="sharded", n_shards=4,
                         min_overlap=2, quantize="int8", rerank_factor=2,
                         bucket=512)
    mesh = ctx.index_meshes[1]
    out = {}
    # caps 304 + 112 against 304 + 304 rows; 304 + 208 on both ranks
    for lengths, placed in (((300, 100, 300, 300), False),
                            ((300, 200, 200, 300), True)):
        part = Partition.from_lengths(lengths, (16,) * 4)
        a = open_retriever(spec, items=items, device="cpu", mesh=mesh)
        b = open_retriever(spec, items=items, device="cpu")
        for r in (a, b):
            r.start_compaction(partition=part)
            while not r.compaction_step():
                pass
        assert a.base.partition.caps == part.caps, a.base.partition.caps
        assert a.base.placed == placed, (lengths, a.base.placed)
        for exact in (False, True):
            _same(a.query(users, exact=exact), b.query(users, exact=exact),
                  f"caps {part.caps} exact={exact}")
        path = os.path.join(ctx.tmp, f"snap-{ctx.rank_tag(mesh)}-caps-"
                            f"{int(placed)}.npz")
        a.snapshot(path)
        c = open_retriever(spec, snapshot=path, device="cpu")
        _same(c.query(users), b.query(users), f"caps {part.caps} restored")
        out[str(part.caps)] = placed
    return out


def check_index_mesh_errors(ctx):
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.core.mapping import GamConfig
    from repro_torch.retriever import RetrieverSpec, open_retriever
    spec = RetrieverSpec(cfg=GamConfig(k=16), backend="sharded")
    flat = DeviceMesh(ctx.device, torch.arange(4), mesh_dim_names=("data",))
    try:
        open_retriever(spec, device="cpu", mesh=flat)
    except ValueError as e:
        assert "items" in str(e)
        return None
    raise AssertionError("a mesh without an 'items' axis must raise")


INDEX_CHECKS = [
    (f"index[{ranks}-ranks-{quant}]",
     lambda ctx, m=m, q=quant: _index_case(ctx, ctx.index_meshes[m],
                                           quantize=q))
    for m, ranks in ((1, 2), (2, 4)) for quant in ("none", "int8")]
INDEX_CHECKS += [
    ("index[4-ranks-8-shards]",
     lambda ctx: _index_case(ctx, ctx.index_meshes[2], n_shards=8)),
    ("index[uneven-split-replicates]",
     lambda ctx: _index_case(ctx, ctx.index_meshes[1], n_shards=3,
                             placed=False)),
    ("index[uneven-caps-int8]", check_uneven_caps),
    ("index[heterogeneous-warns]", check_heterogeneous),
    ("index[multihost-on-mesh]", check_multihost_mesh),
    ("index[mesh-without-items-axis]", check_index_mesh_errors)]


# ------------------------------------------------------------- driver


class Ctx:
    def __init__(self, args):
        self.device = args.device
        self.tmp = args.tmp
        self.mesh = None
        self.index_meshes = {}

    @staticmethod
    def rank_tag(mesh) -> str:
        """Names an index mesh's group of ranks (one file per group)."""
        import torch.distributed as dist
        n = mesh.size(mesh.mesh_dim_names.index("items"))
        return f"{n}r-g{dist.get_rank() // n}"


def worker(args) -> None:
    sys.path.insert(0, SRC)
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_index_mesh
    from repro_torch.launch.procs import init_process_group
    torch.set_num_threads(1)
    init_process_group(args.coordinator, args.processes, args.process_id,
                       timeout_s=args.group_timeout)
    ctx = Ctx(args)
    if args.suite in ("sharding", "remat"):
        ctx.mesh = _mesh_2x2(args.device)
        checks = SHARDING_CHECKS if args.suite == "sharding" else REMAT_CHECKS
    else:
        ctx.index_meshes = {1: _two_rank_mesh(args.device),
                            2: make_index_mesh(args.processes,
                                               device_type=args.device)}
        checks = INDEX_CHECKS
    results = {}
    for name, fn in checks:
        try:
            results[name] = {"ok": True, "detail": "", "data": fn(ctx)}
        except Exception as e:                          # recorded, not raised
            results[name] = {"ok": False, "data": None,
                             "detail": f"rank {args.process_id}: "
                             f"{type(e).__name__}: {e}\n"
                             + traceback.format_exc()[-2000:]}
    every = [None] * args.processes
    dist.all_gather_object(every, results)
    if args.process_id == 0:
        merged = {}
        for name, _ in checks:
            per = [r[name] for r in every]
            bad = [p for p in per if not p["ok"]]
            merged[name] = {"ok": not bad,
                            "detail": bad[0]["detail"] if bad else "",
                            "data": [p["data"] for p in per]}
        with open(args.out, "w") as f:
            json.dump(merged, f)
    dist.barrier()
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--suite", choices=("sharding", "remat", "index"),
                    default="sharding")
    ap.add_argument("--processes", type=int, default=4)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--out", default="mesh_checks.json")
    ap.add_argument("--tmp", default="",
                    help="directory for the checkpoint and snapshot files "
                    "(default: the --out file's)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds for the whole run (workers killed after)")
    ap.add_argument("--group-timeout", type=float, default=120.0,
                    help="seconds for the rendezvous and each collective")
    ap.add_argument("--role", choices=["parent", "worker"], default="parent")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--coordinator", default="")
    args = ap.parse_args()
    args.tmp = args.tmp or os.path.dirname(os.path.abspath(args.out))
    if args.processes != 4:
        raise SystemExit("the meshes of every suite take 4 processes")
    if args.role == "worker":
        worker(args)
        return 0
    sys.path.insert(0, SRC)
    from repro_torch.launch.procs import free_coordinator, run_workers
    coordinator = free_coordinator()
    common = [sys.executable, os.path.abspath(__file__), "--role", "worker",
              "--suite", args.suite, "--processes", str(args.processes),
              "--device", args.device, "--out", args.out, "--tmp", args.tmp,
              "--group-timeout", str(args.group_timeout),
              "--coordinator", coordinator]
    codes, _ = run_workers([common + ["--process-id", str(i)]
                            for i in range(args.processes)],
                           timeout=args.timeout)
    print(f"[mesh x{args.processes} {args.suite}] workers exited {codes}")
    return 0 if all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    sys.exit(main())
