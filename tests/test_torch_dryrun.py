"""The port's cost analysis (``launch/{cost,dryrun}.py``, ``kernels/cost.py``,
``launch.mesh.fake_mesh``) against the JAX reference and against itself.

* ``SKIPS`` equals the reference's.
* Per device and stable: a product sharded over a fake 16 x 16 mesh counts
  rank 0's local flops, on the first call (when DTensor's sharding
  propagation runs the op once more on global-shape fake tensors) and on
  the second (cached).
* Bytes: a view moves nothing, an in-place op counts its bytes.
* Collectives on a fake 4-rank mesh: ``Shard(0)`` -> ``Replicate`` is an
  all-gather of the gathered output's bytes, ``Partial`` -> ``Replicate``
  an all-reduce.
* Each of the seven ``ops`` entries is charged its formula on CPU and on
  meta tensors alike, with nothing beneath it counted, and makes meta
  outputs of the CPU outputs' shapes and dtypes.
* A reduced step counts the same flops by unit, bytes and argument bytes
  on meta as on real CPU tensors.
* ``build_lowered`` counts every step of ``tests/test_dryrun_path.py``'s
  seven archs x three kinds, reduced, on a fake 2 x 4 mesh.
* Per-device argument bytes on the 16 x 16 mesh equal the sum of the
  reference's ``NamedSharding.shard_shape`` bytes on
  ``jax.sharding.AbstractMesh`` for every arch at ``train_4k`` (params,
  AdamW state, batch) and ``decode_32k`` (params, cache, tokens).
* The MoE archs run on meta (``bincount`` replaced).

Every test leaves no process group behind (the fixture checks).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import NamedSharding as JNamedSharding  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.launch import dryrun as jdryrun  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.sharding import specs as J  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import (ARCH_IDS, get_config,  # noqa: E402
                                          get_reduced_config)
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.core.mapping import GamConfig, sparse_map  # noqa: E402
from repro_torch.kernels import cost as kcost  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.gam_retrieve import (build_retrieval_meta,  # noqa: E402,E501
                                              quantize_meta)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.cost import CostCounter  # noqa: E402
from repro_torch.launch.dryrun import Lowered, build_lowered  # noqa: E402
from repro_torch.launch.mesh import (abstract_production_mesh,  # noqa: E402
                                     fake_mesh)
from repro_torch.launch.steps import make_serve_step, make_train_step  # noqa: E402,E501
from repro_torch.models import Model  # noqa: E402
from repro_torch.training import adamw_init  # noqa: E402
from repro_torch.training.optimizer import tree_leaves  # noqa: E402


@pytest.fixture(autouse=True)
def no_group_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized(), "a test left a process group behind"


def test_skips_equal_reference():
    assert dryrun.SKIPS == jdryrun.SKIPS


def test_fake_mesh_refuses_a_second_group_and_tears_down():
    with fake_mesh((2, 4), ("data", "model")) as mesh:
        assert tuple(mesh.shape) == (2, 4)
        assert dist.get_world_size() == 8 and dist.get_rank() == 0
        with pytest.raises(RuntimeError, match="already initialised"):
            with fake_mesh((2,), ("x",)):
                pass
    assert not dist.is_initialized()


# ------------------------------------------------- the counter's rules


def test_sharded_product_counts_rank_zeros_flops_on_every_call():
    """(256 x 4096, Shard(0) on data) @ (4096 x 4096, Shard(1) on model):
    rank 0's product is 2 * 16 * 4096 * 256; the global one, which
    DTensor's sharding propagation runs on fake tensors at its first call,
    is not counted."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with abstract_production_mesh() as mesh:
        a = DTensor.from_local(torch.empty(16, 4096, device="meta",
                                           dtype=torch.bfloat16),
                               mesh, [Shard(0), Replicate()], run_check=False)
        b = DTensor.from_local(torch.empty(4096, 256, device="meta",
                                           dtype=torch.bfloat16),
                               mesh, [Replicate(), Shard(1)], run_check=False)
        got = []
        for _ in range(2):
            c = CostCounter()
            with c:
                out = a @ b
            got.append(dict(c.flops))
        assert tuple(out.shape) == (256, 4096)
    assert got == [{"bf16": 33_554_432.0}] * 2


def test_views_move_nothing_and_in_place_ops_count_their_bytes():
    x = torch.ones(64, 32)
    y = torch.ones(64, 32)
    c = CostCounter()
    with c:
        x.view(32, 64).t().unsqueeze(0).expand(3, 64, 32)
        x[:8].unsqueeze(0)
    assert c.bytes_accessed == 0 and c.ops > 0
    c = CostCounter()
    with c:
        x.add_(y)                      # read x and y, write x
    assert c.bytes_accessed == 3 * 64 * 32 * 4
    c = CostCounter()
    with c:
        z = x @ y.T                    # (64, 32) @ (32, 64)
    assert c.flops == {"f32": 2.0 * 64 * 32 * 64}
    assert c.bytes_accessed == (2 * 64 * 32 + 64 * 64) * 4
    assert z.shape == (64, 64)


def test_memory_tracks_storages_once_and_frees():
    c = CostCounter()
    x = torch.ones(1000)
    assert c.arguments({"x": x}) == 4000
    with c:
        a = x * 2                      # 4,000 live
        b = a.view(10, 100)            # a view: nothing new
        del a, b
        d = x + 1                      # a's storage is gone: peak stays
    c.outputs(d)
    assert c.memory() == {"argument": 4000, "output": 4000, "temp": 0,
                          "peak": 8000}


def test_redistributions_count_their_collectives():
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    with fake_mesh((4,), ("x",)) as mesh:
        x = DTensor.from_local(torch.empty(8, 16, device="meta"), mesh,
                               [Shard(0)], run_check=False)
        c = CostCounter()
        with c:
            y = x.redistribute(mesh, [Replicate()])
        assert tuple(y.to_local().shape) == (32, 16)
        assert c.collectives == {"all-gather": 32 * 16 * 4}
        p = DTensor.from_local(torch.empty(8, 16, device="meta"), mesh,
                               [Partial()], run_check=False)
        c = CostCounter()
        with c:
            p.redistribute(mesh, [Replicate()])
        assert c.collectives == {"all-reduce": 8 * 16 * 4}


# ------------------------------------------------------ kernel entries


def _retrieval_inputs(quantize: str):
    rng = np.random.default_rng(0)
    cfg = GamConfig(k=16, scheme="parse_tree", threshold=0.2)
    items = rng.normal(size=(300, 16)).astype(np.float32)
    items /= np.linalg.norm(items, axis=1, keepdims=True)
    users = rng.normal(size=(12, 16)).astype(np.float32)
    users /= np.linalg.norm(users, axis=1, keepdims=True)
    items_t, users_t = torch.as_tensor(items), torch.as_tensor(users)
    tau, vals = sparse_map(items_t, cfg)
    meta = build_retrieval_meta(tau, vals != 0, cfg.p, bn=32, device="cpu")
    if quantize == "int8":
        meta = quantize_meta(meta, items_t)
    q_tau, q_vals = sparse_map(users_t, cfg)
    return users_t, items_t, q_tau, q_vals != 0, meta


def _to_meta(x):
    if isinstance(x, torch.Tensor):
        return x.to("meta")
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _to_meta(getattr(x, f.name))
            for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)})
    return x


def _entry_cases():
    rng = np.random.default_rng(1)

    def t(*shape, dtype=torch.float32):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32)
                               ).to(dtype)
    users, items, q_tau, q_mask, meta = _retrieval_inputs("none")
    u8, i8, qt8, qm8, meta8 = _retrieval_inputs("int8")
    mask = torch.as_tensor(rng.random((12, 300)) < 0.3)
    return {
        "tess_project": (ops.tess_project, (t(40, 16),), {}),
        "gam_score": (ops.gam_score, (users, items, mask), {}),
        "gam_retrieve": (ops.gam_retrieve, (users, items, q_tau, q_mask,
                                            meta, 5), {"min_overlap": 2}),
        "gam_retrieve_pool": (ops.gam_retrieve_pool, (u8, qt8, qm8, meta8,
                                                      20), {}),
        "decode_attention": (ops.decode_attention,
                             (t(2, 2, 3, 8), t(2, 10, 2, 8), t(2, 10, 2, 8),
                              torch.tensor(6)), {}),
        "flash_prefill": (ops.flash_prefill,
                          (t(2, 12, 2, 3, 8), t(2, 12, 2, 8),
                           t(2, 12, 2, 8)), {}),
        "gam_coarse": (ops.gam_coarse,
                       (t(4, 32), torch.as_tensor(rng.integers(
                           -1, 2, (32, 50)), dtype=torch.int8),
                        t(50).abs()), {}),
    }


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for y in x for t in _flat(y)]


@pytest.mark.parametrize("name", sorted(kcost.FORMULAS))
def test_kernel_entry_charges_its_formula_on_cpu_and_meta(name):
    fn, args, kw = _entry_cases()[name]
    flops, n_bytes = kcost.FORMULAS[name](*args, **kw)
    records, outs = [], []
    for a in (args, tuple(_to_meta(x) for x in args)):
        c = CostCounter()
        with c:
            outs.append(fn(*a, **kw))
        records.append(c.record())
        assert c.flops == flops and c.bytes_accessed == n_bytes
        assert c.kernels == {name: {"calls": 1, "flops": flops,
                                    "bytes": n_bytes}}
        assert c.collectives == {}
    assert records[0] == records[1]
    cpu, meta = _flat(outs[0]), _flat(outs[1])
    assert [(tuple(x.shape), x.dtype) for x in cpu] == [
        (tuple(x.shape), x.dtype) for x in meta]
    assert all(x.device.type == "meta" for x in meta)
    assert sum(flops.values()) > 0 and n_bytes > 0


def test_int8_retrieve_charges_the_pool_kernel_and_counts_the_rerank():
    users, items, q_tau, q_mask, meta = _retrieval_inputs("int8")
    c = CostCounter()
    with c:
        ops.gam_retrieve(users, items, q_tau, q_mask, meta, 5,
                         rerank_factor=4)
    assert set(c.kernels) == {"gam_retrieve_pool"}
    want = kcost.FORMULAS["gam_retrieve_pool"](users, q_tau, q_mask, meta,
                                               20)[1]
    assert c.bytes_accessed > want          # the re-rank is torch code


# ------------------------------------------------------ whole steps


def _steps(cfg, device):
    """(train record, decode record) of ``cfg`` on ``device``."""
    model = Model(cfg, device=device)
    params = model.init(0)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 17))
    tok = (torch.empty((2, 17), dtype=torch.int32, device="meta")
           if device == "meta" else torch.as_tensor(tokens, dtype=torch.int32))
    train = Lowered(make_train_step(model), (params, adamw_init(params),
                                             {"tokens": tok})).count()
    decode = Lowered(make_serve_step(model),
                     (params, model.init_cache(2, 24), tok[:, :1])).count()
    return train.record(), decode.record()


def test_meta_counts_equal_cpu_counts():
    cfg = get_reduced_config("tinyllama-1.1b").with_(vocab=256,
                                                     use_decode_kernel=True)
    on_meta, on_cpu = _steps(cfg, "meta"), _steps(cfg, "cpu")
    for m, c in zip(on_meta, on_cpu):
        assert m["flops"] == c["flops"] and m["flops"]
        assert m["bytes_accessed"] == c["bytes_accessed"] > 0
        assert m["kernels"] == c["kernels"]
        assert m["memory"]["argument"] == c["memory"]["argument"]
    assert on_cpu[1]["kernels"]["decode_attention"]["calls"] == cfg.n_layers
    params = Model(cfg, device="cpu").init(0)
    leaves = tree_leaves(params)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    # params + two f32 moments + the step + the tokens
    f32 = sum(t.numel() * 4 for t in leaves)
    assert on_cpu[0]["memory"]["argument"] == (param_bytes + 2 * f32 + 4
                                               + 2 * 17 * 4)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b"])
def test_moe_steps_run_on_meta(arch):
    cfg = get_reduced_config(arch).with_(vocab=256)
    model = Model(cfg, device="meta")
    params = model.init(0)
    tok = torch.empty((2, 17), dtype=torch.int32, device="meta")
    _, _, met = make_train_step(model)(params, adamw_init(params),
                                       {"tokens": tok})
    assert met["loss"].device.type == "meta"
    logits, cache = model.prefill(params, {"tokens": tok[:, :8]}, 24)
    nxt, _ = make_serve_step(model)(params, cache, tok[:, :1])
    assert nxt.shape == (2, 1) and logits.device.type == "meta"


TINY = {kind: ShapeConfig(f"{kind}_tiny", seq_len=64, global_batch=4,
                          kind=kind)
        for kind in ("train", "prefill", "decode")}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b",
                                  "mamba2-780m", "whisper-tiny",
                                  "internvl2-26b", "recurrentgemma-9b",
                                  "deepseek-v2-236b"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_build_lowered_counts_on_a_fake_mesh(arch, kind):
    cfg = get_reduced_config(arch).with_(vocab=512, q_chunk=32)
    with fake_mesh((2, 4), ("data", "model")) as mesh:
        rec = dryrun.describe(build_lowered(cfg, TINY[kind], mesh).count())
    assert rec["flops_per_device"] > 0
    assert rec["hbm_bytes_per_device"] > 0
    mem = rec["bytes_per_device"]
    assert mem["peak"] >= mem["argument"] > 0
    assert sum(rec["collectives_per_device"].values()) > 0


# ------------------------------------ argument bytes against the reference


def _jbytes(tree, shardings) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    shards = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda s: isinstance(s, JNamedSharding))
    assert len(leaves) == len(shards)
    return sum(int(np.prod(s.shard_shape(x.shape))) * x.dtype.itemsize
               for x, s in zip(leaves, shards))


def _reference_argument_bytes(arch: str, shape_name: str) -> int:
    """Per-device bytes of the reference's ``in_shardings`` (params, the
    AdamW state and batch, or the cache and tokens) on the 16 x 16
    ``AbstractMesh``."""
    shape = JSHAPES[shape_name]
    am = AbstractMesh((16, 16), ("data", "model"))
    cfg = jsteps.shape_adapted_config(jget_config(arch), shape)
    model = JModel(cfg)
    params = jsteps.abstract_params(model)
    n = _jbytes(params, J.param_shardings(am, params, fsdp=cfg.fsdp,
                                          overrides=cfg.spec_overrides))
    if shape.kind == "train":
        opt = jsteps.abstract_opt_state(params)
        n += _jbytes(opt.mu, J.param_shardings(am, opt.mu, fsdp=True))
        n += _jbytes(opt.nu, J.param_shardings(am, opt.nu, fsdp=True))
        n += int(np.dtype(opt.step.dtype).itemsize)
        batch = jsteps.input_specs(cfg, shape)
        return n + _jbytes(batch, J.batch_specs(cfg, am, batch))
    cache = jsteps.abstract_cache(model, shape.global_batch, shape.seq_len)
    n += _jbytes(cache, J.cache_specs(cfg, am, cache,
                                      seq_shard=shape.global_batch == 1))
    tok = jax.ShapeDtypeStruct((shape.global_batch, 1), "int32")
    return n + _jbytes(tok, J.batch_specs(cfg, am, tok))


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_equal_reference_shard_shapes(arch, shape_name):
    with abstract_production_mesh() as mesh:
        lowered = build_lowered(get_config(arch), SHAPES[shape_name], mesh)
        got = CostCounter().arguments(*lowered.args)
    assert got == _reference_argument_bytes(arch, shape_name)


def test_run_one_record_keys():
    rec = dryrun.run_one("whisper-tiny", "long_500k", verbose=False)
    assert rec["status"] == "skip" and rec["mesh"] == "16x16"
    cfg = get_reduced_config("tinyllama-1.1b").with_(vocab=512)
    rec = dryrun.run_one("tinyllama-1.1b", "decode_32k", cfg_override=cfg,
                         multi_pod=True, verbose=False)
    assert rec["status"] == "ok" and rec["chips"] == 512
    assert {"bytes_per_device", "flops_per_device", "hbm_bytes_per_device",
            "collectives_per_device", "lower_s"} <= set(rec)
    assert "compile_s" not in rec and rec["mesh_device_type"] == "cpu"
    assert set(rec["bytes_per_device"]) == {"argument", "output", "temp",
                                            "peak"}
