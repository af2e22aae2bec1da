"""The port's sharding (``sharding/specs.py``, ``launch/mesh.py``,
``data/pipeline.shard_batch``, the model on DTensors) against the JAX
reference and the single-device port.

* Spec parity: for every arch of ``ARCH_IDS`` at its published widths, on
  meta tensors, ``param_specs``, ``fsdp_specs`` and ``param_shardings`` on
  the production meshes (16, 16) and (2, 16, 16), ``cache_specs`` (seq
  sharding both ways, batch 128 and 1), ``batch_specs`` over every
  shape's ``input_specs`` and ``index_shardings`` equal the reference's on
  ``jax.sharding.AbstractMesh``, leaf for leaf (the reference's specs are
  pure functions of shapes, so no device is needed).
* Each rank's block: ``local_block`` at every coordinate, and the blocks
  four real ranks hold, equal the slices of the reference's
  ``devices_indices_map`` (8 host devices, in a subprocess), a
  ("pod", "data") dim included.
* Four gloo ranks on a (2, 2) ("data", "model") mesh
  (``tests/multihost/run_mesh_torch.py --suite sharding``, spawned once for
  the file): ``shard_batch``, train steps of tinyllama, olmoe, mamba2 and
  recurrentgemma (reduced, f32, vocab 512) against the single-device port
  (metrics within 1e-5 relative, moments within 2e-5 of the leaf's largest,
  params within 1e-5 except eps-dominated AdamW updates, as
  ``test_torch_training.py`` holds the port to the reference), serve steps
  of tinyllama and mamba2 and a seq-sharded batch-1 sliding-window decode
  (tokens equal, cache leaves within 1e-5), each rank's resident bytes the
  specs' share, a DTensor checkpoint (the whole tree's file byte for byte,
  restored with the donor's placements), and the host-staged collectives
  (a train step through them equal to one device).

The reference's own mesh steps (``tests/test_sharding.py``) fail under this
jax version on the embedding gather (ROADMAP queue 3), so the port's steps
are held to the port's single-device steps, which are held to the
reference in ``test_torch_training.py`` / ``test_torch_families.py``.
"""
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs.registry import ARCH_IDS  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.configs.registry import get_reduced_config as jget_reduced  # noqa: E402,E501
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.sharding import specs as J  # noqa: E402
from repro_torch.checkpoint.checkpoint import tree_flatten_with_path  # noqa: E402,E501
from repro_torch.configs import get_config, get_reduced_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.launch.steps import (abstract_cache,  # noqa: E402
                                      abstract_params, input_specs,
                                      shape_adapted_config)
from repro_torch.models import Model  # noqa: E402
from repro_torch.sharding import specs as T  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
RUNNER = ROOT / "tests" / "multihost" / "run_mesh_torch.py"
_spec = importlib.util.spec_from_file_location("run_mesh_torch", RUNNER)
runner = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(runner)

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
CACHE_CAPACITY = 4096


# ------------------------------------------------------------- parity


def _jflat(tree, leaf=lambda x: isinstance(x, P)):
    return {jax.tree_util.keystr(k): v for k, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaf)[0]}


def _tflat(tree):
    return dict(tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (tuple, T.NamedSharding))))


def _same_specs(want: dict, got: dict):
    assert want.keys() == got.keys()
    for k in want:
        w = want[k]
        w = tuple(w.spec if hasattr(w, "spec") else w)
        g = got[k]
        g = tuple(g.spec if hasattr(g, "spec") else g)
        assert g == w, (k, g, w)


def _models(arch):
    jm = JModel(jget_config(arch))
    tm = Model(get_config(arch), device="meta")
    return jm, tm


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_reference_at_published_widths(arch):
    jm, tm = _models(arch)
    jp, tp = jsteps.abstract_params(jm), abstract_params(tm)
    _same_specs(_jflat(J.param_specs(jp)), _tflat(T.param_specs(tp)))
    over = ((r"\['embed'\]$", "replicate"),)
    _same_specs(_jflat(J.param_specs(jp, over)),
                _tflat(T.param_specs(tp, over)))
    for shape, names in MESHES:
        am, tmesh = AbstractMesh(shape, names), MeshShape(shape, names)
        _same_specs(_jflat(J.fsdp_specs(jp, am)),
                    _tflat(T.fsdp_specs(tp, tmesh)))
        _same_specs(_jflat(J.param_shardings(am, jp), leaf=None),
                    _tflat(T.param_shardings(tmesh, tp)))
        _same_specs(_jflat(J.param_shardings(am, jp, fsdp=False), leaf=None),
                    _tflat(T.param_shardings(tmesh, tp, fsdp=False)))
        _same_specs(_jflat(J.fsdp_specs(jp, am, over)),
                    _tflat(T.fsdp_specs(tp, tmesh, over)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_equal_reference(arch):
    jm, tm = _models(arch)
    jcfg, tcfg = jm.cfg, tm.cfg
    for batch in (128, 1):
        jc = jax.eval_shape(lambda: jm.init_cache(batch=batch,
                                                  capacity=CACHE_CAPACITY))
        tc = abstract_cache(tm, batch, CACHE_CAPACITY)
        for shape, names in MESHES:
            am, tmesh = AbstractMesh(shape, names), MeshShape(shape, names)
            for seq in (False, True):
                _same_specs(_jflat(J.cache_specs(jcfg, am, jc,
                                                 seq_shard=seq), leaf=None),
                            _tflat(T.cache_specs(tcfg, tmesh, tc,
                                                 seq_shard=seq)))
    for name, shape in SHAPES.items():
        jb = jsteps.input_specs(jcfg, JSHAPES[name])
        tb = input_specs(tcfg, shape)
        for mshape, names in MESHES:
            am, tmesh = AbstractMesh(mshape, names), MeshShape(mshape, names)
            _same_specs(_jflat(J.batch_specs(jcfg, am, jb), leaf=None),
                        _tflat(T.batch_specs(tcfg, tmesh, tb)))


@pytest.mark.parametrize("ranks", [2, 4, 8])
def test_index_shardings_equal_reference(ranks):
    shapes = {"tables": (8, 64, 256), "counts": (8, 64), "spills": (8, 0),
              "factors": (8 * 1024, 10), "alive": (8 * 1024,),
              "odd": (6, 3)}
    jt = {k: jax.ShapeDtypeStruct(v, np.float32) for k, v in shapes.items()}
    tt = {k: torch.empty(v, device="meta") for k, v in shapes.items()}
    am, tmesh = AbstractMesh((ranks,), ("items",)), MeshShape((ranks,),
                                                             ("items",))
    _same_specs(_jflat(J.index_shardings(am, jt), leaf=None),
                _tflat(T.index_shardings(tmesh, tt)))


# ------------------------------------- the reference's own spec tests


def _flat_specs(specs):
    return {k: v for k, v in tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, tuple))}


def test_param_specs_shard_the_right_dims():
    params = abstract_params(Model(get_reduced_config("olmoe-1b-7b"),
                                   device="meta"))
    flat = _flat_specs(T.param_specs(params))
    assert flat["['embed']"] == ("model", None)
    moe_gate = [v for k, v in flat.items() if "moe" in k and "'gate'" in k][0]
    assert moe_gate[1] == "model"      # experts axis
    wq = [v for k, v in flat.items() if "'wq'" in k][0]
    assert wq[-1] == "model"


def test_fsdp_adds_data_axis():
    params = abstract_params(Model(get_reduced_config("tinyllama-1.1b"),
                                   device="meta"))
    specs = T.fsdp_specs(params, MeshShape((2, 4), ("data", "model")))
    wq = [v for k, v in _flat_specs(specs).items() if "'wq'" in k][0]
    assert "model" in wq
    assert "data" in wq, wq


def test_long_context_seq_sharding_lowers():
    """batch-1 decode shards the cache sequence dim on data."""
    cfg = shape_adapted_config(get_reduced_config("tinyllama-1.1b"),
                               SHAPES["long_500k"])
    assert cfg.attn_kind == "sliding"
    cache = abstract_cache(Model(cfg, device="meta"), 1, 1024)
    mesh = MeshShape((2, 4), ("data", "model"))
    flat = _tflat(T.cache_specs(cfg, mesh, cache, seq_shard=True))
    k_spec = [v for k, v in flat.items() if k.endswith("['k']")][0]
    assert k_spec.spec[2] == "data"
    assert [p.is_shard(2) for p in k_spec.placements] == [True, False]
    jcfg = jsteps.shape_adapted_config(jget_reduced("tinyllama-1.1b"),
                                       JSHAPES["long_500k"])
    assert (jcfg.attn_kind, jcfg.window) == (cfg.attn_kind, cfg.window)


def test_placements_follow_the_spec_major_axis_first():
    mesh = MeshShape((2, 4, 2), ("pod", "data", "model"))
    s = T.NamedSharding(mesh, (("pod", "data"), None, "model"))
    assert [(p.is_shard(), getattr(p, "dim", None)) for p in s.placements] \
        == [(True, 0), (True, 0), (True, 2)]
    with pytest.raises(ValueError, match="mesh order"):
        T.NamedSharding(mesh, (("data", "pod"),)).placements


# --------------------------------------------------------------- meshes


def test_meshes_raise_without_their_ranks_or_card():
    with pytest.raises(ValueError, match="16 x 16.*needs 256 ranks, the "
                       "process group has 1"):
        mesh_mod.make_production_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        mesh_mod.make_production_mesh(multi_pod=True, device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="card"):
            mesh_mod.make_index_mesh(1)
    with pytest.raises(ValueError, match="differ in length"):
        MeshShape((2, 2), ("data",))
    assert mesh_mod.data_axes(MeshShape((2, 2, 2), ("pod", "data", "model")
                                        )) == ("pod", "data")
    assert mesh_mod.model_axis(MeshShape((2,), ("model",))) == "model"
    assert set(mesh_mod.__all__) >= {"make_production_mesh", "make_index_mesh",
                                     "data_axes", "model_axis"}
    assert set(T.__all__) >= {"param_specs", "param_shardings", "batch_specs",
                              "cache_specs", "named", "index_shardings"}


# ---------------------------------------------------- each rank's block

# blocks checked in this process at every coordinate, beside the runner's
EXTRA_BLOCK_CASES = {
    "pod-data-model": ((4, 8, 6), (2, 2, 2), ("pod", "data", "model"),
                       (("pod", "data"), "model", None)),
    "data-model-inner": ((5, 8, 4), (2, 2, 2), ("pod", "data", "model"),
                         (None, ("data", "model"), "pod")),
}
ALL_BLOCK_CASES = dict(runner.BLOCK_CASES, **EXTRA_BLOCK_CASES)

_REFERENCE_SLICES = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
out = {}
for name, (shape, mshape, axes, spec) in json.loads(sys.argv[1]).items():
    devs = np.array(jax.devices()[:int(np.prod(mshape))]).reshape(mshape)
    sh = NamedSharding(Mesh(devs, tuple(axes)), P(*[
        tuple(e) if isinstance(e, list) else e for e in spec]))
    out[name] = {}
    for d, sl in sh.devices_indices_map(tuple(shape)).items():
        coord = [int(c) for c in np.argwhere(devs == d)[0]]
        out[name][json.dumps(coord)] = [
            [s.start or 0, shape[i] if s.stop is None else s.stop]
            for i, s in enumerate(sl)]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference_slices():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", _REFERENCE_SLICES,
         json.dumps(ALL_BLOCK_CASES)], capture_output=True, text=True,
        timeout=120, env=env, check=True)
    return json.loads(out.stdout)


def _arange(shape):
    return torch.arange(int(np.prod(shape)),
                        dtype=torch.float32).reshape(shape)


@pytest.mark.parametrize("case", sorted(ALL_BLOCK_CASES))
def test_local_block_is_the_reference_slice(case, reference_slices):
    shape, mshape, axes, spec = ALL_BLOCK_CASES[case]
    x = _arange(shape)
    s = T.NamedSharding(MeshShape(mshape, axes), spec)
    want = reference_slices[case]
    assert len(want) == int(np.prod(mshape))
    for coord, bounds in want.items():
        got = T.local_block(x, s.mesh, s.placements, json.loads(coord))
        ref = x[tuple(slice(a, b) for a, b in bounds)]
        assert torch.equal(got, ref), (case, coord)


# ----------------------------------------------------- four real ranks


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh") / "sharding.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(RUNNER), "--suite", "sharding", "--device",
         "cpu", "--processes", "4", "--out", str(out)],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("check", [n for n, _ in runner.SHARDING_CHECKS])
def test_on_four_ranks(check, mesh_run):
    res = mesh_run[check]
    assert res["ok"], res["detail"]


@pytest.mark.parametrize("case", sorted(runner.BLOCK_CASES))
def test_rank_blocks_are_the_reference_slices(case, mesh_run,
                                              reference_slices):
    shape = ALL_BLOCK_CASES[case][0]
    x = _arange(shape)
    for rank in mesh_run["local_blocks"]["data"]:
        got = rank[case]
        bounds = reference_slices[case][json.dumps(got["coords"])]
        ref = x[tuple(slice(a, b) for a, b in bounds)]
        assert torch.equal(torch.tensor(got["block"]), ref), (case, got)
