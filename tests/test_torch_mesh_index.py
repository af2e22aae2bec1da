"""The ``mesh=`` of the port's ``sharded`` backend: one index placed over the
ranks of an ``items`` device mesh.

Four gloo ranks (``tests/multihost/run_mesh_torch.py --suite index``,
spawned once for the file) build a 900-item catalog as a 2-rank mesh twice
over and as one 4-rank mesh, and every answer (ids, scores, ``n_scored``,
discarded fractions) equals single-device ``sharded`` bit for bit through
build, exact and pruned queries, upserts and deletes, the dense oracle,
synchronous and background compaction (queried mid-flight), explain, both
quantize modes and a snapshot restored onto local devices; exact queries
equal ``brute``.  Each rank holds 1/ranks of the shards (tables, factor
rows); shards that do not split evenly, in count or in rows, replicate,
a heterogeneous partition warns and serves unplaced, ``sharded-multihost``
checks the mesh and places by host, and a mesh without an ``items`` axis
raises (the
reference's ``test_service.py::test_index_mesh_places_shards_on_devices``,
held to single-device results).  In this process: what a mesh must be, and
the gathers with no process group.
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

from repro_torch.core.mapping import GamConfig  # noqa: E402
from repro_torch.service.collective import (allgather_accumulators,  # noqa: E402,E501
                                            allgather_array)
from repro_torch.service.compaction import CompactionPlanner  # noqa: E402
from repro_torch.service.sharded_index import (ShardedGamIndex,  # noqa: E402
                                               index_mesh)

ROOT = pathlib.Path(__file__).resolve().parents[1]
RUNNER = ROOT / "tests" / "multihost" / "run_mesh_torch.py"
_spec = importlib.util.spec_from_file_location("run_mesh_torch", RUNNER)
runner = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(runner)
CFG = GamConfig(k=16, scheme="parse_tree", threshold=0.2)


@pytest.fixture(scope="module")
def index_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh") / "index.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, str(RUNNER), "--suite", "index", "--device", "cpu",
         "--processes", "4", "--out", str(out)],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("check", [n for n, _ in runner.INDEX_CHECKS])
def test_mesh_index_on_four_ranks(check, index_run):
    res = index_run[check]
    assert res["ok"], res["detail"]


@pytest.mark.parametrize("ranks,case", [(2, "none"), (2, "int8"),
                                        (4, "none"), (4, "int8")])
def test_each_rank_holds_its_share_of_the_index(ranks, case, index_run):
    for data in index_run[f"index[{ranks}-ranks-{case}]"]["data"]:
        # tables, counts, spills, factor and alive rows split evenly; the
        # kernel's bitsets split by blocks
        assert data["bytes"] * ranks <= data["bytes_single"] + 64 * ranks
        assert data["bytes"] * ranks >= data["bytes_single"] * 0.99


def test_a_mesh_must_be_an_items_device_mesh():
    assert index_mesh(None) is None
    for bad in ("mesh", object(), ("items",)):
        with pytest.raises(TypeError, match="DeviceMesh"):
            index_mesh(bad)
    items = runner._catalog(64, 16, 0)
    with pytest.raises(TypeError, match="make_index_mesh"):
        ShardedGamIndex.build(items, CFG, n_shards=2, mesh="mesh",
                              device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        CompactionPlanner(CFG, np.arange(64), items, n_shards=2,
                          mesh=object(), device="cpu")


def test_unplaced_index_gathers_nothing():
    items = runner._catalog(200, 16, 1)
    idx = ShardedGamIndex.build(items, CFG, n_shards=2, min_overlap=2,
                                device="cpu")
    assert not idx.placed
    assert (idx.shard_lo, idx.shard_hi) == (0, 2)
    assert (idx.row_lo, idx.row_hi) == (0, idx.partition.n_rows)
    whole = idx.whole_arrays()
    assert np.array_equal(whole["tables"], idx.tables.numpy())
    assert np.array_equal(whole["meta0_item_bits_t"],
                          idx.metas[0].item_bits_t.numpy())
    assert idx.whole_meta_rows(0) == idx.metas[0].n_rows


def test_gathers_without_a_process_group_are_the_identity():
    a = np.arange(12, dtype=np.int8).reshape(3, 4)
    got = allgather_array(a)
    assert got.shape == (1, 3, 4) and np.array_equal(got[0], a)
    s = np.zeros((2, 3), np.float32)
    r = np.ones((2, 3), np.int32)
    out = allgather_accumulators(s, r, r, np.zeros(2, np.float32))
    assert out[0] is s and out[1] is r
