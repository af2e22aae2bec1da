"""The port stands alone: it imports neither JAX nor the JAX package, and it
never runs on the CPU unless asked to."""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + sorted(
    (ROOT / "examples").glob("*_torch.py")) + [
    ROOT / "chip_smoke.py",
    ROOT / "tests" / "multihost" / "run_mesh_torch.py",
    ROOT / "tests" / "multihost" / "run_multiprocess_torch.py"]
REFERENCE_PACKAGES = sorted(
    p.parent.name for p in (ROOT / "src" / "repro").glob("*/__init__.py"))
# names of the reference's package namespaces that only the reference has,
# each with the ROADMAP queue 1 item that brings it
REFERENCE_ONLY: dict = {}


def test_port_imports_without_jax_or_repro():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch, repro_torch.retriever\n"
            "import repro_torch.retriever.gam, repro_torch.retriever.brute\n"
            "import repro_torch.retriever.baselines\n"
            "import repro_torch.core, repro_torch.kernels.ops\n"
            "import repro_torch.core.baselines, repro_torch.kernels.ref\n"
            "import repro_torch.compress, repro_torch.compress.patterns\n"
            "import repro_torch.retriever.sharded, repro_torch.service\n"
            "import repro_torch.obs, repro_torch.online, repro_torch.data\n"
            "import repro_torch.factorization.convert, repro_torch.training\n"
            "import repro_torch.sharding.specs, repro_torch.launch.mesh\n"
            "import repro_torch.configs.gam_mf\n"
            "import repro_torch.models.moe, repro_torch.models.ssm\n"
            "import repro_torch.models.rglru, repro_torch.models.model\n"
            "import repro_torch.retriever.multihost, repro_torch.launch\n"
            "import repro_torch.launch.procs, repro_torch.launch.serve\n"
            "import repro_torch.launch.steps, repro_torch.launch.train\n"
            "import repro_torch.training.evaluate, repro_torch.checkpoint\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.roofline\n"
            "import repro_torch.launch.perf, repro_torch.launch.cost\n"
            "import repro_torch.kernels.cost\n"
            "import importlib.util as u, pathlib\n"
            f"p = pathlib.Path({str(PORT_FILES[-1])!r})\n"
            "spec = u.spec_from_file_location('runner', p)\n"
            "spec.loader.exec_module(u.module_from_spec(spec))\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_every_module_of_the_port_imports_first():
    """Each module imports in an interpreter that has imported no other
    module of the port (no import cycle depends on the order)."""
    src = ROOT / "src"
    names = sorted(".".join(p.relative_to(src).with_suffix("").parts)
                   .removesuffix(".__init__")
                   for p in PORT_FILES if p.is_relative_to(src))
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for name in {names!r}:\n"
            "    for m in [m for m in sys.modules if m.startswith('repro_')]:\n"
            "        del sys.modules[m]\n"
            "    importlib.import_module(name)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": str(src), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.name)
def test_no_file_of_the_port_imports_jax_or_repro(path):
    assert path.exists(), path
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (
                f"{path.name}:{node.lineno} imports {name}")


def _reference_all(package: str) -> list:
    """``__all__`` of ``repro.<package>``, read from its source (no JAX)."""
    path = ROOT / "src" / "repro" / package / "__init__.py"
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return sorted(ast.literal_eval(node.value))
    return []


@pytest.mark.parametrize("package", REFERENCE_PACKAGES)
def test_package_namespaces_export_what_the_reference_exports(package):
    """Every shared package's ``__all__`` holds the reference's names, but
    for the named ones only the reference has; each exported name
    resolves."""
    import importlib
    mod = importlib.import_module(f"repro_torch.{package}")
    want = set(_reference_all(package)) - set(REFERENCE_ONLY.get(package, ()))
    got = set(mod.__all__)
    assert want <= got, sorted(want - got)
    assert not set(REFERENCE_ONLY.get(package, ())) & got
    for name in got:
        assert getattr(mod, name) is not None, name


def test_open_retriever_without_device_never_runs_on_cpu(monkeypatch):
    from repro_torch.core.mapping import GamConfig
    from repro_torch.retriever import RetrieverSpec, open_retriever
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    items = np.eye(16, dtype=np.float32)
    for backend in ("gam", "gam-device", "brute", "sharded",
                    "sharded-multihost", "srp-lsh", "superbit-lsh", "cro",
                    "pca-tree"):
        spec = RetrieverSpec(cfg=GamConfig(k=16), backend=backend)
        with pytest.raises(RuntimeError, match="CUDA"):
            open_retriever(spec, items)
        assert open_retriever(spec, items, device="cpu").n_items == 16


def test_service_entry_points_without_device_never_run_on_cpu(monkeypatch):
    """The service tier's public builders take the card when no device is
    named, as ``open_retriever`` does, and raise without one."""
    from repro_torch.core.mapping import GamConfig
    from repro_torch import service
    from repro_torch.service.sharded_index import build_group_meta
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GamConfig(k=16)
    items = np.eye(16, dtype=np.float32)
    part = service.Partition.uniform(16, 2)
    tau = np.zeros((16, cfg.k), np.int32)
    mask = np.zeros((16, cfg.k), bool)
    builders = [
        lambda **kw: service.ShardedGamIndex.build(items, cfg, n_shards=2,
                                                   **kw),
        lambda **kw: build_group_meta(tau, mask, cfg.p, part, 0,
                                      [[], []], **kw),
        lambda **kw: service.DeltaSegment(cfg, **kw),
        lambda **kw: service.CompactionPlanner(cfg, np.arange(16), items,
                                               **kw),
        lambda **kw: service.MapCache(cfg, **kw),
    ]
    for build in builders:
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
        build(device="cpu")
    index = service.ShardedGamIndex.build(items, cfg, n_shards=2,
                                          device="cpu")
    assert index.device.type == "cpu" and index.n_live == 16


def test_index_and_baseline_structures_without_device_never_run_on_cpu(
        monkeypatch):
    """The CSR indexes and the baseline structures take the card when no
    device is named, and raise without one."""
    from repro_torch.core import baselines
    from repro_torch.core.inverted_index import (CompressedInvertedIndex,
                                                 InvertedIndex)
    from repro_torch.retriever.baselines import baseline_from_reference
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    items = np.eye(16, dtype=np.float32)
    tau = np.tile(np.arange(4, dtype=np.int32), (16, 1)) + np.arange(
        16, dtype=np.int32)[:, None] % 3
    builders = [
        lambda **kw: InvertedIndex(tau, 32, **kw),
        lambda **kw: baselines.SrpLsh(items, n_bits=4, **kw),
        lambda **kw: baselines.SuperBitLsh(items, n_bits=4, **kw),
        lambda **kw: baselines.CroHash(items, n_proj=8, **kw),
        lambda **kw: baselines.PcaTree(items, depth=2, **kw),
    ]
    for build in builders:
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
        build(device="cpu")
    flat = InvertedIndex(tau, 32, device="cpu")
    comp = flat.compress()
    with pytest.raises(RuntimeError, match="CUDA"):
        CompressedInvertedIndex(comp.slot_patterns, comp.pattern_items,
                                n_items=16, p=32, k=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        InvertedIndex.from_csr(flat.postings, flat.offsets, n_items=16, p=32,
                               k=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        baseline_from_reference(object())


def test_serve_launcher_without_device_never_runs_on_cpu(monkeypatch):
    """``python -m repro_torch.launch.serve`` takes the card unless given
    ``--device cpu``: with none present it raises before building anything,
    in every mode."""
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["--service", "--items", "50"],
                 ["--service", "--hosts", "2", "--replication", "2"],
                 ["--reduced", "--vocab", "64"]):
        monkeypatch.setattr(sys, "argv", ["serve", *argv])
        with pytest.raises(RuntimeError, match="CUDA"):
            serve.main()
