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
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def test_port_imports_without_jax_or_repro():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "import repro_torch, repro_torch.retriever\n"
            "import repro_torch.retriever.gam, repro_torch.retriever.brute\n"
            "import repro_torch.core, repro_torch.kernels.ops\n"
            "import repro_torch.compress\n"
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


def test_open_retriever_without_device_never_runs_on_cpu(monkeypatch):
    from repro_torch.core.mapping import GamConfig
    from repro_torch.retriever import RetrieverSpec, open_retriever
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    items = np.eye(16, dtype=np.float32)
    for backend in ("gam-device", "brute"):
        spec = RetrieverSpec(cfg=GamConfig(k=16), backend=backend)
        with pytest.raises(RuntimeError, match="CUDA"):
            open_retriever(spec, items)
        assert open_retriever(spec, items, device="cpu").n_items == 16
