"""No module under ``gpubench/`` imports JAX or the JAX package; only
``system.py`` and ``systems/*.py`` import the program, and only inside the
system they open; the reference imports nothing of it: top-level names
compared whole (``repro_torch`` is the program, not ``repro``)."""
import ast
import subprocess
import sys

import pytest

from gpubench.tests._common import ROOT, small

BENCH_DIR = ROOT / "gpubench"
FILES = sorted(p for p in BENCH_DIR.rglob("*.py") if "tests" not in p.parts)
JAX = {"jax", "jaxlib", "flax", "repro"}
#: the modules that may import the program
OPENERS = {BENCH_DIR / "system.py", *(BENCH_DIR / "systems").glob("*.py")}


def _imports(path, module_level: bool = False) -> set:
    """Top-level names ``path`` imports (``module_level``: in the module's
    own statements, outside every function and class)."""
    tree = ast.parse(path.read_text())
    out = set()
    for node in (tree.body if module_level else ast.walk(tree)):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(BENCH_DIR)))
def test_no_jax(path):
    assert not _imports(path) & JAX


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(BENCH_DIR)))
def test_only_the_systems_import_the_program(path):
    if path in OPENERS:
        assert "repro_torch" not in _imports(path, module_level=True)
    else:
        assert "repro_torch" not in _imports(path)


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob(
    "*.py")), ids=lambda p: p.name)
def test_reference_stands_alone(path):
    assert not _imports(path) & (JAX | {"repro_torch"})
    assert "repro_torch" not in path.read_text()


def test_a_run_loads_no_jax():
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from gpubench.bench import banned_modules, run\n"
        f"out = run('yahoo_r1-sharded.delta-1024', 5, 0.2, True, "
        f"device='cpu', overrides={small('yahoo_r1-sharded.delta-1024')!r})\n"
        "print(json.dumps([out['correct'], banned_modules()]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    correct, banned = __import__("json").loads(proc.stdout.splitlines()[-1])
    assert correct and banned == []
