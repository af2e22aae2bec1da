"""The port's examples (``examples/*_torch.py``): the four that finish on
the CPU in seconds run there with ``--device cpu`` and must pass their own
assertions (``movielens_repro_torch``, the paper's §6.2 chain, in about
20 s); ``train_lm_torch.py`` (a 100M-parameter model for 250 steps)
runs on the card (``chip_smoke.py`` phase 11d) and is import-checked here.
Without ``--device`` every example takes the card, and raises without
one.  A CPU run gets one OpenMP thread: beside the other test processes a
full thread pool spins on shared cores (``train_mf``'s epochs then take
minutes, not a second)."""
import importlib.util
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ["quickstart_torch", "serve_stream_torch", "serve_gam_torch",
            "movielens_repro_torch", "train_lm_torch"]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", EXAMPLES[:4])
def test_example_runs_on_the_cpu(name):
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"{name}.py"), "--device",
         "cpu"], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines()[-1 if name != "serve_gam_torch" else -2] \
        == "OK"


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_without_device_never_runs_on_cpu(name, monkeypatch):
    mod = _load(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [name])
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main()
