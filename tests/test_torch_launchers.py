"""The port's serve launcher (``python -m repro_torch.launch.serve``) at tiny
scale on the CPU (``--device cpu``): the serve cases of
``tests/test_launchers.py`` — the LM mode, the flag surface, ``--service``
with the QoS and chaos flags, a serve loop that survives
``NoLiveReplica`` — plus the online-learning loop and ``--hosts 2`` with
two real gloo worker processes under a deadline."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import CFG, unit_factors  # noqa: E402

from repro_torch.core.mapping import GamConfig  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.retriever import RetrieverSpec, open_retriever  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TCFG = GamConfig(k=CFG.k, scheme=CFG.scheme, d=CFG.d, threshold=CFG.threshold)


def _main(monkeypatch, capsys, *argv) -> str:
    monkeypatch.setattr(sys, "argv", ["serve", *argv, "--device", "cpu"])
    serve.main()
    return capsys.readouterr().out


def test_serve_launcher_main(monkeypatch, capsys):
    out = _main(monkeypatch, capsys, "--arch", "olmo-1b", "--reduced",
                "--batch", "2", "--prompt-len", "8", "--new-tokens", "4",
                "--vocab", "128")
    assert "tokens" in out and "arch=olmo-1b" in out


def test_serve_launcher_gam(monkeypatch, capsys):
    out = _main(monkeypatch, capsys, "--arch", "tinyllama-1.1b", "--reduced",
                "--batch", "2", "--prompt-len", "8", "--new-tokens", "4",
                "--vocab", "128", "--gam")
    assert "vocab rows scored/step" in out


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-236b",
                                  "mamba2-780m", "recurrentgemma-9b",
                                  "whisper-tiny", "internvl2-26b"])
def test_serve_launcher_serves_every_family(monkeypatch, capsys, arch):
    """The LM mode at ``--reduced`` for each family beyond the dense one:
    the reference's launcher inputs (frames, image embeddings), greedy
    tokens of the right shape, and the decode kernel's launch count (0: on
    the CPU the plain version runs)."""
    out = _main(monkeypatch, capsys, "--arch", arch, "--reduced", "--batch",
                "2", "--prompt-len", "6", "--new-tokens", "3", "--vocab",
                "64")
    assert f"arch={arch}" in out and "2x3 tokens" in out
    assert "{'decode_attention': 0}" in out


def test_serve_help_pins_the_flag_surface(monkeypatch, capsys):
    """``--help`` is the serving CLI's public contract: every flag of the
    reference's surface, plus ``--device``."""
    monkeypatch.setattr(sys, "argv", ["serve", "--help"])
    with pytest.raises(SystemExit) as exc:
        serve.main()
    assert exc.value.code == 0
    out = capsys.readouterr().out
    for flag in ("--service", "--items", "--shards", "--requests",
                 "--cache N", "--cache-ttl-s S", "--load-profile SPEC",
                 "--hosts N", "--replication R", "--snapshot PATH",
                 "--metrics-out PATH", "--trace-out PATH", "--learn",
                 "--queue-cap N", "--deadline-ms MS", "--inject-faults",
                 "--verify", "--fail-host H", "--auto-compact N",
                 "--rebalance SKEW", "--drift D", "--push-min-cos COS",
                 "--hedge-factor F", "--fault-seed", "--device {cuda,cpu}"):
        assert flag in out, f"--help lost {flag!r}"
    assert "docs/load_testing.md" in out
    assert "zipf=1.1,curve=diurnal" in out
    for stale in ("GamService", "snapshot v3", "repro.retriever/v3",
                  "jax"):
        assert stale not in out, f"stale reference {stale!r} in --help"


def test_serve_loop_survives_no_live_replica():
    """The guarded query turns an unservable round into a typed, counted
    shed and keeps serving; marking the host back up answers again."""
    items = unit_factors(200, 16, 0)
    users = unit_factors(4, 16, 1)
    spec = RetrieverSpec(cfg=TCFG, backend="sharded-multihost", n_shards=2,
                         min_overlap=1, kappa=8, n_hosts=2, replication=1)
    svc = open_retriever(spec, items=items, device="cpu")
    want = serve._guarded_query(svc, users)
    assert want is not None

    svc.mark_down(0)                  # replication=1: slice 0 unservable
    assert serve._guarded_query(svc, users) is None
    assert serve._guarded_query(svc, users) is None
    snap = svc.metrics.snapshot()
    assert snap["shed_no_live_replica"] == 2 == snap["shed_total"]
    kinds = [e["kind"] for e in svc.events.tail(10)]
    assert "request_shed" in kinds

    svc.mark_up(0)                    # recovery is immediate and exact
    got = serve._guarded_query(svc, users)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.scores, want.scores)


def test_serve_launcher_service_qos_flags(monkeypatch, capsys, tmp_path):
    """The single-process service with QoS + chaos flags on finishes, and
    the QoS line reports typed sheds instead of crashing on injected delta
    errors; the snapshot probe and the metrics export run too."""
    prom = os.fspath(tmp_path / "m.prom")
    out = _main(monkeypatch, capsys, "--service", "--items", "300",
                "--shards", "2", "--requests", "24", "--service-batch", "4",
                "--queue-cap", "16", "--deadline-ms", "200",
                "--inject-faults", "delta_error=1.0", "--snapshot",
                os.fspath(tmp_path / "s.npz"), "--metrics-out", prom)
    assert "qos:" in out and "upsert faults=1" in out
    assert "probe queries bit-identical" in out
    assert "\nrepro_n_requests " in open(prom).read()


def test_serve_launcher_learns_online(monkeypatch, capsys):
    out = _main(monkeypatch, capsys, "--service", "--learn", "--items",
                "256", "--shards", "2", "--requests", "32", "--dim", "8")
    assert "learn:" in out and "push:" in out and "recall@10" in out


def test_serve_launcher_hosts_2_on_cpu(tmp_path, monkeypatch):
    """``--hosts 2`` spawns two gloo workers: the host stream fails host 1
    over halfway, every verified round is bit-identical, and the snapshot
    from host 0 restores on both.  A hang is killed at the deadline."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("PYTHONPATH", str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--service",
         "--hosts", "2", "--replication", "2", "--fail-host", "1",
         "--items", "600", "--shards", "4", "--requests", "32",
         "--device", "cpu", "--verify", "--inject-faults",
         "stall=0.3,hosts=1", "--snapshot", os.fspath(tmp_path / "mh.npz")],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert "0 WRONG" in out.stdout
    assert "failovers=" in out.stdout and "down=[1]" in out.stdout
    assert "probe bit-identical" in out.stdout
