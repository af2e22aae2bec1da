"""A configuration names the kind of system it runs, and the harness finds
the kind's module (``systems/<kind>.py``) by that name.

A test-only kind (``tests/echo/``: a plain torch stand-in, no part of the
program) is added to a copy of the benchmark as a later change would add
one, by new files and entries in ``BENCHMARK.json``: the copy runs it end
to end and judges it with no other file edited, and refuses an unknown
kind and a limits file that lacks one of the kind's numbers.  The
retrieval kind reads, for a fixed seed, what the harness of commit
e80bb8f (before kinds) read.
"""
import hashlib
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest

from gpubench.tests._common import HERE, ROOT, small
from gpubench import bench

ECHO = "echo-tiny.echo-rows"
GHOST = "ghost-tiny.echo-rows"

#: run in the copy, with the copy alone on the path: the echo cell traced
#: and not, its control, an unknown kind, and a limits file that lacks a
#: number (``_window`` is replaced, to see that no window opens)
SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from gpubench import bench
out = {}
for traced in (False, True):
    out[f"run{int(traced)}"] = bench.run(%(echo)r, 2**31 + 5, 0.05, traced,
                                        device="cpu")
run, system, prepared, limits = bench.set_up(%(echo)r, 7, device="cpu")
system.close()
ctl, need = run.system_kind.control(run, prepared)
crun = bench.Run(run.name, run.config, run.traffic, run.data,
                 run.system_kind, run.device)
bench._window(crun, ctl, 0.0, False, 7, min_requests=need)
out["control"] = bench.judge_run(crun, prepared, 7)
out["loaded"] = sorted({m.split(".")[0] for m in sys.modules})
try:
    bench.run(%(ghost)r, 1, 0.05, False, device="cpu")
except FileNotFoundError as e:
    out["ghost"] = str(e)
path = bench.HERE / "limits" / (%(echo)r + ".json")
path.write_text(json.dumps({"other": 1.0}))
windows = []
bench._window = lambda *a, **k: windows.append(1)
try:
    bench.run(%(echo)r, 1, 0.05, False, device="cpu")
except ValueError as e:
    out["limits"] = [str(e), len(windows)]
print(json.dumps(out))
""" % {"echo": ECHO, "ghost": GHOST}


def _digest(path):
    return hashlib.sha256(path.read_bytes()).hexdigest()


def _files(root):
    return {p.relative_to(root): _digest(p) for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    """A checkout's copy with the echo kind added -> (root, the script's
    readings)."""
    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(ROOT / "gpubench", root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(HERE / "echo", root / "gpubench", dirs_exist_ok=True)
    conf = json.loads((HERE / "echo" / "configs" / "echo-tiny.json")
                      .read_text())
    (root / "gpubench" / "configs" / "ghost-tiny.json").write_text(
        json.dumps(dict(conf, name="ghost-tiny", system="ghost")))
    (root / "gpubench" / "limits" / f"{GHOST}.json").write_text(
        json.dumps({"max_err": 1e-6}))
    entry = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name in ("echo-tiny", "ghost-tiny"):
        entry["configs"].append({
            "name": name, "source": conf["source"], "reduced": [],
            "file": f"gpubench/configs/{name}.json", "why": "a test"})
        entry["workloads"].append({
            "name": f"{name}.echo-rows", "config": name,
            "traffic": "echo-rows", "chips": 1, "why": "a test"})
    for m in entry["end_to_end"]:
        if m["name"] == "queries_per_s":
            m["workloads"].append(ECHO)
    (root / "BENCHMARK.json").write_text(json.dumps(entry))
    before = _files(root / "gpubench")
    proc = subprocess.run([sys.executable, "-c", SCRIPT, str(root)],
                          capture_output=True, text=True, timeout=300,
                          cwd=root)
    assert proc.returncode == 0, proc.stderr[-4000:]
    after = _files(root / "gpubench")
    limits = f"limits/{ECHO}.json"
    assert {p: d for p, d in after.items() if str(p) != limits} == \
        {p: d for p, d in before.items() if str(p) != limits}
    return root, json.loads(proc.stdout.splitlines()[-1])


def test_a_new_kind_runs_by_files_alone(copy):
    root, out = copy
    # the copy's files that were already there are the repo's, unedited
    ours = _files(ROOT / "gpubench")
    theirs = _files(root / "gpubench")
    assert {p: theirs[p] for p in ours} == ours
    for traced in (0, 1):
        run = out[f"run{traced}"]
        assert run["correct"] and run["failed"] == 0, run
        assert run["attempted"] >= 1
        assert run["checks"] == {"max_err": {"value": 0.0, "limit": 1e-6}}
    untraced = out["run0"]["metrics"]
    # the kind-neutral end-to-end readers read the new kind's run
    assert set(untraced) == {"queries_per_s", "setup_s"}
    assert untraced["queries_per_s"]["value"] > 0
    assert out["run1"]["metrics"] == {}          # no per-layer metric named
    # the stand-in touched no part of the program, nor JAX
    assert not {"repro_torch", "repro", "jax"} & set(out["loaded"])


def test_a_new_kind_brings_its_control(copy):
    _, out = copy
    assert out["control"]["max_err"] > 1e-6


def test_an_unknown_kind_names_the_file_it_looked_for(copy):
    root, out = copy
    assert str(root / "gpubench" / "systems" / "ghost.py") in out["ghost"]
    assert "'ghost'" in out["ghost"]


def test_limits_that_lack_a_number_are_refused_before_the_window(copy):
    _, out = copy
    message, windows = out["limits"]
    assert "max_err" in message and windows == 0


@pytest.mark.parametrize("kind", ["../system", "a/b", "", 3])
def test_a_kind_is_a_name_not_a_path(kind):
    with pytest.raises(FileNotFoundError, match="no module"):
        bench.system_kind({"system": kind})


def test_no_system_key_is_the_retrieval_kind():
    kind = bench.system_kind({})
    assert kind.__file__ == bench.system_kind({"system": "retrieval"}).__file__
    assert kind.__file__ == str(bench.HERE / "systems" / "retrieval.py")
    assert kind.NUMBERS == ("n_scored_gap", "rank_gap", "score_err")


#: the harness of commit e80bb8f (before kinds) at ``small(cell)`` on the
#: CPU, seed 3200000001: ``run()``'s ``checks`` with 0 s of window (one
#: request), and over 8 requests the comparison's numbers, the sample's
#: users summed, its served ids and candidates summed, and each request's
#: candidates
SEED = 3200000001
PARENT = {
    "yahoo_r1-gam_device.batch4096": (
        {"n_scored_gap": 0.0, "rank_gap": 2.220446049250313e-16,
         "score_err": 1.2155252215872991e-07},
        {"n_scored_gap": 0.0, "rank_gap": 2.220446049250313e-16,
         "score_err": 1.4746403587118095e-07},
        -14.84736444709415, 3770756, 363880,
        [89907, 90792, 90866, 88374, 88097, 87318, 96220, 94301]),
    "yahoo_r1-sharded.delta-1024": (
        {"n_scored_gap": 0.0, "rank_gap": 2.220446049250313e-16,
         "score_err": 1.3129346210227766e-07},
        {"n_scored_gap": 0.0, "rank_gap": 2.220446049250313e-16,
         "score_err": 1.4746403587118095e-07},
        -14.84736444709415, 3938367, 370391,
        [91555, 92362, 92263, 89683, 89707, 88658, 97944, 96147]),
    "yahoo_r1-gam_device.batch1024": (
        {"n_scored_gap": 0.0, "rank_gap": 2.220446049250313e-16,
         "score_err": 1.2155252215872991e-07},
        {"n_scored_gap": 0.0, "rank_gap": 2.220446049250313e-16,
         "score_err": 1.4746403587118095e-07},
        -14.84736444709415, 3770756, 363880,
        [89907, 90792, 90866, 88374, 88097, 87318, 96220, 94301]),
}


#: the cells whose parent readings were recorded: a cell added later has
#: no parent to read as
@pytest.mark.parametrize("cell", sorted(PARENT))
def test_the_retrieval_kind_reads_as_the_parent(cell):
    checks, numbers, users_sum, ids_sum, n_sum, n_scored = PARENT[cell]
    out = bench.run(cell, SEED, 0.0, False, device="cpu",
                    overrides=small(cell))
    assert out["correct"] and out["attempted"] == 1 and out["failed"] == 0
    assert {n: c["value"] for n, c in out["checks"].items()} == checks

    run, system, prepared, _ = bench.set_up(cell, SEED, device="cpu",
                                            overrides=small(cell))
    bench._window(run, system, 0.0, False, SEED, min_requests=8)
    system.close()
    users, served = run.system_kind.sample(run, SEED)
    assert float(users.astype(np.float64).sum()) == users_sum
    assert int(served.ids.sum()) == ids_sum
    assert int(served.n_scored.sum()) == n_sum
    assert run.n_scored == n_scored
    assert bench.judge_run(run, prepared, SEED) == numbers
